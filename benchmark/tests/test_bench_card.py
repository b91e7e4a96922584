"""On the card, at each cell's own size: the control (the reference in the
program's place, in float32 with TF32 products) comes out not correct on
three seeds, and the program comes out correct on the same seeds.

    python -m pytest benchmark/tests -q -m card
"""
import json

import pytest
from conftest import BENCH, ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (2750000011, 2750000029, 2750000047)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_check_and_the_program_passes(cell, card):
    import control
    import harness

    limits = json.loads((BENCH / "limits" / f"{cell}.json").read_text())
    for rec in control.readings(cell, SEEDS, len(SEEDS), card, bench=harness.Bench(ROOT)):
        assert harness.judge(rec["program"], limits)[1], rec["program"]
        shared = {k: v for k, v in limits.items() if k in rec["control"]}
        assert shared and not harness.judge(rec["control"], shared)[1], rec["control"]
