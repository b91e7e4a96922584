"""Whole runs of the harness on the CPU at a tiny size (the look for a card
skipped): the import check, and the faults that a cell's check must catch."""
import json
import subprocess
import sys

import faults
import pytest
from _tiny import run_cell, tiny_bench
from conftest import BENCH, ROOT

CELLS = ("flagship.fit", "flagship.lono", "whole_trial.fit")
SEED = 2147483999


@pytest.mark.parametrize("cell", CELLS)
def test_a_cells_setup_loads_neither_jax_nor_the_jax_package(cell, tmp_path):
    """Each cell's set-up at a tiny CPU size in a fresh process; a module
    counts by its top-level name, taken whole (vlgp_tpu_torch is not
    vlgp_tpu)."""
    code = f"""
import sys, time, pathlib, torch
sys.path[:0] = [{str(BENCH / 'tests')!r}, {str(BENCH)!r}, {str(ROOT)!r}]
from _tiny import tiny_bench
import harness, drive
bench = tiny_bench(pathlib.Path({str(tmp_path)!r}))
args = harness.parse(["--workload", {cell!r}, "--seed", "5", "--seconds", "0", "--trace", "0"])
run = harness.Run(args, bench, harness.import_program(harness.ROOT), torch.device("cpu"), 0.0)
drive.make_loop(run).setup()
assert "vlgp_tpu_torch" in sys.modules
bad = harness.forbidden_modules()
print(bad)
sys.exit(1 if bad else 0)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]


def test_forbidden_names_are_compared_whole(monkeypatch):
    import harness

    monkeypatch.setitem(sys.modules, "vlgp_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert "vlgp_tpu_torch_extra" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "vlgp_tpu.ops", sys)
    assert harness.forbidden_modules() == ["vlgp_tpu.ops"]


def compared(cell):
    return json.loads((BENCH / "limits" / f"{cell}.json").read_text())


def sound_limits(tmp_path, cell):
    """Limits twenty times a sound tiny run's readings of the numbers the
    cell compares (a tiny problem reads other gaps than the cell's size).
    The tiny runs are in float64, where the program's inverses are exact:
    at a tiny size its float32 approximations read as large as some faults
    (an H-step left out moves a 3-trial statistic little)."""
    _, checked = run_cell(tiny_bench(tmp_path / "sound", dtype="float64"), cell, SEED)
    return {k: max(20 * checked[k][0], 1e-9) for k in compared(cell)}


# each fault a cell can have (faults.py), planted in the eager driver
FAULTS = [(cell, f) for cell in CELLS for f in faults.BY_KIND["lono" if "lono" in cell else "fit"]]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_timed_path_comes_out_not_correct(cell, fault, tmp_path, monkeypatch):
    limits = sound_limits(tmp_path, cell)
    bench = tiny_bench(tmp_path / "run", limits={cell: limits}, dtype="float64")
    line, checked = run_cell(bench, cell, SEED)
    assert line["correct"] is True, checked
    fault(monkeypatch.setattr)
    line, checked = run_cell(bench, cell, SEED)
    assert line["correct"] is False, checked


def test_a_traced_run_reads_its_per_layer_metrics(tmp_path):
    line, _ = run_cell(tiny_bench(tmp_path), "flagship.fit", SEED, trace=1)
    got = line["metrics"]
    for name in ("outside_em_s", "em_iter_ms", "estep_sweeps", "em_mfu"):
        assert name in got
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert len(line["breakdown"]["device_ops"]) <= 10
