"""A copy of the benchmark at a size the CPU runs in seconds: 3 trials of 60
bins, 8 neurons, 2 latents, windows of 20, 4 EM iterations, chunks of 4."""
import json
import shutil

from conftest import BENCH, ROOT


def tiny_bench(tmp_path, limits=None, dtype="float32"):
    """A benchmark root under ``tmp_path`` (BENCHMARK.json and benchmark/)
    with the configurations cut down; ``limits`` {cell: {number: limit}}
    replaces the limit files."""
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("flagship", "whole_trial"):
        path = tmp_path / "benchmark" / "configs" / f"{name}.json"
        c = json.loads(path.read_text())
        c["data"].update(trials=3, bins=60, neurons=8, latents=2)
        c["fit"].update(n_factors=2, rank=20)
        c["settings"].update(max_iter=4, dtype=dtype)
        if c["settings"]["window"]:
            c["settings"]["window"] = 20
        path.write_text(json.dumps(c))
    lono = tmp_path / "benchmark" / "traffic" / "lono_loop.json"
    lono.write_text(json.dumps(dict(json.loads(lono.read_text()), batch=4)))
    for cell, lim in (limits or {}).items():
        (tmp_path / "benchmark" / "limits" / f"{cell}.json").write_text(json.dumps(lim))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    import harness

    return harness.Bench(tmp_path)


def run_cell(bench, cell, seed=2147483999, trace=0):
    """One run of ``cell`` on the CPU (no look for a card): (line, checked)."""
    import time

    import torch

    import harness

    program = harness.import_program(ROOT)
    args = harness.parse(["--workload", cell, "--seed", str(seed), "--seconds", "0",
                          "--trace", str(trace)])
    return harness.execute(args, bench, program, torch.device("cpu"), time.perf_counter())
