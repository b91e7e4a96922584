"""One run of one cell of the benchmark: set-up, the measured window, the
check of what the window produced, the metrics and the result line.

Everything that belongs to one configuration, traffic mix, metric or
least-work count lives in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

  configs/<config>.json   the configuration (data, fit arguments, settings)
  traffic/<mix>.json      the traffic mix's parameters; its ``kind`` names
  kinds/<kind>.py         the loop that runs it (``drive.py``)
  metrics/<metric>.py     the reader of a metric: ``read(run)``, None when
                          the run has nothing to read for it; a metric
                          ``<name>.<cells>`` without a file of its own is
                          read by ``metrics/<name>.py``
  work/<function>.py      a function's least work from its shapes
  limits/<cell>.json      the limit of each number the check compares
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
PROGRAM = "vlgp_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "vlgp_tpu")


def load_module(path: pathlib.Path):
    """The Python file at ``path`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(f"_bench_{path.stem.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, taken whole, is JAX's or the JAX
    package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def cache_dirs(root: pathlib.Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = root / "benchmark_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


class Bench:
    """BENCHMARK.json and the files it names."""

    def __init__(self, root: pathlib.Path = ROOT):
        self.root = root
        self.dir = root / HERE.name
        self.spec = json.loads((root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def reader(self, metric: str) -> pathlib.Path:
        """The file that reads ``metric``: its own, else that of the name
        before its last dot."""
        path = self.dir / "metrics" / f"{metric}.py"
        if not path.is_file() and "." in metric:
            path = self.dir / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"
        return path

    def limits(self, cell: str) -> dict:
        path = self.dir / "limits" / f"{cell}.json"
        return json.loads(path.read_text()) if path.exists() else {}

    def metrics(self, cell: str, trace: bool) -> list:
        """The cell's metrics: its end-to-end metrics, or with ``trace`` its
        per-layer metrics."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]


class Run:
    """What a run knows: its arguments, cell, configuration, traffic, the
    program, the items of its window and, when traced, the trace."""

    def __init__(self, args, bench: Bench, program, device, started: float):
        self.args = args
        self.bench = bench
        self.cell = bench.cell(args.workload)
        self.config = bench.config(self.cell["config"])
        self.traffic = bench.traffic(self.cell["traffic"])
        self.program = program
        self.device = device
        self.started = started
        self.peaks = json.loads((bench.dir / "peaks.json").read_text())
        self.items: list = []
        self.trace: dict | None = None
        self.values: dict = {}

    def work(self, name: str):
        return load_module(self.bench.dir / "work" / f"{name}.py")


def parse(argv):
    p = argparse.ArgumentParser(description="One run of one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # control.py sets it to read the control beside the program; a cell's run never does
    p.set_defaults(control=False)
    return p.parse_args(argv)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def import_program(root: pathlib.Path):
    if not (root / PROGRAM / "__init__.py").is_file():
        raise SystemExit(f"the program under test ({PROGRAM}/) is not in {root}")
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    import vlgp_tpu_torch
    return vlgp_tpu_torch


def measure(run: Run, loop) -> None:
    """The window: items back to back for ``--seconds`` (the item running at
    the close completes and counts), with the first ``trace_items`` under
    the profiler when traced."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = run.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    trace_items = int(run.traffic.get("trace_items", 2)) if run.args.trace else 0
    prof = None
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run.setup_s = t0 - run.started
    deadline = t0 + run.args.seconds
    i = 0
    while True:
        if i == 0 and trace_items:
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts)
            prof.__enter__()
        run.items.append(loop.item(i))
        i += 1
        if prof is not None and i == trace_items:
            sync()
            prof.__exit__(None, None, None)
            run.prof, prof = prof, None
        if time.perf_counter() >= deadline and i > loop.check_index and prof is None:
            break
    sync()
    run.window_s = time.perf_counter() - t0
    run.memory_peak = torch.cuda.max_memory_allocated() if cuda else 0


def execute(args, bench: Bench, program, device, started: float):
    """Set-up, window, metrics and check of one cell on ``device``: (the
    result line as a dict, {number: [value, limit]})."""
    import torch

    import drive
    import tracing

    run = Run(args, bench, program, device, started)
    loop = drive.make_loop(run)
    loop.setup()
    measure(run, loop)
    if args.trace:
        kind = torch.autograd.DeviceType.CUDA if device.type == "cuda" else \
            torch.autograd.DeviceType.CPU
        run.trace = tracing.reduce(run.prof.profiler.kineto_results.events(), kind)
        del run.prof
    run.values = loop.summary()
    metrics = {}
    for m in bench.metrics(args.workload, bool(args.trace)):
        v = load_module(bench.reader(m["name"])).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    loop.release()
    walls = sorted(r["wall"] for r in run.items)
    print(f"items: {len(walls)} in {run.window_s:.3f} s; single item s: min {walls[0]:.4f} "
          f"median {walls[len(walls) // 2]:.4f} max {walls[-1]:.4f}", file=sys.stderr)
    tic = time.perf_counter()
    numbers = loop.check()
    checked, correct = judge(numbers, bench.limits(args.workload))
    print(f"check: {time.perf_counter() - tic:.1f} s; readings not compared: "
          + json.dumps({k: v for k, v in numbers.items() if k not in checked}), file=sys.stderr)
    line = {"correct": correct, "attempted": len(run.items), "failed": loop.failed(),
            "metrics": metrics,
            "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                       "kind": torch.cuda.get_device_name(device) if device.type == "cuda"
                       else "cpu", "count": run.cell["chips"],
                       "memory_peak_bytes": run.memory_peak}}
    if args.trace:
        line["device"].update(busy_s=run.trace["busy_s"], window_s=run.trace["window_s"])
        line["breakdown"] = {"device_ops": run.trace["device_ops"],
                             "idle_gaps": run.trace["idle_gaps"]}
    line["build_s"] = run.build_s
    return line, checked


def main(argv, started: float) -> int:
    cache_dirs(ROOT)
    args = parse(argv)
    bench = Bench()
    cell = bench.cell(args.workload)
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < cell["chips"]:
        print(f"no result: the cell needs {cell['chips']} CUDA device(s), {n} available",
              file=sys.stderr)
        return 3
    program = import_program(ROOT)
    line, checked = execute(args, bench, program, torch.device("cuda", 0), started)
    bad = forbidden_modules()
    if bad:
        print(f"no result: JAX or the JAX package was loaded: {', '.join(bad)}", file=sys.stderr)
        return 4
    line["card"] = power_limit()
    line["checked"] = checked
    print(f"card: {line['card']}; kernel build {line['build_s']:.1f} s in this run "
          "(inside setup_s)", file=sys.stderr)
    for name, (value, limit) in checked.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


def judge(numbers: dict, limits: dict):
    """({name: [value, limit]} of the numbers the cell's limits name,
    correct): each at or under its limit.  A limit whose number the check
    did not compute, or a number that is not finite, fails; numbers without
    a limit are readings, not compared."""
    checked = {name: [numbers.get(name, float("nan")), limit] for name, limit in limits.items()}
    ok = bool(checked) and all(v == v and v <= lim for v, lim in checked.values())
    return checked, ok
