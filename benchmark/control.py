#!/usr/bin/env python3
"""Readings that set a cell's limits: the program's numbers on many seeds,
the control's and the planted faults' on a few, read in one process at the
cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,... --control-seeds 3 \
        [--faults 3] [--resid-tol 1e-6]

For each seed it runs the cell's set-up and one item of its traffic (the
item the check compares), then the check; on the first ``--control-seeds``
seeds it also computes the control: the reference put in the program's
place in float32 with TF32 products (see checks.py); on the first
``--faults`` seeds it runs the item again with each fault of ``faults.py``
planted (the eager driver).  ``--resid-tol`` sets the program's residual
contract for its Newton-Schulz inverses (1e-2 as shipped) for the whole
process: a witness of what the inverses' accuracy does to the numbers.  One
JSON line a seed on standard output: {"seed", "program", "control",
"faults": {fault: {...}}}.  Needs a CUDA device.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import harness  # noqa: E402


def _item(workload, seed, device, bench, program, control=False, **traffic):
    """Set-up, one item and the check of ``workload`` at ``seed``: the numbers."""
    import drive

    args = harness.parse(["--workload", workload, "--seed", str(seed), "--seconds", "0",
                          "--trace", "0"])
    args.control = control
    run = harness.Run(args, bench, program, device, time.perf_counter())
    run.traffic = dict(run.traffic, datasets=1, check_among=1, **traffic)
    loop = drive.make_loop(run)
    loop.setup()
    harness.measure(run, loop)
    loop.summary()
    loop.release()
    return loop.check()


def readings(workload: str, seeds, control_seeds: int, device, bench=None, program=None,
             fault_seeds: int = 0):
    """[{"seed", "program", "control", "faults"}] for each seed (the control on
    the first ``control_seeds``, the faults on the first ``fault_seeds``)."""
    import faults

    bench = bench or harness.Bench()
    program = program or harness.import_program(bench.root)
    kind = bench.traffic(bench.cell(workload)["traffic"])["kind"]
    out = []
    for k, seed in enumerate(seeds):
        nums = _item(workload, seed, device, bench, program, control=k < control_seeds)
        rec = {"seed": seed,
               "program": {k2: v for k2, v in nums.items() if not k2.startswith("control.")},
               "control": {k2[8:]: v for k2, v in nums.items() if k2.startswith("control.")},
               "faults": {}}
        for fault in faults.BY_KIND[kind] if k < fault_seeds else ():
            patches = faults.Patches()
            fault(patches)
            try:
                rec["faults"][fault.__name__] = _item(workload, seed, device, bench, program,
                                                      fused=False)
            except Exception as e:  # a fault that crashes the run has failed it
                rec["faults"][fault.__name__] = {"crashed": repr(e)[:300]}
            finally:
                patches.undo()
        out.append(rec)
        print(json.dumps(rec), flush=True)
    return out


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--faults", type=int, default=0)
    p.add_argument("--resid-tol", type=float, default=None)
    a = p.parse_args(argv)
    harness.cache_dirs(harness.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 3
    bench = harness.Bench()
    program = harness.import_program(bench.root)
    if a.resid_tol is not None:
        from vlgp_tpu_torch.ops import spd
        spd._RESID_TOL = a.resid_tol
    readings(a.workload, [int(s) for s in a.seeds.split(",")], a.control_seeds,
             torch.device("cuda", 0), bench, program, a.faults)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
