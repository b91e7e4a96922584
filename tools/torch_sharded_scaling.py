"""How does vlgp_tpu_torch's sharded fit scale over cards?

    python3 -m torch.distributed.run --nproc-per-node 4 tools/torch_sharded_scaling.py OUT.json
    python3 -m torch.distributed.run --nproc-per-node 4 tools/torch_sharded_scaling.py OUT.json \\
        --meshes 4x1,2x2,1x4                         # the (data, model) meshes of all ranks
    python3 -m torch.distributed.run --nproc-per-node 4 tools/torch_sharded_scaling.py OUT.json \\
        --device cpu --backend gloo --small          # a rehearsal on the CPU

Every rank joins the group with ``initialize_distributed`` (nccl, one card
per rank: ``cuda:<LOCAL_RANK>``) and, on the flagship workload of
``chip_smoke.py`` (100 trials x 1000 bins x 100 neurons x 5 latents, seed
0, 30 EM iterations, no callbacks):

1. runs ``fit`` alone on its own card, all ranks at once (world 1);
2. runs ``fit_sharded`` over the ranks 0..1 (world 2; the others wait) and
   over all ranks (world 4), each with the counters set to 0 just before;

in turns: fit, world 2, world 4, world 4, world 2, fit.  With ``--meshes``
the sharded runs are ``fit_sharded`` over all ranks on each listed mesh
instead, in turns (fit, the meshes, the meshes reversed, fit).  Rank 0
writes each run's wall (host clock ending in ``torch.cuda.synchronize``),
EM-loop seconds, all-reduces and bytes by axis, and R^2 to OUT.json and
prints it, with the card's name and power limit.  ``--small`` cuts the
workload to 8 x 200 x 20 x 3 and 6 EM iterations.
"""
import argparse
import datetime
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as tdist  # noqa: E402

_spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--device", default=None)
    ap.add_argument("--backend", default="nccl")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--meshes", default="", help="DxM,... over all ranks, e.g. 4x1,2x2,1x4")
    args = ap.parse_args()

    import vlgp_tpu_torch
    from vlgp_tpu_torch.models import vlgp as tv
    from vlgp_tpu_torch.ops import spd
    from vlgp_tpu_torch.parallel import make_mesh
    from vlgp_tpu_torch.parallel.driver import fit_sharded, initialize_distributed

    timeout = datetime.timedelta(seconds=300)
    initialize_distributed(backend=args.backend, timeout=timeout)
    rank, world = tdist.get_rank(), tdist.get_world_size()
    if args.device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    device = torch.device(args.device) if args.device else torch.device(
        "cuda", int(os.environ["LOCAL_RANK"]))
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.small:
        trials, a, zt = cs.make_workload(ntrial=8, length=200, ydim=20)
        kw = dict(b=np.full((1, 20), -2.0), omega=np.full(cs.ZDIM, 1e-2), max_iter=6)
    else:
        trials, a, zt = cs.make_workload()
        kw = dict(cs.FLAGSHIP_KW)
    if args.meshes:  # every rank makes every mesh's subgroups, in one order
        names = args.meshes.split(",")
        meshes = {m: make_mesh(tuple(map(int, m.split("x"))), device=device, timeout=timeout)
                  for m in names}
        order = ([("fit", 1)] + [("sharded", m) for m in names + names[::-1]] + [("fit", 1)])
    else:
        pair = tdist.new_group([0, 1])
        meshes = {2: make_mesh(group=pair, device=device) if rank < 2 else None,
                  world: make_mesh(device=device)}
        order = [("fit", 1), ("sharded", 2), ("sharded", world), ("sharded", world),
                 ("sharded", 2), ("fit", 1)]

    def run(name, n):
        tdist.barrier()
        if name == "sharded" and meshes.get(n) is None:
            return None
        spd.reset_counters()
        for k in tv.COLLECTIVES:
            tv.COLLECTIVES[k] = 0
        sync(device)
        tic = time.perf_counter()
        if name == "fit":
            res = vlgp_tpu_torch.fit(trials, cs.ZDIM, a=a, device=device, **kw)
        else:
            res = fit_sharded(trials, cs.ZDIM, a=a, mesh=meshes[n], **kw)
        sync(device)
        wall = time.perf_counter() - tic
        em = res.runtime["em_elapsed"]
        r2 = cs.r2_aligned(res.data.mu.cpu().numpy().reshape(-1, cs.ZDIM), zt)
        c = tv.COLLECTIVES
        return {"run": name, "world" if isinstance(n, int) else "mesh": n, "wall_s": wall,
                "em_s": sum(em), "it": res.runtime["it"], "r2": r2,
                "all_reduce": c["all_reduce"], "all_reduce_data": c["all_reduce_data"],
                "all_reduce_model": c["all_reduce_model"], "bytes_data": c["bytes_data"],
                "bytes_model": c["bytes_model"], "ns_gram": spd.KERNEL_LAUNCHES["ns_gram"]}

    rows = []
    for name, n in order:
        rows.append(run(name, n))
        print(f"rank {rank}: {rows[-1]}", flush=True)
    tdist.barrier()
    tdist.destroy_process_group()
    if rank == 0:
        card = "cpu"
        if device.type == "cuda":
            card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True,
                                  text=True).stdout.strip().splitlines()[0]
        out = {"card": card, "world": world, "small": args.small, "runs": rows}
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
        print(json.dumps(out))


if __name__ == "__main__":
    main()
