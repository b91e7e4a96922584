"""One rank of a two-process ``gloo`` run of vlgp_tpu_torch.parallel on the
CPU, for tests/test_torch_parallel.py.

Usage: python tests/_torch_dist_worker.py <case> <rank> <world> <port> <out>

Joins a ``gloo`` group at tcp://127.0.0.1:<port> (60 s timeout), runs the
named case on the float64 workload of :func:`workload`, and writes what it
returns to <out> with ``torch.save``.  Imports nothing of JAX: the test
runs ``vlgp_tpu``'s side in its own process.
"""
import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as tdist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import vlgp_tpu_torch.callback as cb_mod  # noqa: E402
from vlgp_tpu_torch.config import default_config, make_params  # noqa: E402
from vlgp_tpu_torch.data import cut_trials, pack_trials  # noqa: E402
from vlgp_tpu_torch.models import vlgp as tv  # noqa: E402
from vlgp_tpu_torch.models.driver import xinv_zeros  # noqa: E402
from vlgp_tpu_torch.models.gp import effective_rank, make_cholesky  # noqa: E402
from vlgp_tpu_torch.models.vlgp import update_v, update_w  # noqa: E402
from vlgp_tpu_torch.ops import spd  # noqa: E402
from vlgp_tpu_torch.parallel import (gather, make_mesh, pad_segments, shard_data,  # noqa: E402
                                     sharded_em_step, sharded_infer)
from vlgp_tpu_torch.parallel.driver import fit_sharded  # noqa: E402

# JAX's strict single-vs-multi-device settings (tests/test_fit_sharded.py:45-55):
# no grid stage and no adaptive exits, whose discrete decisions can flip on
# reduction-order noise
STRICT = dict(hyper_grid=0, estep_tol=0, mstep_tol=0)
# the parity case's config, for the step, the inference and the fit alike
# (one config: vlgp_tpu compiles its sharded step and inference once)
FIT_KW = dict(dtype="float64", max_iter=4, min_iter=1, **STRICT)
# 5 trials x 130 bins cut into 15 window-50 segments: odd, so two ranks pad
NTRIAL, LENGTH, YDIM, ZDIM = 5, 130, 16, 2


def workload(seed=1):
    """(trials with a small random mu, loading a): every initial value is
    given, so no factor analysis draws."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(ZDIM, YDIM)) * 0.6
    trials = []
    for _ in range(NTRIAL):
        z = np.column_stack((np.sin(np.linspace(0, 7, LENGTH)),
                             np.cos(np.linspace(0, 7, LENGTH))))
        trials.append({"y": rng.poisson(np.exp(z @ a - 1.6)).astype(float),
                       "mu": rng.normal(size=(LENGTH, ZDIM)) * 0.1})
    return trials, a


def start_kw(a):
    return dict(a=a, b=np.full((1, YDIM), -1.6), noise=np.ones(YDIM))


def prepared(config):
    """The fit's state after set-up: (full trials, segments, params, G_seg)."""
    trials, a = workload()
    kw = start_kw(a)
    params = make_params(YDIM, ZDIM, 1, "poisson", a=kw["a"], b=kw["b"], noise=kw["noise"],
                         omega=np.full(ZDIM, 1e-2), dtype=torch.float64)
    data = pack_trials(trials, ZDIM, 1, dtype=torch.float64)
    G = make_cholesky(data.nbin, params)
    data = update_v(update_w(data, params, config), params, G, config)
    seg = cut_trials(data, config.window, seed=0)
    rank = min(params.rank, effective_rank(seg.nbin, config.omega_bound[1], params.dt))
    return data, seg, params, make_cholesky(seg.nbin, params, rank=rank)


def _host(obj):
    """Tensors of a dataclass as CPU tensors, by field name."""
    return {k: v.detach().cpu() for k, v in vars(obj).items() if isinstance(v, torch.Tensor)}


def case_parity(mesh, out_dir):
    """One sharded EM step and one sharded inference from the prepared
    state, then a whole fit_sharded (4 EM iterations at hyper_interval 2, so
    a closing H-step) with ELBO tracking, a recording callback and path=."""
    config = default_config(**FIT_KW)
    data, seg, params, G = prepared(config)
    seg_full = pad_segments(seg, mesh.world)
    seg_s = shard_data(seg_full, mesh)
    step = sharded_em_step(mesh, config, seg_s, params)
    seg_s, p1, G1, norms, xinv = step(seg_s, params, G, xinv_zeros(seg_s, G), 0)
    step_seg = gather(seg_s, mesh, static=seg_full)

    full = pad_segments(data, mesh.world)
    data_s = shard_data(full, mesh)
    inf = sharded_infer(mesh, config, data_s, params)(data_s, params,
                                                                make_cholesky(data.nbin, params))
    inf = gather(inf, mesh, static=full)

    # count the snapshots this rank writes (Saver.save -> save_params)
    saves = []
    save_params = cb_mod.save_params
    cb_mod.save_params = lambda *args: saves.append(1) or save_params(*args)
    seen = []
    trials, a = workload()
    res = fit_sharded(trials, ZDIM, device="cpu", track_elbo=True,
                      path=os.path.join(out_dir, "snap"), saving_interval=0,
                      callbacks=[lambda d, p, c: seen.append((d.ntrial, _host(p)))],
                      **start_kw(a), **FIT_KW)
    cb_mod.save_params = save_params
    return {"step_seg": _host(step_seg), "step_params": _host(p1), "step_G": G1.cpu(),
            "step_norms": {k: float(v) for k, v in norms.items()},
            "xinv_shape": tuple(xinv.shape), "infer": _host(inf),
            "fit_params": _host(res.params), "fit_mu": res.data.mu.cpu(),
            "fit_runtime": {k: res.runtime[k] for k in ("it", "elbo")},
            "final_hstep": res.runtime.get("final_hstep", False),
            "seen": seen, "saves": len(saves)}


def case_adaptive(mesh, out_dir):
    """fit_sharded with the adaptive exits and the grid stage on: float64
    on the default E-step path, and float32 with the fused sweep (the
    kernels' plain versions on the CPU); collectives counted per fit."""
    trials, a = workload(seed=4)
    out = {}
    for name, dtype, fused in (("f64", "float64", False), ("f32_fused", "float32", True)):
        tv._SWEEP_FUSED = fused
        spd.reset_counters()
        for k in tv.COLLECTIVES:
            tv.COLLECTIVES[k] = 0
        res = fit_sharded(trials, ZDIM, device="cpu", dtype=dtype, max_iter=6,
                          **start_kw(a))
        tv._SWEEP_FUSED = False
        out[name] = {"params": _host(res.params), "mu": res.data.mu.cpu(),
                     "v": res.data.v.cpu(), "it": res.runtime["it"],
                     "collectives": dict(tv.COLLECTIVES),
                     "sweep_calls": spd.ROUTE_CALLS["sweep"]}
    return out


def main():
    case, rank, world, port, out = sys.argv[1:6]
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=int(rank),
                             world_size=int(world), timeout=datetime.timedelta(seconds=60))
    mesh = make_mesh(device="cpu")
    result = {"parity": case_parity, "adaptive": case_adaptive}[case](mesh, os.path.dirname(out))
    tdist.destroy_process_group()
    torch.save(result, out)


if __name__ == "__main__":
    main()
