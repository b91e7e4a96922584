"""One rank of a multi-process ``gloo`` run of vlgp_tpu_torch.parallel on
the CPU, for tests/test_torch_parallel.py and
tests/test_torch_parallel_model.py.

Usage: python tests/_torch_dist_worker.py <case> <rank> <world> <port> <out> [<d>x<m>]

Joins a ``gloo`` group of <world> ranks at tcp://127.0.0.1:<port> (60 s
timeout, the model axis's subgroups too), makes a mesh of shape <d>x<m>
(default: every rank on the data axis), runs the named case on the
workload of :func:`workload`, and writes what it returns to <out> with
``torch.save``.  Imports nothing of JAX: the tests run ``vlgp_tpu``'s side
in their own process.  :func:`launch` and :func:`collect` start the ranks
and read their results.
"""
import datetime
import os
import socket
import subprocess
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
from vlgp_tpu_torch.parallel import (gather, make_mesh, pad_channels, pad_segments,  # noqa: E402
                                     shard_data, sharded_em_scan, sharded_em_step,
                                     sharded_infer)
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
# the model-axis cases' channel count: odd, so a model axis of 2 pads one
YDIM_ODD = 15
TIMEOUT = datetime.timedelta(seconds=60)
HERE = os.path.dirname(os.path.abspath(__file__))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(case: str, out_dir: str, world: int = 2, mesh: str = ""):
    """Start every rank of one case, each a process of its own (one thread)."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), case, str(r),
                              str(world), str(port), os.path.join(out_dir, f"{case}{r}.pt")]
                             + ([mesh] if mesh else []),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
            for r in range(world)]


def collect(procs, case: str, out_dir: str, timeout: float = 240):
    """Every rank's result of a case started by :func:`launch`, in rank order."""
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {case} failed:\n{out}"
    return [torch.load(os.path.join(out_dir, f"{case}{r}.pt"), weights_only=False)
            for r in range(len(procs))]


def workload(seed=1, ydim=YDIM):
    """(trials with a small random mu, loading a): every initial value is
    given, so no factor analysis draws."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(ZDIM, ydim)) * 0.6
    trials = []
    for _ in range(NTRIAL):
        z = np.column_stack((np.sin(np.linspace(0, 7, LENGTH)),
                             np.cos(np.linspace(0, 7, LENGTH))))
        trials.append({"y": rng.poisson(np.exp(z @ a - 1.6)).astype(float),
                       "mu": rng.normal(size=(LENGTH, ZDIM)) * 0.1})
    return trials, a


def start_kw(a):
    ydim = a.shape[1]
    return dict(a=a, b=np.full((1, ydim), -1.6), noise=np.ones(ydim))


def prepared(config, ydim=YDIM, model=1):
    """The fit's state after set-up, channels padded to a multiple of
    ``model``: (full trials, segments, params, G_seg)."""
    trials, a = workload(ydim=ydim)
    kw = start_kw(a)
    params = make_params(ydim, ZDIM, 1, "poisson", a=kw["a"], b=kw["b"], noise=kw["noise"],
                         omega=np.full(ZDIM, 1e-2), dtype=torch.float64)
    data = pack_trials(trials, ZDIM, 1, dtype=torch.float64)
    data, params = pad_channels(data, params, model)
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


def _reset():
    """Set the kernel, route and collective counters to 0."""
    spd.reset_counters()
    for k in tv.COLLECTIVES:
        tv.COLLECTIVES[k] = 0


def case_adaptive(mesh, out_dir):
    """fit_sharded with the adaptive exits and the grid stage on: float64
    on the default E-step path, and float32 with the fused sweep (the
    kernels' plain versions on the CPU); collectives counted per fit."""
    trials, a = workload(seed=4)
    out = {}
    for name, dtype, fused in (("f64", "float64", False), ("f32_fused", "float32", True)):
        tv._SWEEP_FUSED = fused
        _reset()
        res = fit_sharded(trials, ZDIM, device="cpu", dtype=dtype, max_iter=6,
                          **start_kw(a))
        tv._SWEEP_FUSED = False
        out[name] = {"params": _host(res.params), "mu": res.data.mu.cpu(),
                     "v": res.data.v.cpu(), "it": res.runtime["it"],
                     "collectives": dict(tv.COLLECTIVES),
                     "sweep_calls": spd.ROUTE_CALLS["sweep"]}
    return out


def case_model(mesh, out_dir):
    """On a (1, 2) mesh, 15 channels padded to 16 (float64, STRICT): one
    sharded EM step and one sharded inference from the prepared state, a
    whole fit_sharded with ELBO tracking and a recording callback, then the
    adaptive exits on in float32 with the fused sweep asked for."""
    config = default_config(**FIT_KW)
    data, seg, params, G = prepared(config, YDIM_ODD, mesh.shape[1])
    seg_full = pad_segments(seg, mesh.shape[0])
    seg_s, p_s = shard_data(seg_full, mesh), shard_data(params, mesh)
    _reset()
    step = sharded_em_step(mesh, config, seg_s, p_s)
    seg_s, p1, G1, norms, xinv = step(seg_s, p_s, G, xinv_zeros(seg_s, G), 0)
    step_counts = dict(tv.COLLECTIVES)
    out = {"step_seg": _host(gather(seg_s, mesh, static=seg_full)),
           "step_params": _host(gather(p1, mesh)),
           "step_G": G1.cpu(), "step_norms": {k: float(v) for k, v in norms.items()},
           "step_counts": step_counts, "likelihood_kind": p1.likelihood_kind,
           "local_y": tuple(seg_s.y.shape)}
    full = pad_segments(data, mesh.shape[0])
    data_s = shard_data(full, mesh)
    inf = sharded_infer(mesh, config, data_s, p_s)(data_s, p_s, make_cholesky(data.nbin, params))
    out["infer"] = _host(gather(inf, mesh, static=full))

    trials, a = workload(ydim=YDIM_ODD)
    seen = []
    res = fit_sharded(trials, ZDIM, mesh=mesh, track_elbo=True,
                      callbacks=[lambda d, p, c: seen.append((d.ydim, _host(p)))],
                      **start_kw(a), **FIT_KW)
    out.update(fit_params=_host(res.params), fit_mu=res.data.mu.cpu(), fit_ydim=res.data.ydim,
               fit_runtime={k: res.runtime[k] for k in ("it", "elbo")},
               final_hstep=res.runtime.get("final_hstep", False), seen=seen)

    trials, a = workload(seed=4, ydim=YDIM_ODD)
    tv._SWEEP_FUSED = True
    _reset()
    res = fit_sharded(trials, ZDIM, mesh=mesh, dtype="float32", max_iter=6, **start_kw(a))
    tv._SWEEP_FUSED = False
    out["adaptive"] = {"params": _host(res.params), "mu": res.data.mu.cpu(), "v": res.data.v.cpu(),
                       "it": res.runtime["it"], "collectives": dict(tv.COLLECTIVES),
                       "sweep_calls": spd.ROUTE_CALLS["sweep"]}
    return out


def case_model4(mesh, out_dir):
    """fit_sharded on a (2, 2) mesh of four ranks, 15 channels padded to 16
    and 15 segments padded to 16 (float64, STRICT)."""
    trials, a = workload(ydim=YDIM_ODD)
    _reset()
    res = fit_sharded(trials, ZDIM, mesh=mesh, **start_kw(a), **FIT_KW)
    return {"fit_params": _host(res.params), "fit_mu": res.data.mu.cpu(),
            "it": res.runtime["it"], "final_hstep": res.runtime.get("final_hstep", False),
            "collectives": dict(tv.COLLECTIVES), "coords": mesh.coords}


def case_scan(mesh, out_dir):
    """sharded_em_scan of 3 steps from the prepared state, then fit_sharded
    with block=2 (two blocks of 2 EM iterations, then the closing H-step)
    with ELBO tracking and a recording callback (float64, STRICT).  A mesh
    with a model axis fits the 15 channels of the model cases, padded."""
    ydim = YDIM if mesh.shape[1] == 1 else YDIM_ODD
    config = default_config(**FIT_KW)
    data, seg, params, G = prepared(config, ydim, mesh.shape[1])
    seg_full = pad_segments(seg, mesh.shape[0])
    seg_s, p_s = shard_data(seg_full, mesh), shard_data(params, mesh)
    scan = sharded_em_scan(mesh, config, seg_s, p_s, 3)
    seg_s, p3, G3, xinv, norms = scan(seg_s, p_s, G, xinv_zeros(seg_s, G), 0)
    out = {"scan_seg": _host(gather(seg_s, mesh, static=seg_full)),
           "scan_params": _host(gather(p3, mesh)), "scan_G": G3.cpu(),
           "scan_norms": {k: v.cpu() for k, v in norms.items()},
           "xinv_shape": tuple(xinv.shape)}
    trials, a = workload(ydim=ydim)
    seen = []
    res = fit_sharded(trials, ZDIM, mesh=mesh, block=2, track_elbo=True,
                      callbacks=[lambda d, p, c: seen.append((d.ntrial, _host(p)))],
                      **start_kw(a), **FIT_KW)
    out.update(fit_params=_host(res.params), fit_mu=res.data.mu.cpu(), seen=seen,
               fit_runtime={k: res.runtime.get(k) for k in ("it", "elbo", "converged_at",
                                                            "final_hstep")})
    return out


def main():
    case, rank, world, port, out = sys.argv[1:6]
    shape = tuple(int(n) for n in sys.argv[6].split("x")) if len(sys.argv) > 6 else None
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=int(rank),
                             world_size=int(world), timeout=TIMEOUT)
    mesh = make_mesh(shape, device="cpu", timeout=TIMEOUT)
    result = {"parity": case_parity, "adaptive": case_adaptive, "model": case_model,
              "model4": case_model4, "scan": case_scan}[case](mesh, os.path.dirname(out))
    tdist.destroy_process_group()
    torch.save(result, out)


if __name__ == "__main__":
    main()
