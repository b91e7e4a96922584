"""Time the CUDA kernels of one checkout of vlgp_tpu_torch on the card, so
that two trees can be compared in turns within one machine:

    python3 tools/torch_kernel_ab.py [ROOT] [--spd-only | --designs | --paths | --hstep | --estep]

ROOT: a checkout (default: this one).

Builds ROOT's ``csrc/`` and prints one JSON line with the card's name and
power limit and, per case, [median, min, max] ms over 10 calls, each
between its own pair of CUDA events (``chip_smoke.time_ms``): ``ns_gram`` at
the E-step shape (Z5 S2000 T50 R40) cold 16, warm 4 + v and probe + v, and
at the final inference's (Z5 S100 T1000 R50) and a leave-one-neuron-out
chunk's (Z5 S2500 T1000 R50) cold 16 + v, warm 4 + v and probe + v, each in
the design the checkout picks for it, with ``torch.matmul(w, K)`` at the
chunk in full FP32 (K[z, t, p] = G[z, t, i] G[z, t, j] over the pairs
i <= j: the Gram GEMM of the long-T design, as the yardstick of its GEMMs);
``ns_packed`` cold 16 and ``probe_skip`` (odd groups drifted, 4 rounds) at
B500 R50, and ``torch.linalg.inv_ex(I + A)`` on the same A; ``spd_inverse``
at B10000 R40, B10000 R64 and B2000 R128 (only these with ``--spd-only``);
``sweep`` at the flagship E-step shape (Z5 S2000 T50 Y100
R40) from a real carry with the adaptive exit on input draws 0, 1 and 2,
with its summed sweep, pass and round counts and the slowest group's
passes, timed per call and also as the mean of 3 back-to-back calls between
one pair of events; and on draw 0 with every group live (``tol=0``) for
niter = 0, 2, 4 and 6 sweeps, whose differences give the time of a fully
live sweep.  ``--designs`` times instead both designs of ``ns_gram`` of
this checkout (``_ns_gram_cuda(..., design=...)``) in those three modes at
T = 50, 99, 100, 200, 500 and 1000 with S = 100000 / T (100 trials of 1000
bins cut into segments of T), R = 40 and 50, and at the chunk: the
measurements behind ``ops/spd.py:_PAIRS_MIN_T``.  ``--paths`` times both
paths of the per-matrix design (the streaming path forced by
``stream_plan``, and the block path) at Z5 S2000 T50 and R = 17, 20, 24,
32, 33, 36, 38 and 40, and at T99 R36 and R40, in cold 16, warm 4 + v,
probe + v, warm 8 and probe, as replays of a captured call in turns
(block, stream, stream, block; the faster of each pair kept), with
whether the two paths agree bit for bit: the measurements behind
``ops/spd.py:gram_plan``.  ``--hstep`` runs the
flagship's default fit and prints the SHA-256 of its params and posterior
means (equal across two trees when their fits are equal bit for bit), then
times the H-step's kernels on that fit's state as ``chip_smoke.py`` 6c and
6d record it; ``--estep`` times the E-step's kernels at whole trials and
leave-one-neuron-out (below).  ``--hstep``: ``hstep_search`` at the first
refinement's C (Z5 T50, its x
in hex), and on that refinement's settings at T150, T200 and T1000
(``window=None``: the wide path, C from ``chip_smoke.gp_statistic``, its x
in hex; 3 calls at T1000) with the plan it picks and, on a tree with the
wide path's plans, every plan of 8 or more blocks a cluster (3 calls
each), ``hstep_stat`` at the fit's segments (Z5 S2000
T50 R40) and at whole trials (Z5 S100 T1000 R50, ``chip_smoke.hstat_case``),
each beside its plain version, and the SM clock and power (``nvidia-smi``)
while the T1000 call runs back to back.  ``--estep``: ``estep_project`` and
``estep_step`` on the plans the checkout picks at Z5 T1000 Y100 R50 for S100
(the final inference) and S2500 (a leave-one-neuron-out chunk's segment
count, no members), inputs as ``chip_smoke.estep_case`` draws them, and,
where the checkout's kernels take members (``cm``), at the chunk itself (25
members on S100, ``chip_smoke.members_case``), each as replays of a
captured call; then the flagship's default fit and
``leave_one_neuron_out`` over its 100 neurons at batch 1, 25 and 7: wall,
peak memory above the held state, launches, rounds and the scores' digest,
and one traced call at batch 25 with its kernel time by kind
(``chip_smoke.LONO_KERNEL_KINDS``).  The inputs are made with
``chip_smoke.py``'s helpers, from seed 0 (the sweep's from the seed of its
draw).  Needs a CUDA device.
"""
import importlib.util
import json
import pathlib
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parents[1]
ARGS = [a for a in sys.argv[1:] if not a.startswith("--")]
SPD_ONLY = "--spd-only" in sys.argv[1:]
DESIGNS = "--designs" in sys.argv[1:]
HSTEP = "--hstep" in sys.argv[1:]
PATHS = "--paths" in sys.argv[1:]
ESTEP = "--estep" in sys.argv[1:]
ROOT = pathlib.Path(ARGS[0]).resolve() if ARGS else HERE
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

_spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("torch_kernel_ab.py needs a CUDA device")
    from vlgp_tpu_torch.ops import _build, spd

    if not pathlib.Path(spd.__file__).resolve().is_relative_to(ROOT):
        raise RuntimeError(f"imported {spd.__file__}, not the checkout at {ROOT}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load_library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    device = torch.device("cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    out = {"root": str(ROOT), "card": smi.splitlines()[0]}
    if DESIGNS or HSTEP or PATHS or ESTEP:
        (time_designs if DESIGNS else time_paths if PATHS else time_estep if ESTEP
         else time_hstep)(device, gen, out)
        print(json.dumps(out))
        return
    if not SPD_ONLY:
        time_ns(device, gen, out)
        for S in (cs.NTRIAL, 25 * cs.NTRIAL):
            time_gram_modes(device, gen, out, S, cs.LENGTH, 50, f"ns_gram S{S} T1000 R50")
        time_gram_yardstick(device, gen, out)
    for B, R in ((10000, 40), (10000, 64), (2000, 128)):
        A = cs.spd_batch(B, R, device, gen)
        out[f"spd_inverse B{B} R{R}"] = cs.time_ms(lambda: spd._spd_inverse_cuda(A))
    if not SPD_ONLY:
        out.update(time_sweep(device, gen))
    print(json.dumps(out))


def time_ns(device, gen, out):
    from vlgp_tpu_torch.ops import spd

    Z = cs.ZDIM
    G, w, w_warm, X = gram_inputs(device, gen, 2000, 50, 40)
    out["ns_gram cold 16"] = cs.time_ms(lambda: spd._ns_gram_cuda(G, w, 16))
    out["ns_gram warm 4 + v"] = cs.time_ms(
        lambda: spd._ns_gram_cuda(G, w_warm, 4, x0=X, want_v=True))
    out["ns_gram probe + v"] = cs.time_ms(
        lambda: spd._ns_gram_cuda(G, w, 0, x0=X, resid_only=True, want_v=True))

    B, RP, N = cs.ZDIM * cs.NTRIAL, 50, cs.NTRIAL
    G = cs.realistic_factor(Z, cs.LENGTH, RP, device)
    w0 = torch.rand((Z, N, cs.LENGTH), generator=gen, device=device)
    w = w0 * (1e2 / cs.lambda_max(G, w0))
    A = torch.einsum("ztr,zst,ztq->zsrq", G, w, G).reshape(B, RP, RP).contiguous()
    X = spd._ns_packed_plain(A, 16)[0]
    group = torch.arange(B, device=device) // spd._probe_skip_groups(RP)
    x0 = torch.where((group % 2 == 1)[:, None, None], X * 0.97, X).contiguous()
    eye = torch.eye(RP, device=device)
    out["ns_packed cold 16"] = cs.time_ms(lambda: spd._ns_packed_cuda(A, 16))
    out["probe_skip"] = cs.time_ms(lambda: spd._ns_packed_cuda(A, 4, x0=x0, probe_skip=True))
    out["inv_ex(I + A)"] = cs.time_ms(lambda: torch.linalg.inv_ex(eye + A))


def gram_inputs(device, gen, S, T, R):
    """G, w (lambda_max ~1e2), a 2% drifted w and the cold plain X, as
    chip_smoke.check_ns_gram makes them."""
    from vlgp_tpu_torch.ops import spd

    G = cs.realistic_factor(cs.ZDIM, T, R, device)
    w0 = torch.rand((cs.ZDIM, S, T), generator=gen, device=device)
    w = (w0 * (1e2 / cs.lambda_max(G, w0))).contiguous()
    w_warm = (w * (1 + 0.02 * torch.rand(w.shape, generator=gen, device=device))).contiguous()
    X = spd._ns_gram_plain(G, w, 16)[0].contiguous()
    return G, w, w_warm, X


def time_gram_modes(device, gen, out, S, T, R, tag, **kw):
    """ns_gram cold 16 + v, warm 4 + v and probe + v at Z5 S T R; ``kw``
    goes to _ns_gram_cuda (``design=``)."""
    from vlgp_tpu_torch.ops import spd

    G, w, w_warm, X = gram_inputs(device, gen, S, T, R)
    out[f"{tag} cold 16 + v"] = cs.time_ms(lambda: spd._ns_gram_cuda(G, w, 16, want_v=True, **kw))
    out[f"{tag} warm 4 + v"] = cs.time_ms(
        lambda: spd._ns_gram_cuda(G, w_warm, 4, x0=X, want_v=True, **kw))
    out[f"{tag} probe + v"] = cs.time_ms(
        lambda: spd._ns_gram_cuda(G, w, 0, x0=X, resid_only=True, want_v=True, **kw))


def time_gram_yardstick(device, gen, out, S=25 * cs.NTRIAL, T=cs.LENGTH, R=50):
    """torch.matmul(w, K) in full FP32 at Z5 S T R, K the pairs' products."""
    G = cs.realistic_factor(cs.ZDIM, T, R, device)
    w = torch.rand((cs.ZDIM, S, T), generator=gen, device=device)
    i, j = torch.triu_indices(R, R, device=device)
    K = (G[:, :, i] * G[:, :, j]).contiguous()
    out[f"torch.matmul(w, K) S{S} T{T} P{K.shape[-1]}"] = cs.time_ms(lambda: torch.matmul(w, K))


def time_designs(device, gen, out):
    """Both ns_gram designs of this checkout, for its (T, R) rule."""
    for R in (40, 50):
        for T in (50, 99, 100, 200, 500, 1000):
            S = 100000 // T
            for design in ("per_matrix", "pairs"):
                gen.manual_seed(0)
                time_gram_modes(device, gen, out, S, T, R, f"{design} S{S} T{T} R{R}",
                                design=design)
    for design in ("per_matrix", "pairs"):
        gen.manual_seed(0)
        time_gram_modes(device, gen, out, 25 * cs.NTRIAL, cs.LENGTH, 50,
                        f"{design} S2500 T1000 R50", design=design)
    time_gram_yardstick(device, gen, out)


def time_paths(device, gen, out):
    """Both paths of the per-matrix design, for its launch plan's rule."""
    from vlgp_tpu_torch.ops import spd

    for T, R in ((50, 17), (50, 20), (50, 24), (50, 32), (50, 33), (50, 36), (50, 38), (50, 40),
                 (99, 36), (99, 40)):
        G, w, w_warm, X0 = cs.gram_case(cs.ZDIM, 2000, T, R, device, gen.manual_seed(0))
        plan = spd.stream_plan(T, R, cs.ZDIM)
        for mode in ("cold 16", "warm 4+v", "probe+v", "warm 8", "probe"):
            args = cs.gram_args(G, w, w_warm, X0, mode)
            same = cs.same_gram(spd._ns_gram_cuda(*args, plan=plan),
                                spd._ns_gram_cuda(*args, plan=spd.BLOCK_PLAN))
            ms = {}
            for path in ("block", "stream", "stream", "block"):
                kw = {"plan": plan if path == "stream" else spd.BLOCK_PLAN}
                t = cs.graph_ms(lambda: spd._ns_gram_cuda(*args, **kw))[0]
                ms[path] = min(ms.get(path, t), t)
            out[f"T{T} R{R} {mode}"] = {
                "plan": spd.gram_plan(T, R, cs.ZDIM).path, "stream_warps": plan.warps,
                "stream_ms": ms["stream"], "block_ms": ms["block"],
                "ratio": ms["stream"] / ms["block"], "bits_equal": same}
            print(f"T{T} R{R} {mode}", json.dumps(out[f"T{T} R{R} {mode}"]), flush=True)


def time_hstep(device, gen, out):
    """The flagship fit's digest and the H-step's kernels on its state."""
    import hashlib

    from vlgp_tpu_torch.ops import golden as og
    from vlgp_tpu_torch.ops import hstat as oh

    result = cs.run_fit(False)[6]
    h = hashlib.sha256()
    for t in (result.params.a, result.params.b, result.params.omega, result.data.mu):
        h.update(t.detach().cpu().numpy().tobytes())
    out["flagship fit sha256 (a, b, omega, mu)"] = h.hexdigest()
    seg, params, cfg = cs.fit_segments(result)
    calls = cs.record_hstep(seg, params, cfg)
    args, kw = calls["hstep_search"][0]
    out["hstep_search x (hex)"] = [float.hex(v) for v in og.hstep_search(*args, **kw).tolist()]
    out["hstep_search Z5 T50"] = cs.time_ms(lambda: og.hstep_search(*args, **kw))
    out["hstep_search plain"] = cs.time_ms(lambda: og._hstep_search_plain(
        *args, kw["polish"], kw["grid"], kw["tiebreak"], kw["profile_sigma"]))
    for T in (150, 200, cs.LENGTH):
        C = cs.gp_statistic(cs.ZDIM, T, 100.0, torch.float32, device, gen.manual_seed(0))
        a = [C, *args[1:]]
        out[f"hstep_search Z5 T{T} x (hex)"] = [
            float.hex(v) for v in og.hstep_search(*a, **kw).tolist()]
        out[f"hstep_search Z5 T{T}"] = cs.time_ms(lambda: og.hstep_search(*a, **kw),
                                                  reps=3 if T == cs.LENGTH else 10)
        plan = og.cluster_plan(cs.ZDIM, T, C.dtype, kw["grid"], args[7], kw["polish"], device)
        if "per" not in plan:  # a tree without the wide path's plans
            continue
        out[f"hstep_search Z5 T{T} plan"] = plan
        for nb, per in cs.search_plans(T, C.dtype):
            if nb >= 8:
                out[f"hstep_search Z5 T{T} nb {nb} per {per}"] = cs.time_ms(
                    lambda: og._hstep_search_cuda(*a, kw["polish"], kw["grid"], kw["tiebreak"],
                                                  kw["profile_sigma"], nb=nb, per=per), reps=3)
    cases = [("Z5 S2000 T50 R40", list(calls["hstep_stat"][0][0])),
             ("Z5 S100 T1000 R50", cs.hstat_case(5, 100, 1000, 50, torch.float32, device,
                                                 gen.manual_seed(0)))]
    for tag, a in cases:
        out[f"hstep_stat {tag}"] = cs.time_ms(lambda: oh.hstep_stat(*a))
        out[f"hstep_stat {tag} plain"] = cs.time_ms(lambda: oh._hstep_stat_plain(*a))
    # the SM clock and power while the T1000 call runs back to back for 3 s
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader", "-lms", "250"], stdout=subprocess.PIPE,
                           text=True)
    tic = time.perf_counter()
    while time.perf_counter() - tic < 3.0:
        for _ in range(50):
            oh.hstep_stat(*cases[1][1])
        torch.cuda.synchronize()
    smi.terminate()
    out["clocks.sm, power.draw during hstep_stat T1000"] = smi.communicate()[0].split("\n")[4:12]


def time_estep(device, gen, out):
    """The E-step's kernels at whole trials and leave-one-neuron-out's walls
    (``--estep``)."""
    import collections
    import hashlib
    import inspect

    from vlgp_tpu_torch import model_selection as ms
    from vlgp_tpu_torch.ops import control, spd
    from vlgp_tpu_torch.ops import estep as oe

    Z, T, Y, R = cs.ZDIM, cs.LENGTH, cs.YDIM, 50
    for S in (cs.NTRIAL, 25 * cs.NTRIAL):
        project, step = cs.estep_case(S, T, Y, Z, R, 1, torch.float32, device,
                                      gen.manual_seed(0))
        project = [t.contiguous() for t in project]
        step = [step[0], oe._estep_project_plain(*project)] + list(step[2:])
        out[f"estep_project Z{Z} S{S} T{T} Y{Y}"] = cs.graph_ms(lambda: oe.estep_project(*project))
        out[f"estep_step Z{Z} S{S} T{T} Y{Y} R{R}"] = cs.graph_ms(lambda: oe.estep_step(*step))
        out[f"estep_step Z{Z} S{S} T{T} Y{Y} R{R} path"] = oe.step_plan(S, T, Y, Z, R).path
        del project, step
    if "cm" in inspect.signature(oe.estep_project).parameters:
        project, step, cm = cs.members_case(cs.NTRIAL, T, Y, Z, R, 25, torch.float32, device,
                                            gen.manual_seed(0))
        step = [step[0], oe.estep_project(*project, cm)] + list(step[2:])
        tag = f"B25 S{cs.NTRIAL} T{T} Y{Y} Z{Z} R{R}"
        out[f"estep_project {tag}"] = cs.graph_ms(lambda: oe.estep_project(*project, cm))
        out[f"estep_step {tag}"] = cs.graph_ms(lambda: oe.estep_step(*step, cm))
        del project, step, cm
    torch.cuda.empty_cache()
    result = cs.run_fit(False)[6]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    for batch in (1, 25, 7):
        spd.reset_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tic = time.perf_counter()
        scores = ms.leave_one_neuron_out(result, batch=batch)
        wall = time.perf_counter() - tic
        digest = hashlib.sha256(json.dumps([float.hex(float(scores[n]))
                                            for n in sorted(scores)]).encode()).hexdigest()
        out[f"9c batch {batch}"] = {
            "wall_s": wall,
            "peak_above_held_gib": (torch.cuda.max_memory_allocated() - held) / 2 ** 30,
            "launches": {k: spd.KERNEL_LAUNCHES[k] for k in ("ns_gram", "ns_packed",
                                                             "estep_project", "estep_step")},
            "rounds": control.TRIPS["lono_rounds"], "scores_sha256": digest,
            "scores": [float(scores[n]) for n in sorted(scores)]}
    wall, busy, by_name = cs.trace_kernels(lambda: ms.leave_one_neuron_out(result, batch=25))
    kinds = collections.Counter()
    for name, t in by_name.items():
        kinds[next((k for k, keys in cs.LONO_KERNEL_KINDS if any(x in name for x in keys)),
                   "other")] += t
    out["9c batch 25 traced"] = {"wall_s": wall, "kernels_s": busy, "by_kind_s": dict(kinds)}


def time_sweep(device, gen):
    from vlgp_tpu_torch.config import Config
    from vlgp_tpu_torch.ops import sweep as sw

    cfg = Config()
    kw = dict(niter=cfg.Eniter, tol=cfg.estep_tol, dmu_bound=cfg.dmu_bound,
              ns_iters=cfg.ns_iters, ns_warm_iters=cfg.ns_warm_iters, vb=True,
              bs=sw._pick_bs(cs.ZDIM, 50, cs.YDIM, 40))
    out = {}
    for seed in (0, 1, 2):
        args = cs.sweep_inputs(cs.ZDIM, 2000, 50, cs.YDIM, 40, device, gen.manual_seed(seed))
        carry = sw._sweep_cuda(*args, None, **dict(kw, niter=4, tol=0.0))[4].contiguous()
        run = lambda: sw._sweep_cuda(*args, carry, **kw)  # noqa: E731
        counts = run()[6]
        tag = f"sweep draw {seed}"
        out[tag + " counts (sweeps, passes, rounds)"] = counts.double().sum(0).tolist()
        out[tag + " slowest group's passes"] = int(counts[:, 1].max())
        out[tag] = cs.time_ms(run)
        run()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            run()
        end.record()
        torch.cuda.synchronize()
        out[tag + ", mean of 3 back-to-back"] = start.elapsed_time(end) / 3
        if seed == 0:
            for n in (0, 2, 4, 6):
                out[f"sweep draw 0, tol 0, niter {n}"] = cs.time_ms(
                    lambda: sw._sweep_cuda(*args, carry, **dict(kw, niter=n, tol=0.0)))
    return out


if __name__ == "__main__":
    main()
