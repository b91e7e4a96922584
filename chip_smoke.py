"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles vlgp_tpu_torch/csrc/ns_inverse.cu with nvcc (sm_90a);
3. ns_gram against its plain PyTorch version on the card, at the two
   main-path shapes (E/H-step segments and the final full-length
   inference), in the cold, warm, probe and want_v modes, plus a NaN warm
   start that must be rejected;
4. ns_packed the same way at the update_v shape, then both kernels at
   edge shapes (R from 1 to the 128 limit, T = 1, iters = 0 with x0);
5. a small fit (4 trials x 120 bins x 10 neurons x 2 latents) on the card
   in float32 against the same fit on the CPU in float64 (exact route);
6. vlgp_tpu_torch.fit on the 100 trials x 1000 bins x 100 neurons x 5
   latents workload (seed 0), with the launch counts of both kernels,
   the fallback counters, and the lstsq-aligned recovery R^2.

Ends with one JSON line of per-kernel results and, last, one JSON line
naming the device.  Imports nothing of JAX.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

RESID_TOL = 1e-2
AGREE_TOL = 1e-4  # kernel vs plain, relative to max|X|, for lambda <= 1e2
R2_MIN = 0.93
EXACT_SHARE_MAX = 0.10

NTRIAL, LENGTH, YDIM, ZDIM = 100, 1000, 100, 5


def log(msg=""):
    print(msg, flush=True)


def time_ms(fn, reps=5):
    """Mean device time of fn() in ms, by CUDA events after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def realistic_factor(Z, T, R, device):
    """SE prior factors as the fit builds them (Nystrom for segments,
    pivoted ichol for full-length trials) at staggered omegas."""
    from vlgp_tpu_torch.models.gp import _se_factor

    omega = torch.logspace(np.log10(6e-4), np.log10(2e-3), Z, dtype=torch.float32,
                           device=device)
    return _se_factor(T, omega, R, 1.0, torch.float32).contiguous()


def lambda_max(G, w):
    A = torch.einsum("ztr,zst,ztq->zsrq", G.double(), w.double(), G.double())
    return float(torch.linalg.eigvalsh(A).amax())


def resid64(G, w, X):
    """max|(I+A)X - I| in float64 from the float32 inputs."""
    A = torch.einsum("ztr,zst,ztq->zsrq", G.double(), w.double(), G.double())
    eye = torch.eye(A.shape[-1], dtype=torch.float64, device=A.device)
    return float(((A + eye) @ X.double() - eye).abs().amax())


def check_ns_gram(Z, S, T, R, device, gen):
    from vlgp_tpu_torch.ops import spd

    G = realistic_factor(Z, T, R, device)
    # scale the weights so the well-conditioned set has lambda_max ~ 1e2
    w0 = torch.rand((Z, S, T), generator=gen, device=device, dtype=torch.float32)
    w = (w0 * (1e2 / lambda_max(G, w0))).contiguous()
    lam = lambda_max(G, w)
    w_warm = (w * (1 + 0.02 * torch.rand(w.shape, generator=gen, device=device))).contiguous()
    rows, worst = [], 0.0

    def compare(mode, k, p):
        nonlocal worst
        Xk, rk, vk = k
        Xp, rp, vp = p
        torch.cuda.synchronize()
        rk = float(rk.amax())
        if not rk < RESID_TOL:
            raise AssertionError(f"ns_gram {mode} at {(Z, S, T, R)}: kernel residual {rk}")
        scale = float(Xp.abs().amax()) if Xp is not None else 1.0
        errs = []
        if Xk is not None:
            errs.append(float((Xk - Xp).abs().amax()))
        if vk is not None:
            errs.append(float((vk - vp).abs().amax()))
        err = max(errs)
        if not err <= AGREE_TOL * scale:
            raise AssertionError(f"ns_gram {mode} at {(Z, S, T, R)}: |kernel - plain| "
                                 f"{err} > {AGREE_TOL} * {scale}")
        worst = max(worst, err)
        return rk, err

    # cold (E-step first sweep / H-step cold: 16 and 18 iterations)
    cold_k = spd._ns_gram_cuda(G, w, 16, want_v=True)
    cold_p = spd._ns_gram_plain(G, w, 16, want_v=True)
    rk, err = compare("cold+v", cold_k, cold_p)
    ms = time_ms(lambda: spd._ns_gram_cuda(G, w, 16))
    pms = time_ms(lambda: spd._ns_gram_plain(G, w, 16))
    rows.append(("cold", rk, err, ms, pms))
    msv = time_ms(lambda: spd._ns_gram_cuda(G, w, 16, want_v=True))
    pmsv = time_ms(lambda: spd._ns_gram_plain(G, w, 16, want_v=True))
    rows.append(("cold+v", rk, err, msv, pmsv))

    X_cold = cold_p[0].contiguous()
    # warm refine (4 iterations, the E-step's ns_warm_iters)
    rk, err = compare("warm+v", spd._ns_gram_cuda(G, w_warm, 4, x0=X_cold, want_v=True),
                      spd._ns_gram_plain(G, w_warm, 4, x0=X_cold, want_v=True))
    rows.append(("warm+v", rk, err,
                 time_ms(lambda: spd._ns_gram_cuda(G, w_warm, 4, x0=X_cold, want_v=True)),
                 time_ms(lambda: spd._ns_gram_plain(G, w_warm, 4, x0=X_cold, want_v=True))))
    # probe: one product, no X written, v from x0
    pk = spd._ns_gram_cuda(G, w, 0, x0=X_cold, resid_only=True, want_v=True)
    if pk[0] is not None:
        raise AssertionError("probe wrote X")
    rk, err = compare("probe+v", pk,
                      spd._ns_gram_plain(G, w, 0, x0=X_cold, resid_only=True, want_v=True))
    rows.append(("probe+v", rk, err,
                 time_ms(lambda: spd._ns_gram_cuda(G, w, 0, x0=X_cold, resid_only=True, want_v=True)),
                 time_ms(lambda: spd._ns_gram_plain(G, w, 0, x0=X_cold, resid_only=True, want_v=True))))

    # NaN and garbage warm starts (the card's twin of tests/test_spd.py:195):
    # the kernel's residual for NaN must be NaN; the route must reject both
    # and land on the cold result
    x_nan = torch.full_like(X_cold, float("nan"))
    _, r_nan, _ = spd._ns_gram_cuda(G, w, 4, x0=x_nan)
    if torch.isfinite(r_nan.amax()):
        raise AssertionError(f"NaN warm start gave a finite residual {float(r_nan.amax())}")
    for name, bad in (("NaN", x_nan), ("garbage", torch.full_like(X_cold, 50.0))):
        before = dict(spd.FALLBACKS)
        Xr, vr = spd.inv_one_plus_gram(G, w, iters=16, warm=bad, warm_iters=4, want_v=True)
        if (spd.FALLBACKS["gram_probe_reject"] != before["gram_probe_reject"] + 1
                or spd.FALLBACKS["gram_refine_fail"] != before["gram_refine_fail"] + 1):
            raise AssertionError(f"{name} warm start did not reach the cold route")
        if not (torch.isfinite(Xr).all() and torch.isfinite(vr).all()):
            raise AssertionError(f"{name} warm start leaked into the route's result")
        if resid64(G, w, Xr) >= RESID_TOL:
            raise AssertionError(f"{name} warm start: route result misses the residual contract")

    # ill-conditioned (lambda ~ 1e4): the route's residual contract only
    w_ill = (w * 1e2).contiguous()
    lam_ill = lambda_max(G, w_ill)
    X_ill = spd.inv_one_plus_gram(G, w_ill, iters=16)
    r_ill = resid64(G, w_ill, X_ill)
    if not r_ill < RESID_TOL:
        raise AssertionError(f"ill-conditioned (lambda {lam_ill:.3g}): residual {r_ill}")
    log(f"ns_gram Z={Z} S={S} T={T} R={R}: lambda_max {lam:.3g}; "
        f"ill-conditioned lambda_max {lam_ill:.3g} residual (f64) {r_ill:.3g}")
    for mode, rk, err, ms, pms in rows:
        log(f"  {mode:8s} resid {rk:.3e}  |k-p| {err:.3e}  kernel {ms:8.3f} ms  "
            f"plain {pms:8.3f} ms")
    return worst, rows


def check_ns_packed(B, R, device, gen):
    from vlgp_tpu_torch.ops import spd

    # full-length Gram matrices as update_v builds them: Z*N = B systems
    Z = ZDIM
    N = B // Z
    G = realistic_factor(Z, LENGTH, R, device)
    w0 = torch.rand((Z, N, LENGTH), generator=gen, device=device, dtype=torch.float32)
    w = w0 * (1e2 / lambda_max(G, w0))
    A = torch.einsum("ztr,zst,ztq->zsrq", G, w, G).reshape(B, R, R).contiguous()
    A_warm = (A * 1.02).contiguous()
    rows, worst = [], 0.0

    def compare(mode, k, p):
        nonlocal worst
        torch.cuda.synchronize()
        rk = float(k[1].amax())
        if not rk < RESID_TOL:
            raise AssertionError(f"ns_packed {mode}: kernel residual {rk}")
        scale = float(p[0].abs().amax()) if p[0] is not None else 1.0
        err = float((k[0] - p[0]).abs().amax()) if k[0] is not None else \
            abs(rk - float(p[1].amax()))
        if not err <= AGREE_TOL * scale:
            raise AssertionError(f"ns_packed {mode}: |kernel - plain| {err} > {AGREE_TOL} * {scale}")
        worst = max(worst, err)
        return rk, err

    rk, err = compare("cold", spd._ns_packed_cuda(A, 16), spd._ns_packed_plain(A, 16))
    rows.append(("cold", rk, err, time_ms(lambda: spd._ns_packed_cuda(A, 16)),
                 time_ms(lambda: spd._ns_packed_plain(A, 16))))
    X_cold = spd._ns_packed_plain(A, 16)[0].contiguous()
    rk, err = compare("warm", spd._ns_packed_cuda(A_warm, 4, x0=X_cold),
                      spd._ns_packed_plain(A_warm, 4, x0=X_cold))
    rows.append(("warm", rk, err, time_ms(lambda: spd._ns_packed_cuda(A_warm, 4, x0=X_cold)),
                 time_ms(lambda: spd._ns_packed_plain(A_warm, 4, x0=X_cold))))
    pk = spd._ns_packed_cuda(A, 0, x0=X_cold, resid_only=True)
    if pk[0] is not None:
        raise AssertionError("probe wrote X")
    rk, err = compare("probe", pk, spd._ns_packed_plain(A, 0, x0=X_cold, resid_only=True))
    rows.append(("probe", rk, err,
                 time_ms(lambda: spd._ns_packed_cuda(A, 0, x0=X_cold, resid_only=True)),
                 time_ms(lambda: spd._ns_packed_plain(A, 0, x0=X_cold, resid_only=True))))
    _, r_nan = spd._ns_packed_cuda(A, 4, x0=torch.full_like(X_cold, float("nan")))
    if torch.isfinite(r_nan.amax()):
        raise AssertionError("ns_packed: NaN warm start gave a finite residual")
    # ill-conditioned (lambda ~ 1e4): the route's residual contract only
    A_ill = (A * 1e2).contiguous()
    X_ill = spd.inv_one_plus_psd(A_ill, iters=16)
    eye = torch.eye(R, dtype=torch.float64, device=device)
    r_ill = float(((A_ill.double() + eye) @ X_ill.double() - eye).abs().amax())
    if not r_ill < RESID_TOL:
        raise AssertionError(f"ns_packed route, ill-conditioned: residual {r_ill}")
    log(f"ns_packed B={B} R={R}: ill-conditioned (lambda ~1e4) residual (f64) {r_ill:.3g}")
    for mode, rk, err, ms, pms in rows:
        log(f"  {mode:8s} resid {rk:.3e}  |k-p| {err:.3e}  kernel {ms:8.3f} ms  "
            f"plain {pms:8.3f} ms")
    return worst, rows


def check_edge_shapes(device, gen):
    """Shapes off the main path that the wrappers accept: R from 1 to the
    128 limit (one register-array size each), T = 1, and iters = 0 with
    x0 (X = x0 written back); kernel against plain, both kernels."""
    from vlgp_tpu_torch.ops import spd

    worst = 0.0
    for Z, S, T, R in ((1, 3, 1, 1), (2, 5, 33, 8), (1, 7, 150, 100), (1, 9, 300, 128)):
        G = (torch.randn((Z, T, R), generator=gen, device=device) * 0.3).contiguous()
        w0 = torch.rand((Z, S, T), generator=gen, device=device)
        w = (w0 * (1e2 / max(lambda_max(G, w0), 1.0))).contiguous()
        A = torch.einsum("ztr,zst,ztq->zsrq", G, w, G).reshape(Z * S, R, R).contiguous()
        runs = [("gram cold+v", spd._ns_gram_cuda(G, w, 16, want_v=True),
                 spd._ns_gram_plain(G, w, 16, want_v=True)),
                ("packed cold", spd._ns_packed_cuda(A, 16), spd._ns_packed_plain(A, 16))]
        x0 = runs[1][2][0].reshape(Z, S, R, R).contiguous()
        runs.append(("gram iters=0", spd._ns_gram_cuda(G, w, 0, x0=x0, want_v=True),
                     spd._ns_gram_plain(G, w, 0, x0=x0, want_v=True)))
        torch.cuda.synchronize()
        for mode, k, p in runs:
            rk = float(k[1].amax())
            scale = float(p[0].abs().amax())
            errs = [float((a - b).abs().amax()) for a, b in zip(k, p)
                    if a is not None and a.shape == b.shape and a.ndim > 1]
            err = max(errs)
            if not (rk < RESID_TOL and err <= AGREE_TOL * scale):
                raise AssertionError(f"{mode} at Z={Z} S={S} T={T} R={R}: residual {rk}, "
                                     f"|kernel - plain| {err} (max|X| {scale})")
            worst = max(worst, err)
        if not torch.equal(runs[2][1][0], x0):
            raise AssertionError(f"iters=0 did not write x0 back at R={R}")
    log(f"edge shapes (R = 1, 8, 100, 128; T = 1..300): max |kernel - plain| {worst:.3e}")
    return worst


def make_workload():
    """bench.py's flagship workload (seed 0)."""
    rng = np.random.default_rng(0)
    a = (rng.normal(size=(ZDIM, YDIM)) * 0.3).astype(np.float32)
    trials, zs = [], []
    for _ in range(NTRIAL):
        z = np.stack([np.sin(np.linspace(0, 20 + 3 * i, LENGTH)) for i in range(ZDIM)], 1)
        y = rng.poisson(np.exp(z @ a - 2.0)).astype(np.float32)
        trials.append({"y": y, "mu": (rng.normal(size=(LENGTH, ZDIM)) * 0.1).astype(np.float32)})
        zs.append(z)
    return trials, a, np.concatenate(zs)


def r2_aligned(mu, zt):
    X = np.column_stack([mu, np.ones(len(mu))])
    beta, *_ = np.linalg.lstsq(X, zt, rcond=None)
    return float(1 - np.sum((X @ beta - zt) ** 2) / np.sum((zt - zt.mean(0)) ** 2))


def check_small_fit_against_cpu():
    """The card's float32 fit (kernels) against the CPU's float64 fit (exact
    Cholesky route, the reference semantics) on a 4 x 120 x 10 x 2 input."""
    import vlgp_tpu_torch

    rng = np.random.default_rng(7)
    a = rng.normal(size=(2, 10)) * 0.5
    trials, zs = [], []
    for _ in range(4):
        z = np.column_stack((np.sin(np.linspace(0, 6, 120)), np.cos(np.linspace(0, 6, 120))))
        trials.append({"y": rng.poisson(np.exp(z @ a - 1.5)).astype(float),
                       "mu": rng.normal(size=(120, 2)) * 0.1})
        zs.append(z)
    zt = np.concatenate(zs)
    kw = dict(a=a, b=np.full((1, 10), -1.5), noise=np.ones(10), max_iter=10)
    gpu = vlgp_tpu_torch.fit(trials, 2, device="cuda", dtype="float32", **kw)
    cpu = vlgp_tpu_torch.fit(trials, 2, device="cpu", dtype="float64", **kw)
    mu_g = gpu.data.mu.cpu().double().numpy()
    mu_c = cpu.data.mu.numpy()
    rel = float(np.abs(mu_g - mu_c).max() / np.abs(mu_c).max())
    r2_g = r2_aligned(mu_g.reshape(-1, 2), zt)
    r2_c = r2_aligned(mu_c.reshape(-1, 2), zt)
    log(f"small fit: card f32 vs CPU f64: max|dmu|/max|mu| {rel:.3e}, "
        f"R^2 {r2_g:.4f} vs {r2_c:.4f}")
    # float32 Newton-Schulz rides its 1e-2 residual contract across ten EM
    # iterations (the CPU's plain versions land 3.4e-2 from float64 here),
    # so the posterior is held to 1e-1 and the recovery to 0.01
    if not (np.isfinite(mu_g).all() and rel < 1e-1 and abs(r2_g - r2_c) < 0.01):
        raise AssertionError("small fit on the card disagrees with the CPU float64 fit")


def run_fit():
    import vlgp_tpu_torch
    from vlgp_tpu_torch.ops import spd

    trials, a, zt = make_workload()
    spd.reset_counters()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    result = vlgp_tpu_torch.fit(trials, ZDIM, a=a, b=np.full((1, YDIM), -2.0),
                                omega=np.full(ZDIM, 1e-2), max_iter=30)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    launches = dict(spd.KERNEL_LAUNCHES)
    fallbacks = dict(spd.FALLBACKS)
    calls = dict(spd.ROUTE_CALLS)

    d = result.data
    for name in ("mu", "v", "w"):
        t = getattr(d, name)
        if t.device.type != "cuda":
            raise AssertionError(f"posterior {name} is on {t.device}, not the card")
        if not torch.isfinite(t).all():
            raise AssertionError(f"posterior {name} has non-finite values")
    if tuple(d.mu.shape) != (NTRIAL, LENGTH, ZDIM):
        raise AssertionError(f"posterior mu has shape {tuple(d.mu.shape)}")
    r2 = r2_aligned(d.mu.cpu().numpy().reshape(-1, ZDIM), zt)
    rt = result.runtime
    log(f"fit: {wall:.2f} s wall, {rt['it']} EM iterations "
        f"(converged_at {rt.get('converged_at')}), final_hstep {rt.get('final_hstep', False)}")
    log(f"fit: E {sum(rt['e_elapsed']):.2f} s, M {sum(rt['m_elapsed']):.2f} s, "
        f"H {sum(rt['h_elapsed']):.2f} s over the EM loop")
    log(f"fit: recovery R^2 (lstsq-aligned) {r2:.4f}; reached 0.95: {r2 >= 0.95}")
    log(f"fit: omega {result.params.omega.cpu().numpy()}, sigma {result.params.sigma.cpu().numpy()}")
    log(f"fit: kernel launches {launches}")
    log(f"fit: route calls {calls}")
    log(f"fit: fallback counters {fallbacks}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"the fit never launched {name}")
    if r2 < R2_MIN:
        raise AssertionError(f"recovery R^2 {r2:.4f} < {R2_MIN}")
    if fallbacks["gram_exact"] > EXACT_SHARE_MAX * calls["gram"]:
        raise AssertionError(f"exact-Cholesky net took {fallbacks['gram_exact']} of "
                             f"{calls['gram']} ns_gram route calls")
    return launches


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    # plain versions multiply in full float32 (no TF32), like the kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from vlgp_tpu_torch.ops import _build

    tic = time.perf_counter()
    _build.load_library()
    log(f"build: {time.perf_counter() - tic:.1f} s (nvcc {_build.BUILD_SECONDS:.1f} s)")

    device = torch.device("cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    g_err_a, g_rows = check_ns_gram(ZDIM, 2000, 50, 40, device, gen)
    g_err_b, _ = check_ns_gram(ZDIM, 100, 1000, 50, device, gen)
    p_err, p_rows = check_ns_packed(ZDIM * NTRIAL, 50, device, gen)
    e_err = check_edge_shapes(device, gen)

    check_small_fit_against_cpu()
    launches = run_fit()

    g_cold = next(r for r in g_rows if r[0] == "cold")
    p_cold = next(r for r in p_rows if r[0] == "cold")
    kernels = [
        {"name": "ns_gram", "route": "cuda", "source": "vlgp_tpu_torch/csrc/ns_inverse.cu",
         "replaces": "vlgp_tpu/ops/spd.py:796", "launches": launches["ns_gram"],
         "max_abs_err": max(g_err_a, g_err_b, e_err), "ms": g_cold[3], "plain_ms": g_cold[4]},
        {"name": "ns_packed", "route": "cuda", "source": "vlgp_tpu_torch/csrc/ns_inverse.cu",
         "replaces": "vlgp_tpu/ops/spd.py:558", "launches": launches["ns_packed"],
         "max_abs_err": max(p_err, e_err), "ms": p_cold[3], "plain_ms": p_cold[4]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
