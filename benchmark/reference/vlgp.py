"""Plain reference of a vLGP fit's stages: the prior factors, the E-step's
Newton sweeps, the Poisson M-step, the H-step's search on log(omega), the
segmentation and the final full-trial inference, and the held-out scores of
leave-one-neuron-out.

Written in plain torch from the model's equations (Zhao and Park, "Variational
latent Gaussian process for recovering single-trial dynamics from population
spike trains", Neural Computation 2017) and the published upstream code
(github.com/catniplab/vlgp: core.py, gp.py, math.py, util.py), in the order of
operations that the program under test states for its algorithm: the same
exits, clips and search schedule.  It differs from the program where the
program approximates: every (I + G'WG)^-1 is an exact Cholesky inverse, and
the H-step's pooled posterior statistic is summed from dense per-segment
posterior covariances.  It runs in any floating dtype; the benchmark runs it
in float64 and, as the control, in float32 with TF32 products.

The prior factor of a long trial is a greedy-pivoted incomplete Cholesky,
whose pivots break exact ties of the kernel's symmetric grid by rounding.
``_ichol_pivots`` is therefore a frozen copy of that pivot search in the program's
own precision and on the program's device, so that both sides approximate the
kernel on the same landmarks; the factor itself is then formed in the working
dtype from those landmarks (a pivoted partial Cholesky is the Nystrom factor
of its pivots).
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "factor", "effective_rank", "cut", "scatter", "inv_gram", "marginal_v",
    "weights", "estep", "mstep", "hstep", "gp_elbo", "constrain_fro", "lono_scores",
]

PHI = 0.6180339887498949


def trunc_exp(x, bound: float = 10.0):
    """exp with the argument clipped from above (upstream math.py)."""
    return torch.exp(torch.clamp(x, max=bound))


# ---------------------------------------------------------------------------
# prior factors
# ---------------------------------------------------------------------------


def _ichol_pivots(n: int, omega: torch.Tensor, rank: int, dt: float, tol: float = 1e-10):
    """Greedy-pivoted incomplete Cholesky of exp(-omega (i - j)^2 dt^2) on an
    n-point grid, in omega's dtype and on its device: (the row order (Z, n),
    the first ``rank`` being the pivots; alive (Z, rank) bool; G (Z, n, rank)
    in that row order)."""
    dtype, device = omega.dtype, omega.device
    Z = omega.shape[0]
    x = torch.arange(n, dtype=dtype, device=device) * dt
    rows = torch.arange(n, device=device)
    cols = torch.arange(rank, device=device)
    G = torch.zeros((Z, n, rank), dtype=dtype, device=device)
    d = torch.ones((Z, n), dtype=dtype, device=device)
    pvec = rows.expand(Z, n).clone()
    zero = torch.zeros((), dtype=dtype, device=device)
    neg_inf = torch.full((), -float("inf"), dtype=dtype, device=device)
    for i in range(min(rank, n)):
        jast = torch.argmax(torch.where(rows >= i, d, neg_inf), dim=1)
        perm = rows.expand(Z, n).clone()
        perm.scatter_(1, jast[:, None], i)
        perm[:, i] = jast
        pvec = torch.gather(pvec, 1, perm)
        d = torch.gather(d, 1, perm)
        G = torch.gather(G, 1, perm[:, :, None].expand(Z, n, rank))
        di = d[:, i]
        alive = di > tol
        gii = torch.sqrt(torch.clamp(di, min=tol))
        G[:, i, i] = torch.where(alive, gii, zero)
        xp = x[pvec]
        nextcol = torch.exp(-omega[:, None] * (xp - xp[:, i:i + 1]) ** 2)
        prev = torch.where(cols < i, G[:, i, :], zero)
        proj = torch.einsum("znr,zr->zn", G, prev)
        newcol = torch.where(alive[:, None], (nextcol - proj) / gii[:, None], zero)
        below = rows > i
        G[:, :, i] = torch.where(below, newcol, G[:, :, i])
        dnew = 1.0 - torch.sum(G[:, :, : i + 1] ** 2, dim=2)
        d = torch.where(below, dnew, d)
    k = min(rank, n)
    alive = torch.diagonal(G[:, :k, :k], dim1=1, dim2=2) > 0
    return pvec, alive, G


def _landmark_factor(n: int, omega: torch.Tensor, landmarks, dt: float, jitter: float,
                     dtype) -> torch.Tensor:
    """G (Z, n, R) with G G' = K[:, J] (K[J, J] + jitter I)^-1 K[J, :] for each
    latent's landmarks J (R,) or (Z, R), formed in float64 and returned in
    ``dtype`` (a table of the prior, rounded once to the working precision)."""
    device = omega.device
    out_dtype, dtype = dtype, torch.float64
    om = omega.to(dtype)[:, None, None]
    x = torch.arange(n, dtype=dtype, device=device) * dt
    J = torch.as_tensor(landmarks, device=device)
    if J.ndim == 1:
        J = J.expand(omega.shape[0], -1)
    xJ = x[J]  # (Z, R)
    K_nJ = torch.exp(-om * (x[None, :, None] - xJ[:, None, :]) ** 2)
    K_JJ = torch.exp(-om * (xJ[:, :, None] - xJ[:, None, :]) ** 2)
    eye = torch.eye(J.shape[1], dtype=dtype, device=device)
    L = torch.linalg.cholesky(K_JJ + jitter * eye)
    return torch.linalg.solve_triangular(L.mT, K_nJ, upper=True, left=False).to(out_dtype)


def factor(T: int, omega: torch.Tensor, sigma: torch.Tensor, rank: int, dt: float,
           program_dtype: torch.dtype, dtype: torch.dtype) -> torch.Tensor:
    """Low-rank prior factor (Z, T, rank) with (sigma G)(sigma G)' ~ the SE
    kernel sigma^2 exp(-omega (t - s)^2), by the program's stated rule:
    evenly spaced landmarks with a 2e-5 jitter where the program runs float32
    and rank >= 0.6 T (window segments), else the greedy pivots of the
    incomplete Cholesky (found in ``program_dtype`` on omega's device from
    omega as the program holds it)."""
    rank = min(rank, T)
    device = omega.device
    even = torch.zeros(omega.shape[0], dtype=torch.bool, device=device)
    if program_dtype == torch.float32 and rank >= 0.6 * T:
        J = (torch.arange(rank, device=device) * T) // rank
        # a latent whose landmark Cholesky fails in the program's precision
        # takes the pivoted factor instead, as the program states
        even = _landmarks_hold(T, omega.to(program_dtype), J, dt, 2e-5)
        G = _landmark_factor(T, omega, J, dt, 2e-5, dtype) if bool(even.any()) else None
        if bool(even.all()):
            return G * sigma.to(dtype)[:, None, None]
    piv, alive, Gp = _ichol_pivots(T, omega.to(program_dtype), rank, dt)
    out = torch.zeros((omega.shape[0], T, rank), dtype=dtype, device=device)
    for z in range(omega.shape[0]):
        if bool(even[z]):
            out[z] = G[z]
            continue
        Jz = piv[z, :rank][alive[z]]  # exhausted pivots add zero columns
        try:
            out[z, :, :Jz.shape[0]] = _landmark_factor(T, omega[z:z + 1], Jz, dt, 0.0, dtype)[0]
        except torch.linalg.LinAlgError:
            # pivots past the kernel's numerical rank in the program's
            # precision make their float64 Gram singular: the factor is then
            # the program-precision recursion's own, rows back in grid order
            out[z, piv[z]] = Gp[z].to(dtype)
    return out * sigma.to(dtype)[:, None, None]


def _landmarks_hold(n: int, omega: torch.Tensor, J, dt: float, jitter: float) -> torch.Tensor:
    """(Z,) bool: the landmark factor exists and is finite in omega's dtype."""
    x = torch.arange(n, dtype=omega.dtype, device=omega.device) * dt
    xJ = x[J]
    om = omega[:, None, None]
    K_nJ = torch.exp(-om * (x[:, None] - xJ[None, :]) ** 2)
    K_JJ = torch.exp(-om * (xJ[:, None] - xJ[None, :]) ** 2)
    eye = torch.eye(len(J), dtype=omega.dtype, device=omega.device)
    L, info = torch.linalg.cholesky_ex(K_JJ + jitter * eye)
    G = torch.linalg.solve_triangular(L.mT, K_nJ, upper=True, left=False)
    return torch.isfinite(G).all(dim=(1, 2)) & (info == 0)


def effective_rank(T: int, omega_hi: float, dt: float = 1.0, margin: int = 4,
                   tol: float = 1e-7) -> int:
    """The segment factor's rank as the program states it: the non-zero
    columns of a float32 pivoted incomplete Cholesky at the sharpest omega on
    min(T, 128) columns, plus ``margin``, up to a multiple of 8 (T when the
    probe saturates)."""
    probe = min(T, 128)
    _, _, G = _ichol_pivots(T, torch.tensor([omega_hi], dtype=torch.float32), probe, dt)
    nz = int((G[0].abs().amax(dim=0) > tol).sum())
    if nz >= probe:
        return T
    return max(8, min(T, -(-(nz + margin) // 8) * 8))


# ---------------------------------------------------------------------------
# segmentation
# ---------------------------------------------------------------------------


def cut(lengths: np.ndarray, window, seed: int):
    """Segments of window bins with randomized overlap (upstream util.py
    cut_trials): (trial index (S,), start (S,)) drawn from
    ``np.random.default_rng(seed)``; whole trials when ``window`` is None."""
    n = len(lengths)
    if not window:
        return np.arange(n), np.zeros(n, np.int64)
    rng = np.random.default_rng(seed)
    idxs, starts = [], []
    for i in range(n):
        L = int(lengths[i])
        nseg = max(1, -(-L // window))
        overlap = nseg * window - L
        start = np.cumsum(np.full(nseg, window, np.int64)) - window
        if nseg > 1 and overlap > 0:
            offset = np.cumsum(np.append([0], rng.multinomial(overlap,
                                                              np.ones(nseg - 1) / (nseg - 1))))
            start = start - offset
        idxs.extend([i] * nseg)
        starts.extend(np.maximum(start, 0).tolist())
    return np.asarray(idxs), np.asarray(starts)


def gather(full: torch.Tensor, idx, start, window: int) -> torch.Tensor:
    """Rows of ``full`` (N, T, ...) cut to segments (S, window, ...); all
    trials are whole, so every segment lies inside its trial."""
    t = torch.as_tensor(np.asarray(start)[:, None] + np.arange(window)[None], device=full.device)
    i = torch.as_tensor(np.asarray(idx), device=full.device)[:, None]
    return full[i, t]


def scatter(full: torch.Tensor, seg: torch.Tensor, idx, start) -> torch.Tensor:
    """Segments written back into their trials, the last segment winning
    where two overlap."""
    out = full.clone()
    window = seg.shape[1]
    for k in range(len(idx)):  # in order: later segments overwrite earlier
        out[int(idx[k]), int(start[k]):int(start[k]) + window] = seg[k]
    return out


# ---------------------------------------------------------------------------
# E-step
# ---------------------------------------------------------------------------


def inv_gram(G: torch.Tensor, wz: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """X = (I + G' diag(w) G)^-1 (Z, S, R, R) by Cholesky, for G (Z, T, R)
    and w (Z, S, T)."""
    out = []
    R = G.shape[-1]
    eye = torch.eye(R, dtype=G.dtype, device=G.device)
    for s0 in range(0, wz.shape[1], chunk):
        w = wz[:, s0:s0 + chunk]
        A = torch.einsum("ztr,zst,ztq->zsrq", G, w, G)
        out.append(torch.cholesky_inverse(torch.linalg.cholesky(eye + A)))
    return torch.cat(out, dim=1)


def marginal_v(G: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """v = diag(G X G') (Z, S, T)."""
    return torch.einsum("ztr,zsrq,ztq->zst", G, X, G)


def _eta(muz, a, xb, members: int = 1):
    eta = torch.einsum("zst,zy->sty", muz, a)
    if members > 1:
        return eta.reshape((members,) + tuple(xb.shape)) + xb
    return eta + xb


def _rates(eta, vz, a, members: int = 1):
    q = torch.einsum("zst,zy->sty", vz, 0.5 * a * a)
    if members > 1:
        q = q.reshape(eta.shape)
    return trunc_exp(eta + q)


def weights(muz, vz, a, xb, poisson, noise, maskz, cm=None):
    """Likelihood precision weights (Z, B S, T) (upstream core.py): the rates
    (Poisson) or 1 / noise (Gaussian), times a^2, summed over channels."""
    B = 1 if cm is None else cm.shape[0]
    r = _rates(_eta(muz, a, xb, B), vz, a, B)
    U = torch.where(poisson, r, 1.0 / torch.clamp(noise, min=1e-30))
    if cm is not None:
        U = U * cm[:, None, None, :]
    return torch.einsum("sty,zy->zst", U.reshape(-1, *U.shape[-2:]), a * a) * maskz


def _project(y, xb, mask, a, muz, vz, poisson, noise, cm=None):
    """s = (masked working residual) a' (Z, B S, T)."""
    B = 1 if cm is None else cm.shape[0]
    eta = _eta(muz, a, xb, B)
    r = _rates(eta, vz, a, B)
    resid = torch.where(poisson, y - r, (y - eta) / torch.clamp(noise, min=1e-30))
    resid = resid * mask[..., None]
    if cm is not None:
        resid = resid * cm[:, None, None, :]
    return torch.einsum("sty,zy->zst", resid.reshape(-1, *resid.shape[-2:]), a)


def _step(G, s, muz, wz, X, maskz, bound):
    """The Newton step by Woodbury at the carried weights, clipped and
    masked: delta = u - G X G'(w u), u = G G' s - mu (upstream core.py)."""
    u = torch.einsum("ztr,zsr->zst", G, torch.einsum("ztr,zst->zsr", G, s)) - muz
    M = torch.einsum("zsrq,zsq->zsr", X, torch.einsum("ztr,zst->zsr", G, wz * maskz * u))
    delta = u - torch.einsum("ztr,zsr->zst", G, M)
    return torch.clamp(delta, -bound, bound) * maskz


def estep(y, xb, mask, a, poisson, noise, G, state, cfg, niter: int, cm=None, sweeps=None,
          extra: int = 0, each=None):
    """Up to ``niter`` Newton sweeps of the VB posterior (mu, w, v, dmu), each
    latent-major (Z, B S, T); with ``cfg["estep_tol"] > 0`` a member exits
    once |dmu|^2 <= tol^2 |mu|^2 after at least 2 sweeps.  ``cm`` (B, Y):
    B problems on the same segments, member b weighting channel y by cm[b, y].
    ``sweeps`` (B,), when given, replaces the exit test: member b runs
    exactly sweeps[b].  ``extra``: each member runs that many sweeps past its
    exit (within ``niter``).  ``each``, a callable, receives the state after
    every sweep.  Returns the state and each member's sweeps at its exit
    (B,)."""
    B = 1 if cm is None else cm.shape[0]
    maskz = (mask if B == 1 else mask.repeat(B, 1))[None]
    muz, wz, vz, dmuz = state
    wz = wz * maskz
    X = inv_gram(G, wz)
    tol = cfg["estep_tol"]
    fixed = None if sweeps is None else torch.as_tensor(sweeps, device=y.device).reshape(B)
    ran = torch.zeros(B, dtype=torch.int64, device=y.device)
    stop = torch.full((B,), -1, dtype=torch.int64, device=y.device)  # sweeps at the exit

    def per_member(t):
        t = t.reshape(t.shape[0], B, -1)
        return torch.sum(t * t, dim=(0, 2))

    for i in range(niter):
        if fixed is not None:
            alive = fixed > i
        else:
            if tol > 0 and i >= 2:
                done = (stop < 0) & ~(per_member(dmuz) > tol * tol * per_member(muz))
                stop = torch.where(done, ran, stop)
            alive = (stop < 0) | (ran < stop + extra)
        if not bool(alive.any()):
            break
        s = _project(y, xb, mask, a, muz, vz, poisson, noise, cm)
        delta = _step(G, s, muz, wz, X, maskz, cfg["dmu_bound"])
        mu_new = muz + delta
        w_new = weights(mu_new, vz, a, xb, poisson, noise, maskz, cm)
        X_new = inv_gram(G, w_new)
        v_new = marginal_v(G, X_new) * maskz
        keep = alive.repeat_interleave(mask.shape[0])  # (B S,), member-major

        def pick(new, old):
            return torch.where(keep.reshape((1, -1) + (1,) * (new.ndim - 2)), new, old)

        muz, wz, vz, dmuz = (pick(mu_new, muz), pick(w_new, wz), pick(v_new, vz),
                             pick(delta, dmuz))
        X = pick(X_new, X)
        ran = ran + alive
        if each is not None:
            each((muz, wz, vz, dmuz))
    return (muz, wz, vz, dmuz), (ran if fixed is not None else torch.where(stop < 0, ran, stop))


# ---------------------------------------------------------------------------
# M-step (Poisson channels)
# ---------------------------------------------------------------------------


def _pair(rm, p, q):
    return torch.einsum("sty,zst,kst->yzk", rm, p, q)


def mstep(y, x, mask, muz, vz, a, b, noise, da, db, cfg):
    """Newton iterations on the Poisson loading and bias (upstream core.py
    M-step with its Hessian), each step clipped; with ``cfg["mstep_tol"] >
    0`` it stops once |da| <= tol |a| and |db| <= tol |b| after at least 2
    iterations.  Returns (a, b, noise, da, db)."""
    m = mask[..., None]
    maskz = mask[None]
    n = torch.sum(mask)
    Z, X = a.shape[0], b.shape[0]
    Iz = torch.eye(Z, dtype=a.dtype, device=a.device)
    Ix = torch.eye(X, dtype=a.dtype, device=a.device)
    eps, tol = cfg["eps"], cfg["mstep_tol"]
    mum, vm = muz * maskz, vz * maskz
    norms = torch.zeros(4, dtype=a.dtype, device=a.device)
    for i in range(cfg["Mniter"]):
        if tol > 0 and i >= 2:
            if not bool((norms[0] > tol * tol * norms[1]) | (norms[2] > tol * tol * norms[3])):
                break
        eta = torch.einsum("zst,zy->sty", muz, a) + torch.einsum("stxy,xy->sty", x, b)
        resid = y - eta
        s1 = torch.sum(resid * m, dim=(0, 1))
        s2 = torch.sum(resid * resid * m, dim=(0, 1))
        r = trunc_exp(eta + torch.einsum("zst,zy->sty", vz, 0.5 * a * a))
        rm = r * m
        C1 = torch.einsum("zst,sty->zy", mum, y - r)
        C2 = torch.einsum("zst,sty->zy", vm, r)
        grad_b = torch.einsum("stxy,sty->xy", x, y * m - rm)
        E1, E2, E3 = _pair(rm, muz, muz), _pair(rm, vz, muz), _pair(rm, vz, vz)
        nhess_b = torch.einsum("stxy,sty,stqy->yxq", x, rm, x)
        mean = s1 / n
        noise = s2 / n - mean * mean
        grad_a = C1 - a * C2
        an = a.T
        nhess = (E1 + an[:, :, None] * E2 + an[:, None, :] * E2.transpose(1, 2)
                 + an[:, :, None] * an[:, None, :] * E3 + C2.T[:, :, None] * Iz)
        da = torch.linalg.solve(nhess + eps * Iz, grad_a.T[..., None])[..., 0].T
        db = torch.linalg.solve(nhess_b + eps * Ix, grad_b.T[..., None])[..., 0].T
        da = torch.clamp(da, -cfg["da_bound"], cfg["da_bound"])
        db = torch.clamp(db, -cfg["db_bound"], cfg["db_bound"])
        a, b = a + da, b + db
        norms = torch.stack([torch.sum(da * da), torch.sum(a * a), torch.sum(db * db),
                             torch.sum(b * b)])
    return a, b, noise, da, db


def constrain_fro(muz, a, eps: float):
    """Unit Frobenius norm of the loading, the latents compensating."""
    s = torch.sqrt(torch.sum(a * a)) + eps
    return muz * s, a / s


# ---------------------------------------------------------------------------
# H-step
# ---------------------------------------------------------------------------


def gp_elbo(log_omega, C, nseg, T: int, sigsq, gp_noise: float, dt: float, profile: bool):
    """The GP prior's expected log density of the pooled statistic C:
    -tr(K^-1 C) / 2 - nseg log|chol K| for K = amp exp(-omega D^2) +
    gp_noise I; with ``profile`` the amplitude takes its closed-form optimum
    clip(tr(K0^-1 C) / (nseg T), 1e-2, 1e2), returned beside it."""
    om = torch.exp(log_omega)[..., None, None]
    t = torch.arange(T, dtype=C.dtype, device=C.device) * dt
    dsq = (t[:, None] - t[None, :]) ** 2
    amp = 1.0 if profile else sigsq
    K = amp * torch.exp(-om * dsq) + gp_noise * torch.eye(T, dtype=C.dtype, device=C.device)
    L, info = torch.linalg.cholesky_ex(K)
    L = torch.where((info > 0)[..., None, None], torch.nan, L)
    half = torch.linalg.solve_triangular(L, C.expand(K.shape), upper=False)
    KinvC = torch.linalg.solve_triangular(L.mT, half, upper=True)
    logdet = torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    tr = torch.diagonal(KinvC, dim1=-2, dim2=-1).sum(-1)
    if not profile:
        return -0.5 * tr - nseg * logdet
    s = torch.clamp(tr / (nseg * T), 1e-2, 1e2)
    return -0.5 * tr / s - nseg * (0.5 * T * torch.log(s) + logdet), s


def golden_min(f, lo, hi, iters: int, grid: int, tiebreak: float):
    """A grid scan that keeps the first candidate within ``tiebreak`` of the
    best and brackets it by its neighbours, then ``iters`` golden-section
    shrinks; the bracket's middle.  f maps (..., Z) to (..., Z)."""
    if grid >= 3:
        frac = torch.arange(grid, dtype=lo.dtype, device=lo.device) / (grid - 1)
        cand = lo[None] + frac[:, None] * (hi - lo)[None]
        fcand = f(cand)
        bad = torch.isnan(fcand)
        fcand = torch.where(bad, torch.inf, fcand)
        fmin = fcand.amin(dim=0)
        best = torch.argmax((fcand <= fmin + tiebreak * fmin.abs()).to(torch.int8), dim=0)
        lo_idx = torch.clamp(best - 1, min=0)
        lo_idx = torch.where(bad.gather(0, lo_idx[None])[0], best, lo_idx)
        hi_idx = torch.clamp(best + 1, max=grid - 1)
        hi_idx = torch.where(bad.gather(0, hi_idx[None])[0], best, hi_idx)
        allbad = bad.all(dim=0)
        lo_b = cand.gather(0, lo_idx[None])[0]
        hi_b = cand.gather(0, hi_idx[None])[0]
        lo, hi = torch.where(allbad, lo, lo_b), torch.where(allbad, lo, hi_b)
    c = hi - PHI * (hi - lo)
    d = lo + PHI * (hi - lo)
    fc, fd = f(c), f(d)
    for _ in range(iters):
        left = fc < fd
        lo_n = torch.where(left, lo, c)
        hi_n = torch.where(left, d, hi)
        c_n = torch.where(left, hi_n - PHI * (hi_n - lo_n), d)
        d_n = torch.where(left, c, lo_n + PHI * (hi_n - lo_n))
        f_new = f(torch.where(left, c_n, d_n))
        fc, fd = torch.where(left, f_new, fd), torch.where(left, fc, f_new)
        lo, hi, c, d = lo_n, hi_n, c_n, d_n
    return 0.5 * (lo + hi)


def posterior_cov_sum(G, wz, valid, gp_noise: float):
    """sum_s valid_s (K^-1 + diag(w_s))^-1 (Z, T, T) for the prior K = G G' +
    gp_noise I, as K - K W^1/2 (I + W^1/2 K W^1/2)^-1 W^1/2 K per segment."""
    Z, T, _ = G.shape
    chunk = max(1, int(4e7) // (Z * T * T))  # ~0.3 GB a (Z, chunk, T, T) float64 block
    eye = torch.eye(T, dtype=G.dtype, device=G.device)
    K = G @ G.mT + gp_noise * eye  # (Z, T, T)
    total = torch.zeros_like(K)
    for s0 in range(0, wz.shape[1], chunk):
        h = torch.sqrt(wz[:, s0:s0 + chunk])  # (Z, c, T)
        KH = K[:, None] * h[:, :, None, :]  # K W^1/2
        M = eye + h[..., :, None] * KH  # I + W^1/2 K W^1/2
        L = torch.linalg.cholesky(M)
        HK = KH.mT  # W^1/2 K
        Sig = K[:, None] - KH @ torch.cholesky_solve(HK, L)
        total = total + torch.einsum("s,zstu->ztu", valid[s0:s0 + chunk], Sig)
    return total


def hstep(muz, wz, mask, omega, sigma, cfg, rank: int, program_dtype, stat: bool = False):
    """The hyperparameter step: per latent, two fixed-point refinements of a
    bounded search of log(omega) over the pooled statistic C = sum_s mu_s
    mu_s' + Sigma_s at the running omega, an Aitken extrapolation accepted
    only on a contraction (capped at ``hyper_trust`` times the last move),
    at-bound rejection, then the amplitude's profile optimum.  mu and w are
    latent-major (Z, S, T).  Returns (omega, sigma), and with ``stat`` the
    last refinement's statistic C (Z, T, T) and the segment count beside
    them."""
    dtype = muz.dtype
    Z, S, T = muz.shape
    lo = torch.full((Z,), math.log(cfg["omega_bound"][0]), dtype=dtype, device=muz.device)
    hi = torch.full((Z,), math.log(cfg["omega_bound"][1]), dtype=dtype, device=muz.device)
    valid = mask.amax(dim=1).to(dtype)
    margin = 2e-3 * (hi - lo)
    eps = cfg["gp_noise"]
    w = wz * mask[None]
    nseg = valid.sum()
    Mbar = torch.einsum("zst,zsu->ztu", muz, muz)
    sigsq = (sigma ** 2).reshape(Z, 1, 1)

    def F(log_om):
        G = factor(T, torch.exp(log_om), sigma, rank, cfg["dt"], program_dtype, dtype)
        C = Mbar + posterior_cov_sum(G, w, valid, eps)

        def obj(x):
            ll, _ = gp_elbo(x, C, nseg, T, sigsq, eps, cfg["dt"], True) \
                if cfg["hyper_learn_sigma"] else (gp_elbo(x, C, nseg, T, sigsq, eps, cfg["dt"],
                                                          False), None)
            return -ll

        return golden_min(obj, lo, hi, cfg["hyper_iters"], cfg["hyper_grid"],
                          cfg["hyper_tiebreak"]), C

    x0 = torch.log(omega.to(program_dtype)).to(dtype)
    x1, _ = F(x0.to(program_dtype) if program_dtype != dtype else x0)
    x2, C2 = F(x1)
    trust = cfg["hyper_trust"]
    d1, d2 = x1 - x0, x2 - x1
    denom = d2 - d1
    safe = denom.abs() > 1e-12
    ait = x2 - torch.where(safe, d2 * d2 / torch.where(safe, denom, 1.0), 0.0)
    if trust > 0:
        cap = trust * d2.abs()
        ait = x2 + torch.clamp(ait - x2, -cap, cap)
    contracting = (d1 * d2 > 0) & (d2.abs() < d1.abs())
    x_star = torch.clamp(torch.where(contracting, ait, x2), lo + margin, hi - margin)
    span = hi - lo
    at_bound = ((x_star - lo).abs() < 1e-3 * span) | ((x_star - hi).abs() < 1e-3 * span)
    omega_new = torch.where(at_bound, omega.to(dtype), torch.exp(x_star))
    sigma_new = sigma.to(dtype)
    if cfg["hyper_learn_sigma"]:
        _, s = gp_elbo(torch.log(omega_new), C2, nseg, T, sigsq, eps, cfg["dt"], True)
        sigma_new = torch.sqrt(s)
    return (omega_new, sigma_new, C2, nseg) if stat else (omega_new, sigma_new)


# ---------------------------------------------------------------------------
# leave-one-neuron-out
# ---------------------------------------------------------------------------


def lono_scores(y, xb, mask, a, poisson, noise, G, neurons, cfg, niter: int,
                members: int = 10, extra: int = 0):
    """Each held-out neuron's mean predictive Poisson log-likelihood per bin
    (up to the log y! constant): the posterior inferred from a zero start on
    the other channels (its weights and variance first, then up to ``niter``
    sweeps with the member's own exit, and ``extra`` sweeps past it), the
    neuron's rate predicted from it under the model's loading and regressor
    term ``xb`` = x b (S, T, Y).  Returns {neuron: [score after j sweeps, j =
    0, 1, ...]} and {neuron: sweeps at its exit}."""
    S, T, Y = y.shape
    Z = a.shape[0]
    nvalid = torch.clamp(torch.sum(mask), min=1.0)
    scores, ran = {}, {}
    for k in range(0, len(neurons), members):
        chunk = neurons[k:k + members]
        B = len(chunk)
        idx = torch.tensor(chunk, device=y.device)
        cm = (torch.arange(Y, device=y.device)[None] != idx[:, None]).to(a.dtype)
        maskz = mask.repeat(B, 1)[None]
        zeros = y.new_zeros((Z, B * S, T))
        wz = weights(zeros, zeros, a, xb, poisson, noise, maskz, cm)
        vz = marginal_v(G, inv_gram(G, wz)) * maskz
        y_n = y[..., idx].permute(2, 0, 1)
        xb_n = xb[..., idx].permute(2, 0, 1)

        def score(state):
            eta = torch.einsum("zbst,zb->bst", state[0].reshape(Z, B, S, T), a[:, idx]) + xb_n
            return torch.sum((y_n * eta - torch.exp(eta)) * mask, dim=(1, 2)) / nvalid

        trail = [score((zeros,))]
        _, sweeps = estep(y, xb, mask, a, poisson, noise, G, (zeros, wz, vz, zeros), cfg, niter,
                          cm, extra=extra, each=lambda st: trail.append(score(st)))
        trail = torch.stack(trail, dim=1).tolist()  # (B, sweeps + 1)
        for j, n in enumerate(chunk):
            scores[n] = trail[j]
            ran[n] = int(sweeps[j])
    return scores, ran
