"""The H-step's bounded search on log(omega) in one kernel per refinement.

Counterpart of ``_golden_min(obj, lo_s, hi_s, ...)`` at
``vlgp_tpu/models/gp.py:270-272``, whose ``lax.fori_loop`` (:255-268) XLA
compiles into one device loop (no Pallas kernel).  On the card one launch
of the hand-written CUDA kernel ``csrc/hstep.cu`` runs the whole search
for every latent, one thread-block cluster per latent: the grid scan, the
golden-section shrinks and the optional parabolic polish, each evaluation
one ``gp_elbo_stats`` (the Cholesky of the candidate SE kernel,
tr(K^-1 C) and log|L|).  The cluster's blocks evaluate the grid's
candidates side by side and, after it, every point the next few golden
shrinks can reach, so a search is a few rounds instead of a chain of
evaluations (the schedule is in the kernel's header).  Up to T = 138
(float32; 97 in float64) a block evaluates a point in its shared memory;
above it (``window=None``, whole trials) a group of ``per`` blocks shares
each evaluation, a Cholesky blocked by 64-wide panels over global scratch.
The result does not depend on the plan (the cluster's size, ``per``).

``_golden_min`` and ``gp_elbo_stats`` (the port's torch versions of
``vlgp_tpu``'s, ``models/gp.py`` keeps both names) make up the plain
version, ``_hstep_search_plain``.  ``hstep_search`` runs it only for
tensors on the CPU; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .spd import KERNEL_LAUNCHES, _ptr, _raise_on

__all__ = ["hstep_search", "gp_elbo_stats", "cluster_plan", "GRID_MAX"]

# largest grid of candidates the kernel takes (its objectives sit in shared memory)
GRID_MAX = 256
# the kernel's plan (cluster size, blocks per evaluation, resident
# clusters) per (device, T, dtype, Z, grid, iters, polish): queried once
# from the card (csrc/hstep.cu:hstep_search_cluster), never inside a capture
_CLUSTER: dict = {}


def _golden_min(f, lo, hi, iters: int, polish: bool = False, grid: int = 0,
                tiebreak: float = 1e-4):
    """Fixed-iteration golden-section minimization on [lo, hi] per latent,
    optionally preceded by a grid scan with a smooth-preferring tie-break
    and followed by a parabolic polish (``vlgp_tpu/models/gp.py:174-281``).
    f maps a (..., Z) tensor of arguments to objectives of the same shape."""
    if grid >= 3:
        frac = torch.arange(grid, dtype=lo.dtype, device=lo.device) / (grid - 1)
        cand = lo[None] + frac[:, None] * (hi - lo)[None]  # (grid, Z)
        fcand = f(cand)
        # NaN candidates lose the comparison instead of poisoning it
        bad = torch.isnan(fcand)
        fcand = torch.where(bad, torch.inf, fcand)
        fmin = fcand.amin(dim=0)
        near = fcand <= fmin + tiebreak * fmin.abs()
        best = torch.argmax(near.to(torch.int8), dim=0)  # first near-tied candidate
        lo_idx = torch.clamp(best - 1, min=0)
        lo_idx = torch.where(bad.gather(0, lo_idx[None])[0], best, lo_idx)
        hi_idx = torch.clamp(best + 1, max=grid - 1)
        hi_idx = torch.where(bad.gather(0, hi_idx[None])[0], best, hi_idx)
        # an all-NaN column collapses onto the box edge (rejected as at-bound)
        allbad = bad.all(dim=0)
        lo_b = cand.gather(0, lo_idx[None])[0]
        hi_b = cand.gather(0, hi_idx[None])[0]
        lo, hi = torch.where(allbad, lo, lo_b), torch.where(allbad, lo, hi_b)
    phi = 0.6180339887498949
    c = hi - phi * (hi - lo)
    d = lo + phi * (hi - lo)
    fc, fd = f(c), f(d)
    for _ in range(iters):
        left = fc < fd
        lo_n = torch.where(left, lo, c)
        hi_n = torch.where(left, d, hi)
        c_n = torch.where(left, hi_n - phi * (hi_n - lo_n), d)
        d_n = torch.where(left, c, lo_n + phi * (hi_n - lo_n))
        f_new = f(torch.where(left, c_n, d_n))
        fc, fd = torch.where(left, f_new, fd), torch.where(left, fc, f_new)
        lo, hi, c, d = lo_n, hi_n, c_n, d_n
    mid = 0.5 * (lo + hi)
    if not polish:
        return mid
    fm = f(mid)
    # vertex of the parabola through (c, fc), (mid, fm), (d, fd)
    num = (mid - c) ** 2 * (fm - fd) - (mid - d) ** 2 * (fm - fc)
    den = (mid - c) * (fm - fd) - (mid - d) * (fm - fc)
    safe = den.abs() > 1e-30
    x_star = mid - 0.5 * torch.where(safe, num / torch.where(safe, den, 1.0), 0.0)
    ok = safe & (x_star > lo) & (x_star < hi)
    return torch.where(ok, x_star, mid)


def gp_elbo_stats(log_omega, C, nseg, T: int, sigmasq, gp_noise, dt,
                  profile_sigma: bool = False):
    """GP-prior ELBO from the (T, T) statistic C = sum_i (mu_i mu_i' + S_i):
    ll = -1/2 tr(K^-1 C) - nseg log|chol(K)|, one (T, T) Cholesky per
    candidate; ``log_omega`` may carry leading batch dims.  With
    ``profile_sigma`` the amplitude is maximized in closed form per
    candidate, s* = clip(tr(K0^-1 C) / (nseg T), 1e-2, 1e2); returns
    (ll*, s*).  A failed Cholesky gives NaN, as in the JAX package."""
    om = torch.exp(log_omega)[..., None, None]
    t = torch.arange(T, dtype=C.dtype, device=C.device) * dt
    dsq = (t[:, None] - t[None, :]) ** 2
    amp = 1.0 if profile_sigma else sigmasq
    K = amp * torch.exp(-om * dsq) + gp_noise * torch.eye(T, dtype=C.dtype, device=C.device)
    L, info = torch.linalg.cholesky_ex(K)
    L = torch.where((info > 0)[..., None, None], torch.nan, L)
    Cb = C.expand(K.shape)
    half = torch.linalg.solve_triangular(L, Cb, upper=False)
    KinvC = torch.linalg.solve_triangular(L.mT, half, upper=True)
    logdet = torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    tr = torch.diagonal(KinvC, dim1=-2, dim2=-1).sum(-1)
    if not profile_sigma:
        return -0.5 * tr - nseg * logdet
    s = torch.clamp(tr / (nseg * T), 1e-2, 1e2)
    return -0.5 * tr / s - nseg * (0.5 * T * torch.log(s) + logdet), s


def _objective(C, nseg, sigsq, gp_noise, dt, profile_sigma: bool):
    """The search's objective -ll as ``models/gp.py:hstep`` builds it; sigsq
    (Z,)."""
    T = C.shape[-1]
    amp = sigsq.reshape(-1, 1, 1)

    def obj(log_omega):
        if profile_sigma:
            ll, _ = gp_elbo_stats(log_omega, C, nseg, T, amp, gp_noise, dt, profile_sigma=True)
            return -ll
        return -gp_elbo_stats(log_omega, C, nseg, T, amp, gp_noise, dt)

    return obj


def _hstep_search_plain(C, nseg, sigsq, gp_noise, dt, lo, hi, iters: int, polish: bool,
                        grid: int, tiebreak: float, profile_sigma: bool):
    """Plain version: ``_golden_min`` over ``gp_elbo_stats``."""
    return _golden_min(_objective(C, nseg, sigsq, gp_noise, dt, profile_sigma), lo, hi, iters,
                       polish=polish, grid=grid, tiebreak=tiebreak)


def cluster_plan(Z: int, T: int, dtype, grid: int, iters: int, polish: bool,
                 device=None) -> dict:
    """The kernel's launch at this shape on ``device``'s card: ``nb``, the
    blocks of each latent's cluster, and ``per``, the blocks that share one
    evaluation (``hstep_search_cluster``'s choice, cached); ``points`` =
    nb / per evaluated a round, ``rounds`` of a search, ``resident``
    clusters of nb blocks the card holds at once, and ``scratch_bytes`` of
    global scratch (0 when a block's buffers sit in shared memory)."""
    from ._build import load_library

    device = torch.device("cuda") if device is None else torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    is_double = int(dtype == torch.float64)
    lib = load_library("hstep")
    key = (index, T, is_double, Z, grid, iters, bool(polish))
    if key not in _CLUSTER:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("hstep_search's first call at a shape must run before a capture "
                               "(its plan is read from the card)")
        per = ctypes.c_int(1)
        with torch.cuda.device(index):
            nb = lib.hstep_search_cluster(T, is_double, Z, grid, iters, int(polish),
                                          ctypes.byref(per))
            resident = lib.hstep_search_resident(T, is_double, nb) if nb > 0 else 0
        if nb < 1:
            raise RuntimeError(f"hstep_search: no cluster size fits Z={Z} T={T} on this card "
                               f"(hstep_search_cluster returned {nb})")
        _CLUSTER[key] = (nb, per.value, resident)
    nb, per, resident = _CLUSTER[key]
    points = nb // per
    return dict(nb=nb, per=per, points=points,
                rounds=lib.hstep_search_rounds(points, grid, iters, int(polish)),
                resident=resident, scratch_bytes=Z * points * _scratch_values(lib, T, is_double)
                * (8 if is_double else 4))


def _scratch_values(lib, T, is_double) -> int:
    """Values of global scratch one evaluation takes (0 in shared memory)."""
    values = lib.hstep_search_scratch(T, is_double)
    if values < 0:
        raise ValueError(f"hstep_search: T={T} needs more scratch than the kernel addresses")
    return values


def _hstep_search_cuda(C, nseg, sigsq, gp_noise, dt, lo, hi, iters, polish, grid, tiebreak,
                       profile_sigma, nb=None, per=None):
    """Launch ``hstep_search``: one cluster of ``nb`` blocks per latent,
    ``per`` of them to an evaluation (default ``cluster_plan``'s; ``nb=1``
    runs the chain of single evaluations; every plan gives the same x);
    global scratch for the evaluations when a block's buffers do not fit
    in shared memory."""
    from ._build import load_library

    Z, T = C.shape[0], C.shape[1]
    if C.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"hstep_search takes float32 or float64, got {C.dtype}")
    for name, t in dict(nseg=nseg, sigsq=sigsq, lo=lo, hi=hi).items():
        if not t.is_cuda or t.device != C.device:
            raise ValueError(f"{name} must be a CUDA tensor on {C.device}, got {t.device}")
        if t.dtype != C.dtype:
            raise TypeError(f"{name} must be {C.dtype}, got {t.dtype}")
    if nseg.numel() != 1 or any(tuple(t.shape) != (Z,) for t in (sigsq, lo, hi)):
        raise ValueError("hstep_search takes one nseg and sigsq, lo, hi of shape (Z,)")
    if nb is None:
        plan = cluster_plan(Z, T, C.dtype, grid, iters, polish, C.device)
        nb, per = plan["nb"], plan["per"]
    else:
        per = 1 if per is None else per
        if not (1 <= nb <= 16 and per >= 1 and nb % per == 0):
            raise ValueError(f"hstep_search takes 1 <= nb <= 16 blocks per latent and per "
                             f"dividing nb, got nb={nb}, per={per}")
    C, nseg, sigsq, lo, hi = (t.contiguous() for t in (C, nseg, sigsq, lo, hi))
    is_double = int(C.dtype == torch.float64)
    lib = load_library("hstep")
    values = Z * (nb // per) * _scratch_values(lib, T, is_double)
    scratch = torch.empty((values,), dtype=C.dtype, device=C.device) if values else None
    x = torch.empty((Z,), dtype=C.dtype, device=C.device)
    with torch.cuda.device(C.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(C.device).cuda_stream)
        rc = lib.hstep_search(_ptr(C), _ptr(nseg), _ptr(sigsq), _ptr(lo), _ptr(hi), _ptr(x),
                              _ptr(scratch), Z, T, float(gp_noise), float(dt),
                              int(profile_sigma), iters, int(polish), grid, float(tiebreak),
                              is_double, nb, per, stream)
    _raise_on(rc, lib, "hstep_search")
    KERNEL_LAUNCHES["hstep_search"] += 1
    return x


def hstep_search(C, nseg, sigsq, gp_noise, dt, lo, hi, iters: int, *, polish: bool = False,
                 grid: int = 0, tiebreak: float = 1e-4, profile_sigma: bool = False):
    """The minimizer in [lo, hi] (Z,) of the GP-prior objective -ll(log
    omega) of each latent's statistic C (Z, T, T): ``_golden_min``'s grid
    scan (``grid`` >= 3 candidates), ``iters`` golden shrinks and optional
    ``polish``, with ``gp_elbo_stats`` as the objective (amplitude sigsq
    (Z,), or profiled with ``profile_sigma``); nseg one value.  CPU tensors
    run the plain version; CUDA tensors launch the kernel."""
    if C.ndim != 3 or C.shape[1] != C.shape[2] or min(C.shape) < 1:
        raise ValueError(f"hstep_search takes C of shape (Z, T, T), got {tuple(C.shape)}")
    if iters < 0 or not 0 <= grid <= GRID_MAX:
        raise ValueError(f"hstep_search takes iters >= 0 and 0 <= grid <= {GRID_MAX}")
    if C.is_cuda:
        return _hstep_search_cuda(C, nseg, sigsq, gp_noise, dt, lo, hi, iters, polish, grid,
                                  tiebreak, profile_sigma)
    if C.device.type != "cpu":
        raise ValueError(f"hstep_search runs on CUDA or the CPU, got {C.device}")
    return _hstep_search_plain(C, nseg, sigsq, gp_noise, dt, lo, hi, iters, polish, grid,
                               tiebreak, profile_sigma)
