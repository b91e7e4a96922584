"""GP prior layer: kernels, prior factors, hyperparameter step.

Counterpart of ``vlgp_tpu/models/gp.py`` (reference ``vlgp/gp.py``).  The
H-step is the same bounded search on log(omega) per latent: a grid scan
plus golden-section shrinks over the pooled (T, T) posterior statistic,
run as an Aitken-extrapolated fixed point whose posterior refresh goes
through the E-step's fused-Gram Woodbury inverse.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..config import Config, Params
from ..data import TrialSet
# _golden_min and gp_elbo_stats live in ops/golden.py (the search's plain
# version) and keep their names here for this module's callers
from ..ops.golden import _golden_min, gp_elbo_stats, hstep_search  # noqa: F401
from ..ops.hstat import hstep_stat
from ..ops.ichol import ichol_gauss, ichol_gauss_batch, nystrom_gauss_batch
from ..ops.spd import inv_one_plus_gram
from ..utils.profiling import annotate
from .vlgp import Dist, _psum

__all__ = [
    "sekernel",
    "se_kernel_grid",
    "make_cholesky",
    "effective_rank",
    "gp_elbo_stats",
    "hstep",
    "posterior_cov",
]


def sekernel(x, var, scale, jitter: float = 1e-6):
    """Dense SE covariance, GPFA parameterization (gp.py:165-171):
    K[i,j] = var * exp(-0.5 * ((x_i - x_j)/scale)^2) + jitter * I."""
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        x = x.to(torch.float32)
    x = x / scale
    dsq = (x[:, None] - x[None, :]) ** 2
    return var * torch.exp(-0.5 * dsq) + jitter * torch.eye(
        x.shape[0], dtype=dsq.dtype, device=dsq.device)


def se_kernel_grid(T: int, omega, sigmasq=1.0, gp_noise=1e-4, dt: float = 1.0,
                   dtype=torch.float32, device="cpu"):
    """SE kernel on a regular grid, vLGP parameterization (gp.py:46-62):
    K = sigmasq * exp(-omega * D^2) + gp_noise * I."""
    t = torch.arange(T, dtype=dtype, device=device) * dt
    dsq = (t[:, None] - t[None, :]) ** 2
    return sigmasq * torch.exp(-omega * dsq) + gp_noise * torch.eye(
        T, dtype=dtype, device=device)


def make_cholesky(T: int, params: Params, rank: Optional[int] = None) -> torch.Tensor:
    """Low-rank prior factors for all latents: (zdim, T, rank), with
    K_l ~= (sigma_l G_l)(sigma_l G_l)' (gp.py:150-162).  ``rank``
    overrides ``params.rank`` (e.g. the trimmed segment rank)."""
    rank = params.rank if rank is None else rank
    rank = min(rank, T)
    G = _se_factor(T, params.omega, rank, params.dt, params.a.dtype)
    return G.to(params.a.dtype) * params.sigma[:, None, None]


def _se_factor(T: int, omega, rank: int, dt, dtype):
    """Nystrom on the float32 path when the landmark set is dense
    (rank >= 0.6 T, the window-segment regime); exact pivoted ichol
    otherwise (float64, full-length factors)."""
    if dtype == torch.float32 and rank >= 0.6 * T:
        return nystrom_gauss_batch(T, omega, rank, dt)
    return ichol_gauss_batch(T, omega, rank, dt)


def effective_rank(T: int, omega_hi: float, dt: float = 1.0,
                   margin: int = 4, tol: float = 1e-7) -> int:
    """Numerically exact truncation rank for window-T segment factors:
    the number of non-zero columns of the float32 pivoted ichol at the
    sharpest omega, plus ``margin``, rounded up to a multiple of 8."""
    probe = min(T, 128)
    G = ichol_gauss(T, torch.tensor(omega_hi, dtype=torch.float32), probe, dt)
    colmax = G.abs().amax(dim=0)
    nz = int((colmax > tol).sum())
    if nz >= probe:  # probe saturated: no safe truncation, keep full rank
        return T
    r = min(T, -(-(nz + margin) // 8) * 8)
    return max(8, r)


def _aitken_accept(x0, x1, x2, lo, hi, trust):
    """Aitken/Steffensen acceptance for the H-step fixed point: accept the
    extrapolation only on a genuine contraction, cap the jump at
    ``trust * |x2 - x1|`` when trust > 0, clip to [lo, hi]."""
    d1 = x1 - x0
    d2 = x2 - x1
    denom = d2 - d1
    safe = denom.abs() > 1e-12
    aitken = x2 - torch.where(safe, d2 * d2 / torch.where(safe, denom, 1.0), 0.0)
    if trust > 0:
        cap = trust * d2.abs()
        aitken = x2 + torch.clamp(aitken - x2, -cap, cap)
    contracting = (d1 * d2 > 0) & (d2.abs() < d1.abs())
    return torch.clamp(torch.where(contracting, aitken, x2), lo, hi)


def hstep(data: TrialSet, params: Params, config: Config, dist: Dist = Dist(),
          rank: Optional[int] = None, xinv=None) -> Params:
    """Hyperparameter step: per-latent bounded search on log(omega) with
    at-bound rejection (gp.optimize, gp.py:65-97), plus the profiled sigma
    update (``vlgp_tpu/models/gp.py:353-539``).

    The pooled posterior statistic is built in factor space from the
    E-step's Woodbury inverses X = (I + G' diag(w~) G)^{-1} with the
    commuting identities AX = I - X and QA = P - Q, so no (S, T, T)
    tensor is formed.  ``xinv`` (the E-step's carried inverse) warm-starts
    the first refinement, which skips the probe.  Under ``dist.data`` the
    pooled statistics are summed over the ranks (one all_reduce before the
    refinements and one in each), so the search runs on the same statistic,
    and returns the same omega and sigma, on every rank.  The statistics
    read only the posterior, which is the same on every rank of a data row,
    so ``dist.model`` adds nothing (``vlgp_tpu/models/gp.py:395-450``).
    """
    if not config.Hstep:
        return params

    T = data.nbin
    Z = params.zdim
    dtype, device = data.mu.dtype, data.mu.device
    rank = min(params.rank, T) if rank is None else min(rank, T)
    lo = torch.full((Z,), math.log(config.omega_bound[0]), dtype=dtype, device=device)
    hi = torch.full((Z,), math.log(config.omega_bound[1]), dtype=dtype, device=device)
    # segments with at least one valid bin: fully masked rows (the padding
    # of a sharded fit) count for nothing
    valid = data.mask.amax(dim=1)  # (S,)
    margin = 2e-3 * (hi - lo)

    mu_t = data.mu.permute(2, 0, 1)  # (Z, S, T)
    w_t = data.w.permute(2, 0, 1) * data.mask[None]
    sigsq = (params.sigma ** 2).reshape(Z, 1, 1)
    eps = params.gp_noise
    eyeT = torch.eye(T, dtype=dtype, device=device)
    # ridge-folded weights w/(1 + eps w): the low-rank prior K = GG' + eps I
    wt2 = (w_t / (1.0 + eps * w_t)).contiguous()
    nseg_total, Mbar, sum_w = _psum((valid.sum(), torch.einsum("zst,zsu->ztu", mu_t, mu_t),
                                     torch.einsum("s,zst->zt", valid, wt2)), dist, "data")

    def F(log_om, warmX=None, warm_probe=True):
        # one fixed-point refinement: posterior statistic at the running
        # omega, then a bounded search over the candidate kernel, each in a
        # region of its own so that a trace splits the H-step between them
        with annotate("vlgp:hstep_stat"):
            G_om = _se_factor(T, torch.exp(log_om), rank, params.dt, dtype)
            G_om = G_om.to(dtype) * params.sigma[:, None, None]
            X = inv_one_plus_gram(G_om, wt2, iters=config.ns_iters + 2, warm=warmX,
                                  warm_iters=max(config.ns_warm_iters, 8),
                                  probe=warm_probe)
            R = X.shape[-1]
            # sum_s Q_s P_s', X_s and Q_s A_s = P_s - Q_s over this device's
            # segments (P = diag(w~) G, Q = P X): one kernel on the card
            sum_QP, sum_X, sum_QA = _psum(hstep_stat(G_om, wt2, X, valid), dist, "data")
            eyeR = torch.eye(R, dtype=dtype, device=device)
            sum_AXA_mA = sum_X - nseg_total * eyeR  # A X A - A = X - I
            KK = G_om @ G_om.mT
            GM = G_om @ sum_AXA_mA
            t_qa = sum_QA @ G_om.mT
            SigSum = (
                nseg_total * (KK + eps * eyeT)
                - eps * eps * sum_w[:, :, None] * eyeT
                - eps * (KK * sum_w[:, None, :] + sum_w[:, :, None] * KK)
                + eps * eps * sum_QP
                + eps * (t_qa + t_qa.mT)
                + GM @ G_om.mT
            )
            C = Mbar + SigSum

        if config.hyper_grid >= 3 and config.hyper_window > 0:
            lo_s = torch.clamp(log_om - config.hyper_window, lo, hi)
            hi_s = torch.clamp(log_om + config.hyper_window, lo, hi)
        else:
            lo_s, hi_s = lo, hi
        with annotate("vlgp:hstep_search"):
            x_new = hstep_search(C, nseg_total, sigsq.reshape(Z), params.gp_noise, params.dt,
                                 lo_s, hi_s, config.hyper_iters, polish=config.hyper_polish,
                                 grid=config.hyper_grid, tiebreak=config.hyper_tiebreak,
                                 profile_sigma=config.hyper_learn_sigma)
        return x_new, X, C

    x0 = torch.log(params.omega).to(dtype)
    x1, X1, _ = F(x0, xinv, warm_probe=False)
    x2, X2, C2 = F(x1, X1)
    trust = config.hyper_trust if config.hyper_refines < 3 else 0.0
    x_star = _aitken_accept(x0, x1, x2, lo + margin, hi - margin, trust)
    if config.hyper_refines >= 3:
        log_omega, _, Cf = F(x_star, X2)
    else:
        log_omega, Cf = x_star, C2

    # reject updates that sit at the search bounds (gp.py:91-92)
    span = hi - lo
    at_bound = ((log_omega - lo).abs() < 1e-3 * span) | ((log_omega - hi).abs() < 1e-3 * span)
    omega = torch.where(at_bound, params.omega, torch.exp(log_omega))
    out = params.replace(omega=omega.to(params.omega.dtype))
    if config.hyper_learn_sigma:
        # closed-form profile optimum of the amplitude at the accepted omega
        _, s = gp_elbo_stats(torch.log(out.omega).to(dtype), Cf, nseg_total, T,
                             sigsq, params.gp_noise, params.dt, profile_sigma=True)
        out = out.replace(sigma=torch.sqrt(s).to(params.sigma.dtype))
    return out


def posterior_cov(w_l, G_l, reg: float = 0.0):
    """Dense posterior covariance (K^-1 + diag(w))^-1 of one latent of one
    trial, by Woodbury from the low-rank factor (util.py:541-547):
    S = K - K W (I + K W)^-1 K with K = G G' (+ reg I).  Leading batch
    axes of ``w_l`` (..., T) and ``G_l`` (..., T, R) are carried along."""
    T = G_l.shape[-2]
    eye = torch.eye(T, dtype=G_l.dtype, device=G_l.device)
    K = G_l @ G_l.mT + reg * eye
    KW = K * w_l[..., None, :]
    return K - KW @ torch.linalg.solve(eye + KW, K)
