"""GPFA: linear-Gaussian latent model, used as warm start and CV engine
(counterpart of ``vlgp_tpu/models/gpfa.py``; reference ``vlgp/gpfa.py``).

The reference solves an (n*ydim)-sized observation-space system per EM
step (gpfa.py:37-45).  Here, as in ``vlgp_tpu``, the E-step solves the
latent-space normal equations instead:

    P = kron(I_z, K^-1) + kron(C R^-1 C', I_n)        (zn x zn)
    z = P^-1 vec(C R^-1 (y - d)')

which is algebraically identical (Woodbury / Gaussian conditioning) but
factors one (z*n)^2 matrix shared by all trials instead of an (y*n)^2 one.

Deliberate fixes vs the reference (kept from ``vlgp_tpu``):
  * gpfa.py:51 sets R = diag(ssr^2), ssr the *sum of squared residuals*
    from lstsq, which scales with the dataset size; here R is the
    per-channel residual variance (the actual MLE).
  * gpfa.py:39 applies kron(I_n, R) to a channel-major vectorization,
    which scrambles per-channel noise when R is non-uniform; the
    latent-space form uses R per channel correctly.

Functions on tensors run on the device of those tensors; ``prepare`` and
``fit`` take trials and a ``device`` (the current CUDA device when None).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import Config, _resolve_device, default_config
from ..data import TrialSet, cut_trials, unpack_trials
from .gp import sekernel

__all__ = [
    "make_prior", "em", "em_step", "infer", "leastsq", "loglik",
    "prepare", "fit", "GPFAResult",
]


def _latent_space_estep(y, C, d, Rdiag, K):
    """Posterior mean of z for a stack of equal-length trials.

    y: (m, n, ydim); C: (z, ydim); d: (ydim,); Rdiag: (ydim,); K: (n, n).
    Returns z: (m, n, z).
    """
    m, n, _ = y.shape
    zdim = C.shape[0]
    Kinv = torch.linalg.inv(K).contiguous()  # torch.kron needs a row-major operand
    CR = C / Rdiag[None, :]
    CRC = CR @ C.T  # (z, z)
    # P[l*n+t, l'*n+t'] = Kinv[t,t'] delta_ll' + CRC[l,l'] delta_tt'
    Iz = torch.eye(zdim, dtype=y.dtype, device=y.device)
    In = torch.eye(n, dtype=y.dtype, device=y.device)
    P = torch.kron(Iz, Kinv) + torch.kron(CRC, In)
    resid = y - d[None, None, :]
    rhs = torch.einsum("zy,mty->mzt", CR, resid).reshape(m, zdim * n)
    zvec = torch.linalg.solve(P, rhs.T).T  # (m, zn)
    return zvec.reshape(m, zdim, n).permute(0, 2, 1)


def leastsq(Y, Z):
    """Least squares Y ~= Z @ C + d (gpfa.py:78-83).

    Returns (C, d, resid_var) with per-channel residual variance.
    """
    n = Z.shape[0]
    Z1 = torch.cat([Z, torch.ones((n, 1), dtype=Z.dtype, device=Z.device)], dim=1)
    beta = torch.linalg.lstsq(Z1, Y).solution
    C, d = beta[:-1, :], beta[-1, :]
    r = Y - Z1 @ beta
    return C, d, torch.mean(r * r, dim=0)


def em_step(y, C, d, Rdiag, K):
    """One GPFA EM iteration (gpfa.py:34-53)."""
    ydim = y.shape[-1]
    zdim = C.shape[0]
    z = _latent_space_estep(y, C, d, Rdiag, K)
    z = z - torch.mean(z, dim=(0, 1), keepdim=True)  # gpfa.py:45
    C, d, Rdiag = leastsq(y.reshape(-1, ydim), z.reshape(-1, zdim))
    C = C / torch.linalg.norm(C)  # gpfa.py:52
    return z, C, d, Rdiag


def em(y, C, d, R, K, max_iter: int):
    """GPFA EM loop (gpfa.py:20-56).

    y: (m, n, ydim); C: (z, ydim); d: (ydim,); R: (ydim, ydim) or (ydim,)
    diagonal; K: (n, n), all on one device.  Returns (z, C, d, R) with R
    diagonal as (ydim,).
    """
    Rdiag = torch.diagonal(R) if R.ndim == 2 else R
    z = None
    for _ in range(max_iter):
        z, C, d, Rdiag = em_step(y, C, d, Rdiag, K)
    return z, C, d, Rdiag


def infer(y, C, d, Rdiag, K):
    """Posterior latents for new equal-length trials (gpfa.py:59-75)."""
    return _latent_space_estep(y, C, d, Rdiag, K)


def make_prior(n: int, dt: float, var: float, scale: float, *,
               dtype: torch.dtype = torch.float32, device=None):
    """Dense SE prior for a trial of length n (gpfa.py:11-17), on ``device``
    (the current CUDA device when None)."""
    device = _resolve_device(device, "gpfa.make_prior")
    t = torch.arange(n, dtype=dtype, device=device) * dt
    return sekernel(t, var, scale)


@dataclasses.dataclass
class GPFAResult:
    """Standalone GPFA fit output: the reference's bare tuple ``(y, z, C,
    d, R)`` (gpfa.py:101-120) as a typed record, plus the full-length
    posterior.  Indexable like a reference result dict."""

    data: TrialSet  # full trials with mu = full-length GPFA posterior
    z: torch.Tensor  # (nseg, window, zdim) training-segment posterior
    C: torch.Tensor  # (zdim, ydim) loading
    d: torch.Tensor  # (ydim,) offset
    R: torch.Tensor  # (ydim,) per-channel noise variance
    K: torch.Tensor  # (window, window) segment prior
    config: Config
    runtime: dict
    _trials_in: Optional[Sequence[dict]] = None

    @property
    def trials(self) -> List[dict]:
        return unpack_trials(self.data, self._trials_in)

    @property
    def params(self) -> dict:
        return {"C": self.C, "d": self.d, "R": self.R}

    def __getitem__(self, key):
        if key == "trials":
            return self.trials
        if key == "params":
            return self.params
        if key == "config":
            return self.config
        raise KeyError(key)


def _prepare_full(trials, n_factors, *, dt, var, scale, device=None, **config_kwargs):
    """Shared init + segmentation for the public GPFA surface
    (gpfa.py:123-158): FA initialization, window segmentation, dense SE
    prior on the segment grid."""
    from ..api import _prepare  # the api imports this module

    config = default_config(**config_kwargs)
    device = _resolve_device(device, "gpfa.fit")
    data, params, fm = _prepare(trials, n_factors, config, device, dt=dt)
    segments = cut_trials(data, config.window, seed=config.seed)
    K = make_prior(segments.nbin, dt, var, scale, dtype=data.y.dtype, device=device)
    C0 = params.a
    # offset in data space: exp(b0), the mean itself, not the log-mean the
    # reference seeds d with (gpfa.py:153)
    d0 = torch.exp(params.b[0])
    R0 = torch.ones(data.ydim, dtype=K.dtype, device=device)
    return data, segments, config, fm, C0, d0, R0, K


def prepare(trials, n_factors, *, dt, var, scale, device=None, **config_kwargs):
    """Public GPFA prepare (reference gpfa.py:123-158).

    Returns ``(y, C, d, R, K)``: stacked training segments, initial
    loading/offset/noise, and the dense SE prior on the segment grid, with
    R as the (ydim,) diagonal.
    """
    _, segments, _, _, C0, d0, R0, K = _prepare_full(
        trials, n_factors, dt=dt, var=var, scale=scale, device=device, **config_kwargs)
    return segments.y, C0, d0, R0, K


def fit(trials, n_factors, *, dt, var, scale, max_iter: int = 20,
        verbose: bool = False, device=None, **config_kwargs) -> GPFAResult:
    """Standalone GPFA fit (reference gpfa.py:101-120): init ->
    segmentation -> EM on segments -> full-length posterior inference.

    trials: list of dicts with ``y`` (length, ydim); unequal lengths are
    padded and masked.  ``var``/``scale`` parameterize the SE prior (fixed
    during EM).  Per-iteration EM wall-clock lands in
    ``runtime["em_elapsed"]``.  ``device`` defaults to the current CUDA
    device and raises when there is none.
    """
    data, segments, config, _, C, d, R, K = _prepare_full(
        trials, n_factors, dt=dt, var=var, scale=scale, device=device, **config_kwargs)

    runtime = {"it": 0, "em_elapsed": []}
    y_seg = segments.y
    z = torch.zeros((y_seg.shape[0], y_seg.shape[1], n_factors), dtype=y_seg.dtype,
                    device=y_seg.device)
    for _ in range(max_iter):
        tic = time.perf_counter()
        z, C, d, R = em_step(y_seg, C, d, R, K)
        if C.is_cuda:
            torch.cuda.synchronize(C.device)
        runtime["it"] += 1
        runtime["em_elapsed"].append(time.perf_counter() - tic)
        if verbose:
            print(f"Iteration {runtime['it']}, EM {runtime['em_elapsed'][-1]:.2f}s")

    # full-length inference under the fitted (C, d, R), one dense prior per
    # distinct trial length (the length-L prior is the L-prefix of the
    # longest one on a regular grid)
    tic = time.perf_counter()
    lengths = data.lengths.cpu().numpy()
    K_full = make_prior(data.nbin, dt, var, scale, dtype=K.dtype, device=K.device)
    mu = torch.zeros_like(data.mu)
    for L in np.unique(lengths):
        sel = torch.from_numpy(np.nonzero(lengths == L)[0]).to(mu.device)
        Lt = int(L)
        mu[sel, :Lt, :] = infer(data.y[sel, :Lt, :], C, d, R, K_full[:Lt, :Lt])
    data = data.replace(mu=mu)
    runtime["infer_elapsed"] = time.perf_counter() - tic

    return GPFAResult(data=data, z=z, C=C, d=d, R=R, K=K, config=config, runtime=runtime,
                      _trials_in=trials)


def loglik(y, z, C, d, Rdiag, var, scale, dt):
    """Gaussian complete-data objective (gpfa.py:86-98), with the residual
    term correctly weighted as sum(r^2 / R) (the reference elementwise-
    inverts a diagonal matrix, gpfa.py:94), plus the latent GP quadratic
    and log-determinant terms."""
    m, n, _ = y.shape
    t = torch.arange(n, dtype=y.dtype, device=y.device) * dt
    K = sekernel(t, var, scale)
    r = y - torch.einsum("mtz,zy->mty", z, C) - d[None, None, :]
    data_term = torch.sum(r * r / Rdiag[None, None, :])
    zc = z.permute(0, 2, 1).reshape(-1, n)
    Kinv_z = torch.linalg.solve(K, zc.T)
    quad = torch.sum(Kinv_z.T * zc)
    _, logdet = torch.linalg.slogdet(K)
    zdim = z.shape[-1]
    return data_term + quad + m * zdim * logdet
