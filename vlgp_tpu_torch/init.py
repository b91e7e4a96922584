"""Initialization by factor analysis (counterpart of ``vlgp_tpu/init.py``).

The reference seeds the model with scikit-learn's FactorAnalysis on a
~10% row subsample (``vlgp/preprocess.py:4-46``).  Here FA is a small EM
loop in torch, and the subsample is drawn from a ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["FactorModel", "fit_factor_analysis", "initialize"]


@dataclasses.dataclass(frozen=True)
class FactorModel:
    """Fitted factor-analysis model y ~ N(mean + z @ a, diag(psi))."""

    mean: torch.Tensor  # (ydim,)
    a: torch.Tensor  # (zdim, ydim) loading (rows = factors)
    psi: torch.Tensor  # (ydim,) noise variances

    def transform(self, y: torch.Tensor) -> torch.Tensor:
        """Posterior mean of z given y (..., ydim), the ``fa.transform``
        analog: z = (I + A Psi^-1 A')^-1 A Psi^-1 (y - mean)."""
        a, psi = self.a, self.psi
        ap = a / psi[None, :]
        m = torch.eye(a.shape[0], dtype=a.dtype, device=a.device) + ap @ a.T
        return (y - self.mean) @ torch.linalg.solve(m, ap).T


def fit_factor_analysis(y: torch.Tensor, zdim: int, n_iter: int = 64,
                        eps: float = 1e-6) -> FactorModel:
    """EM for factor analysis (Ghahramani-Hinton) from a PCA warm start.
    y: (n, ydim).  Replaces sklearn FactorAnalysis (preprocess.py:18-23)."""
    n, ydim = y.shape
    mean = y.mean(dim=0)
    yc = y - mean
    var = torch.clamp(yc.var(dim=0, unbiased=False), min=eps)

    _, s, vt = torch.linalg.svd(yc, full_matrices=False)
    scale = s[:zdim] / (n ** 0.5)
    a = scale[:, None] * vt[:zdim]
    psi = torch.clamp(var - torch.sum(a ** 2, dim=0), min=eps)
    eye = torch.eye(zdim, dtype=y.dtype, device=y.device)
    for _ in range(n_iter):
        ap = a / psi[None, :]
        m = eye + ap @ a.T
        beta = torch.linalg.solve(m, ap)  # (z, y): posterior map
        ez = yc @ beta.T
        ezz = n * torch.linalg.inv(m) + ez.T @ ez
        ezy = ez.T @ yc
        a = torch.linalg.solve(ezz, ezy)
        psi = torch.clamp(torch.mean(yc * yc, dim=0)
                          - torch.einsum("zy,zy->y", a, ezy) / n, min=eps)
    return FactorModel(mean=mean, a=a, psi=psi)


def _subsample_rows(mask: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """``k`` row indices drawn with replacement, uniformly over the rows
    where the 0/1 ``mask`` is set (``vlgp_tpu``'s draw weighted by the
    mask).  Integer draws into the valid rows: ``torch.multinomial`` on the
    CUDA device moved a draw to a neighbouring row between processes with
    one seed."""
    valid = torch.nonzero(mask > 0).squeeze(1)
    pick = torch.randint(valid.shape[0], (k,), generator=generator, device=mask.device)
    return valid[pick]


def initialize(data, zdim: int, generator: torch.Generator, *, eps: float = 1e-8,
               subsample_frac: float = 0.1, min_subsample: int = 50,
               fa_iters: int = 64):
    """Initialize (factor_model, a, b, noise, mu) from data.

    Mirrors ``preprocess.initialize`` (preprocess.py:4-46): FA on a row
    subsample drawn with replacement from valid bins, b = log(max(mean y,
    eps)), noise from the FA residual variance, per-trial mu from the FA
    transform.  ``generator`` must live on the data's device.
    """
    y = data.y.reshape(-1, data.ydim)
    mask = data.mask.reshape(-1)
    nvalid = y.shape[0]
    k = min(max(int(nvalid * subsample_frac), min_subsample), nvalid)
    ysub = y[_subsample_rows(mask, k, generator)]

    fm = fit_factor_analysis(ysub, zdim, n_iter=fa_iters)
    a = fm.a
    # masked mean rate per channel (preprocess.py:22)
    mean_y = torch.sum(y * mask[:, None], dim=0) / torch.clamp(mask.sum(), min=1.0)
    b0 = torch.log(torch.clamp(mean_y, min=eps))
    z_sub = fm.transform(ysub)
    noise = (ysub - z_sub @ a).var(dim=0, unbiased=False)
    mu = fm.transform(data.y) * data.mask[..., None]
    return fm, a, b0, noise, mu
