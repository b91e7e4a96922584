"""Elementary math ops (counterpart of ``vlgp_tpu/ops/math.py``; reference
``vlgp/math.py``, ``vlgp/util.py``).

Tensor one-liners plus the SVD orthogonalization and the subspace angle.
Each runs on the device of its tensor input.
"""
from __future__ import annotations

import torch

__all__ = [
    "rectify",
    "trunc_exp",
    "log1exp",
    "identity",
    "sqexpcov",
    "orth",
    "subspace",
    "add_diag",
    "lexp",
    "clip",
]


def rectify(x: torch.Tensor) -> torch.Tensor:
    """Rectified-linear link (``math.py:14-21``)."""
    return torch.clamp(x, min=0.0)


def trunc_exp(x: torch.Tensor, bound: float = 10.0) -> torch.Tensor:
    """exp with the argument clipped from above (``math.py:24-38``).

    Keeps Poisson rates finite during early, badly-scaled iterations.
    """
    return torch.exp(torch.clamp(x, max=bound))


def log1exp(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) (``math.py:61-73``), numerically stable."""
    return torch.logaddexp(x, torch.zeros_like(x))


def identity(x):
    return x


def sqexpcov(n: int, w, var=1.0, dt: float = 1.0, dtype=torch.float32, device="cpu"):
    """Dense squared-exponential covariance on a regular grid,
    K[i, j] = var * exp(-w * ((i - j) * dt)^2)   (``util.py:40-53``)."""
    t = torch.arange(n, dtype=dtype, device=device) * dt
    dsq = (t[:, None] - t[None, :]) ** 2
    return var * torch.exp(-w * dsq)


def orth(x: torch.Tensor, a: torch.Tensor):
    """Orthogonalize the loading rows and rotate the latents so that
    x @ a is unchanged (``math.py:201-215``): returns (x_orth, a_orth)."""
    _, _, vh = torch.linalg.svd(a, full_matrices=False)
    return x @ a @ vh.T, vh


def subspace(a: torch.Tensor, b: torch.Tensor, deg: bool = True) -> torch.Tensor:
    """Largest principal angle between the column spaces of a and b
    (``math.py:172-198``, MATLAB's ``subspace``)."""
    qa, _ = torch.linalg.qr(a)
    qb, _ = torch.linalg.qr(b)
    if qa.shape[1] < qb.shape[1]:
        qa, qb = qb, qa
    qb = qb - qa @ (qa.T @ qb)
    s = torch.linalg.matrix_norm(qb, ord=2)
    rad = torch.arcsin(torch.clamp(s, 0.0, 1.0))
    return torch.rad2deg(rad) if deg else rad


def add_diag(m: torch.Tensor, v) -> torch.Tensor:
    """m with v added to its diagonal (``math.py:218-221``, not in place);
    v is a scalar or a vector over the trailing dim, broadcast over the
    leading batch dims of m."""
    eye = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device)
    v = torch.as_tensor(v, dtype=m.dtype, device=m.device)
    if v.ndim == 0:
        return m + v * eye
    return m + eye * v[..., None, :]


def lexp(x: torch.Tensor, c: float = 0.0) -> torch.Tensor:
    """Linearized exp: exp(x) below c, its first-order expansion above
    (``math.py:41-43``, vectorized)."""
    ec = torch.exp(torch.as_tensor(c, dtype=x.dtype, device=x.device))
    return torch.where(x < c, torch.exp(torch.clamp(x, max=c)), ec * (1.0 - c + x))


def clip(a: torch.Tensor, lbound, ubound=None) -> torch.Tensor:
    """Symmetric (one bound) or box clip, not in place (``util.py:446-454``)."""
    if ubound is None:
        lbound, ubound = -lbound, lbound
    return torch.clamp(a, lbound, ubound)
