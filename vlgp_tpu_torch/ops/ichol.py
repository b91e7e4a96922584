"""Low-rank SE-kernel prior factors (counterpart of ``vlgp_tpu/ops/ichol.py``).

``ichol_gauss_batch`` is the greedy-pivoted incomplete Cholesky of
``vlgp/math.py:76-126``, written with the latent batch as a leading tensor
dimension: ``rank`` sequential steps of O(Z n) vector work, with pivots
chosen on the device (no host round trip per step).
``nystrom_gauss_batch`` is the one-Cholesky landmark factor used for the
window segments, with the same per-latent fallback to ichol when the
landmark Cholesky fails.  ``ichol`` is the same pivoted factorization of a
general PSD matrix (``vlgp/math.py:129-169``).
"""
from __future__ import annotations

import numpy as np
import torch

from . import control

__all__ = ["ichol_gauss", "ichol_gauss_batch", "ichol", "nystrom_gauss_batch"]


def _as_omega(omega) -> torch.Tensor:
    """omega as a float32 or float64 tensor: tensors and arrays keep their
    precision, Python numbers become float64, other types float32."""
    if not isinstance(omega, (torch.Tensor, np.ndarray)):
        omega = np.asarray(omega, np.float64)
    omega = torch.as_tensor(omega)
    if omega.dtype not in (torch.float32, torch.float64):
        omega = omega.to(torch.float32)
    return omega


def ichol_gauss_batch(n: int, omega, rank: int, dt: float = 1.0,
                      tol: float = 1e-10) -> torch.Tensor:
    """Incomplete Cholesky G of the SE kernel per latent: K_l ~= G_l G_l'.

    K[i, j] = exp(-omega_l * ((i - j) * dt)^2) on a regular n-point grid.
    omega: (Z,) -> (Z, n, rank).  Exhausted pivots (d <= tol) give zero
    columns, the fixed-rank equivalent of the reference's early stop.
    """
    omega = _as_omega(omega)
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
        # greedy pivot: largest remaining diagonal (math.py:106-110)
        jast = torch.argmax(torch.where(rows >= i, d, neg_inf), dim=1)  # (Z,)
        # swap i <-> jast in pvec, d and the rows of G
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
        # next kernel column in pivoted order (math.py:115-117)
        xp = x[pvec]  # (Z, n)
        nextcol = torch.exp(-omega[:, None] * (xp - xp[:, i:i + 1]) ** 2)
        # subtract the projection onto previous columns (math.py:118)
        prev = torch.where(cols < i, G[:, i, :], zero)  # (Z, rank)
        proj = torch.einsum("znr,zr->zn", G, prev)
        newcol = torch.where(alive[:, None], (nextcol - proj) / gii[:, None], zero)
        below = rows > i
        G[:, :, i] = torch.where(below, newcol, G[:, :, i])
        # refresh the remaining diagonal (math.py:119)
        dnew = 1.0 - torch.sum(G[:, :, : i + 1] ** 2, dim=2)
        d = torch.where(below, dnew, d)
    # un-permute rows: out[pvec[k]] = G[k]  (math.py:126)
    out = torch.zeros_like(G)
    out.scatter_(1, pvec[:, :, None].expand(Z, n, rank), G)
    return out


def ichol_gauss(n: int, omega, rank: int, dt: float = 1.0,
                tol: float = 1e-10) -> torch.Tensor:
    """Single-latent :func:`ichol_gauss_batch`: scalar omega -> (n, rank)."""
    omega = _as_omega(omega)
    return ichol_gauss_batch(n, omega.reshape(1), rank, dt, tol)[0]


def nystrom_gauss_batch(n: int, omega, rank: int, dt: float = 1.0,
                        jitter: float = 2e-5) -> torch.Tensor:
    """Low-rank SE factor via Nystrom with evenly spaced landmarks:
    G = K[:, J] chol(K[J, J] + jitter I)^-T, one batched (rank x rank)
    Cholesky instead of ``rank`` sequential pivot steps (see the JAX
    package's docstring for the accuracy analysis).

    A latent whose landmark Cholesky fails or whose factor is not finite
    falls back to the exact pivoted ichol (``vlgp_tpu/ops/ichol.py:143-158``);
    the check is a ``control.cond``, an IF node under a CUDA graph capture.
    omega: (Z,) -> (Z, n, rank).
    """
    omega = _as_omega(omega)
    dtype, device = omega.dtype, omega.device
    rank = min(rank, n)
    J = (torch.arange(rank, device=device) * n) // rank  # distinct, evenly spaced
    x = torch.arange(n, dtype=dtype, device=device) * dt
    xJ = x[J]
    om = omega[:, None, None]
    K_nJ = torch.exp(-om * (x[:, None] - xJ[None, :]) ** 2)  # (Z, n, R)
    K_JJ = torch.exp(-om * (xJ[:, None] - xJ[None, :]) ** 2)  # (Z, R, R)
    eye = torch.eye(rank, dtype=dtype, device=device)
    L, info = torch.linalg.cholesky_ex(K_JJ + jitter * eye)
    # G = K_nJ L^{-T}: solve X L' = K_nJ
    G = torch.linalg.solve_triangular(L.mT, K_nJ, upper=True, left=False)
    finite = torch.isfinite(G).all(dim=(1, 2)) & (info == 0)  # (Z,)
    return control.cond(finite.all(), lambda: G,
                        lambda: torch.where(finite[:, None, None], G,
                                            ichol_gauss_batch(n, omega, rank, dt)))


def ichol(A, rank: int | None = None, tol: float = 1e-10) -> torch.Tensor:
    """Pivoted incomplete Cholesky of a general PSD matrix, A ~= G G'
    (``vlgp_tpu/ops/ichol.py:161-202``, reference ``math.py:129-169``).

    ``rank`` sequential steps (default n) of greedy max-diagonal pivoting on
    A's device; exhausted pivots (d <= tol) give zero columns.  Returns
    (n, rank)."""
    A = torch.as_tensor(A)
    n = A.shape[0]
    rank = n if rank is None else rank
    dtype, device = A.dtype, A.device
    rows = torch.arange(n, device=device)
    cols = torch.arange(rank, device=device)
    G = torch.zeros((n, rank), dtype=dtype, device=device)
    diagA = torch.diagonal(A)
    d = diagA.clone()
    pvec = rows.clone()
    zero = torch.zeros((), dtype=dtype, device=device)
    neg_inf = torch.full((), -float("inf"), dtype=dtype, device=device)
    for i in range(min(rank, n)):
        # greedy pivot: largest remaining diagonal, swapped into place i
        jast = torch.argmax(torch.where(rows >= i, d, neg_inf))
        perm = rows.clone()
        perm.scatter_(0, jast[None], i)
        perm[i] = jast
        pvec, d, G = pvec[perm], d[perm], G[perm]

        alive = d[i] > tol
        gii = torch.sqrt(torch.clamp(d[i], min=tol))
        G[i, i] = torch.where(alive, gii, zero)
        nextcol = A[pvec, pvec[i]]
        prev = torch.where(cols < i, G[i], zero)
        newcol = torch.where(alive, (nextcol - G @ prev) / gii, zero)
        below = rows > i
        G[:, i] = torch.where(below, newcol, G[:, i])
        dnew = diagA[pvec] - torch.sum(G[:, : i + 1] ** 2, dim=1)
        d = torch.where(below, dnew, d)
    # un-permute rows: out[pvec[k]] = G[k]
    out = torch.zeros_like(G)
    out[pvec] = G
    return out
