"""Misc utilities: smoothing, binning, rotations, timescale transform
(counterpart of ``vlgp_tpu/utils/misc.py``).

Reference: ``vlgp/util.py`` (varimax/orthomax/promax at 56-85 and
211-318; smoothing at 385-392; spike binning at 515-538; timescale
transform at 429-443).  Tensor inputs keep their device; arrays and lists
become CPU tensors.
"""
from __future__ import annotations

import functools
import logging

import numpy as np
import torch

__all__ = [
    "smooth",
    "smooth_1d",
    "count",
    "transform_timescale",
    "varimax",
    "orthomax",
    "promax",
    "rotate",
    "trial_slices",
    "log_calls",
    "ensure_generator",
]


def _gauss_kernel(sigma: float, radius_mult: float, dtype, device) -> torch.Tensor:
    radius = int(radius_mult * sigma + 0.5)
    t = torch.arange(-radius, radius + 1, dtype=dtype, device=device)
    kern = torch.exp(-0.5 * (t / sigma) ** 2)
    return kern / torch.sum(kern)


def _convolve_same(x: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """``np.convolve(row, kern, mode="same")`` for every row of x (..., N):
    the centre max(N, K) entries of the full convolution."""
    N, K = x.shape[-1], kern.shape[0]
    lead = x.shape[:-1]
    rows = x.reshape(-1, 1, N)
    full = torch.nn.functional.conv1d(
        torch.nn.functional.pad(rows, (K - 1, K - 1)), kern.flip(0).reshape(1, 1, K))
    start = (min(N, K) - 1) // 2
    return full[:, 0, start:start + max(N, K)].reshape(*lead, max(N, K))


def smooth_1d(x, sigma: float = 10.0, radius_mult: float = 4.0) -> torch.Tensor:
    """Gaussian smoothing of a 1-D signal (util.py:385-388), zero-padded
    boundaries (scipy ``mode='constant'``)."""
    x = torch.as_tensor(x)
    return _convolve_same(x, _gauss_kernel(sigma, radius_mult, x.dtype, x.device))


def smooth(x, sigma: float = 10.0) -> torch.Tensor:
    """Column-wise Gaussian smoothing (util.py:391-392)."""
    x = torch.as_tensor(x)
    kern = _gauss_kernel(sigma, 4.0, x.dtype, x.device)
    return _convolve_same(x.T, kern).T


def count(t, binwidth, start=None, stop=None) -> np.ndarray:
    """Bin spike times into counts (util.py:515-538); NumPy in and out."""
    t = np.asarray(t)
    if t.size == 0:
        return np.array([np.nan])
    start = np.min(t) if start is None else start
    stop = np.max(t) if stop is None else stop
    nbin = int(np.ceil((stop - start) / binwidth)) if stop > start else 1
    bins = start + np.arange(nbin + 1) * binwidth
    return np.histogram(t, bins=bins)[0]


def transform_timescale(timescale, dt):
    """timescale -> omega = 0.5 * (dt / timescale)^2 (util.py:429-443)."""
    return 0.5 * (dt / torch.as_tensor(timescale)) ** 2


def varimax(x, normalize: bool = True, tol: float = 1e-5, niter: int = 1000):
    """Varimax loading rotation (util.py:259-318, R port): (rotated, T).
    Stops when the criterion grows by less than a factor 1 + tol."""
    x = torch.as_tensor(x)
    p, nc = x.shape
    eye = torch.eye(nc, dtype=x.dtype, device=x.device)
    if nc < 2:
        return x, eye
    if normalize:
        sc = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
        x = x / sc
    TT = eye
    d = 0.0
    for _ in range(niter):
        z = x @ TT
        B = x.T @ (z ** 3 - z @ torch.diag(torch.sum(z ** 2, dim=0)) / p)
        u, s, vh = torch.linalg.svd(B, full_matrices=False)
        TT = u @ vh
        dpast = d
        d = float(torch.sum(s))
        if d < dpast * (1 + tol):
            break
    z = x @ TT
    if normalize:
        z = z * sc
    return z, TT


def orthomax(A, gamma: float = 1.0, normalize: bool = True, rtol: float = 1e-8,
             maxit: int = 250, generator=None):
    """Orthomax rotation family (util.py:211-256): (rotated, T).

    A degenerate start, where the first SVD step lands on the identity (a
    zero-gradient point), restarts from a random orthogonal rotation drawn
    from ``generator`` (an int seed or a ``torch.Generator``, default seed
    0; ``vlgp_tpu`` takes a PRNG key here, and the two draws differ)."""
    A = torch.as_tensor(A)
    n, m = A.shape
    if normalize:
        h = torch.sqrt(torch.sum(A ** 2, dim=1, keepdim=True))
        A = A / h
    T = torch.eye(m, dtype=A.dtype, device=A.device)
    B = A @ T
    s = 0.0
    for it in range(maxit):
        s_old = s
        L, sv, M = torch.linalg.svd(
            A.T @ (n * B ** 3 - gamma * B @ torch.diag(torch.sum(B ** 2, dim=0))),
            full_matrices=False)
        T_new = L @ M
        if it == 0 and float(torch.linalg.norm(T_new - T)) < rtol:
            gen = ensure_generator(0 if generator is None else generator, A.device)
            T, _ = torch.linalg.qr(torch.randn((m, m), generator=gen, dtype=A.dtype,
                                               device=A.device))
            B = A @ T
            continue
        T = T_new
        s = float(torch.sum(sv))
        B = A @ T
        if (s - s_old) < rtol * s:
            break
    if normalize:
        B = B * h
    return B, T


def _lstsq(a, b):
    """Least-squares solution of a @ x = b: SVD-based on the CPU, as
    ``jnp.linalg.lstsq``; CUDA offers only QR (full-rank a)."""
    driver = "gelsd" if a.device.type == "cpu" else None
    return torch.linalg.lstsq(a, b, driver=driver).solution


def promax(x, m: int = 4):
    """Promax oblique rotation (util.py:56-85, R port, with the power
    ``x * abs(x)^(m-1)`` that the reference's port drops): (rotated, T)."""
    x = torch.as_tensor(x)
    if x.shape[1] < 2:
        return x, torch.eye(x.shape[1], dtype=x.dtype, device=x.device)
    xT, TT = varimax(x)
    Q = xT * torch.abs(xT) ** (m - 1)
    U = _lstsq(xT, Q)
    d = torch.diagonal(torch.linalg.inv(U.T @ U))
    U = U @ torch.diag(torch.sqrt(d))
    return xT @ U, TT @ U


def rotate(x, y):
    """Least-squares alignment of x onto y (util.py:108-118)."""
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    return x @ _lstsq(x, y)


def trial_slices(trial_lengths):
    """Slices of each trial inside a concatenated array (util.py:321-331)."""
    ends = np.cumsum([0] + list(trial_lengths))
    return [slice(int(ends[i]), int(ends[i + 1])) for i in range(len(trial_lengths))]


def log_calls(f):
    """Decorator logging each call (util.py:420-426)."""
    logger = logging.getLogger("vlgp_tpu_torch")

    @functools.wraps(f)
    def wrapper(*args, **kwargs):
        logger.info("%s is called", f.__name__)
        return f(*args, **kwargs)

    return wrapper


def ensure_generator(seed_or_generator, device=None) -> torch.Generator:
    """An int seed or a ``torch.Generator`` in, a ``torch.Generator`` out
    (the counterpart of ``vlgp_tpu.utils.misc.ensure_key``, and of the
    reference's check_random_state, util.py:502-512).  A seed makes a
    generator on ``device`` (default the CPU)."""
    if isinstance(seed_or_generator, torch.Generator):
        return seed_or_generator
    gen = torch.Generator(device=device if device is not None else "cpu")
    gen.manual_seed(int(seed_or_generator))
    return gen
