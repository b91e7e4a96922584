"""Synthetic data generators (counterpart of ``vlgp_tpu/simulation.py``;
reference ``vlgp/simulation.py``).

The reference's per-bin loops with spike-history feedback
(simulation.py:47-58, 95-104) run as a loop over time steps, vectorised
over trials, on the target device: the device of the latents when they are
a tensor, else ``device`` (the current CUDA device when None).  Random
draws come from a ``torch.Generator`` on that device.  :func:`lorenz` runs
its step loop on the host for a CPU tensor and as one launch of the
``lorenz`` kernel (``csrc/lorenz.cu``) on the card.
"""
from __future__ import annotations

import ctypes

import torch

from .config import _resolve_device
from .ops.math import identity, trunc_exp
from .ops.spd import KERNEL_LAUNCHES, _ptr, _raise_on

__all__ = ["spike", "lfp", "lorenz"]


def _target(x, device, caller: str) -> torch.device:
    if device is None and isinstance(x, torch.Tensor):
        return x.device
    return _resolve_device(device, caller)


def _as3d(x):
    return x[None, ...] if x.ndim == 2 else x


def _simulate(x, a, b, draw, link):
    """Shared time loop of ``spike`` and ``lfp``: eta = z @ a + history * b,
    ``draw(mean)`` gives the bin's observations, which enter the history of
    the next bins.  Returns (y, h, mean) shaped as in :func:`spike`."""
    ntrial, ntime, _ = x.shape
    nchannel = a.shape[1]
    lag = b.shape[0] - 1
    h_t = torch.zeros((ntrial, nchannel, 1 + lag), dtype=x.dtype, device=x.device)
    h_t[:, :, 0] = 1.0
    y = torch.empty((ntrial, ntime, nchannel), dtype=x.dtype, device=x.device)
    h = torch.empty((ntime, ntrial, nchannel, 1 + lag), dtype=x.dtype, device=x.device)
    mean = torch.empty_like(y)
    for t in range(ntime):
        m_t = link(x[:, t] @ a + torch.einsum("mcj,jc->mc", h_t, b))
        y_t = draw(m_t)
        y[:, t], h[t], mean[:, t] = y_t, h_t, m_t
        if lag > 0:  # roll the history right, insert this bin (simulation.py:56-57)
            h_t = torch.cat([h_t[:, :, :1], y_t[:, :, None], h_t[:, :, 1:-1]], dim=2)
    return y, h.permute(2, 1, 0, 3), mean


def spike(x, a, b, generator: torch.Generator, link=trunc_exp, device=None):
    """Simulate spike trains with spike-history feedback (simulation.py:11-59).

    rate = link(z @ a + history * b);  y ~ min(Poisson(rate), 1)
    (the reference clips counts to {0, 1}, simulation.py:54).

    x: latents (ntrial, ntime, nlatent) or (ntime, nlatent)
    a: (nlatent, nchannel); b: (1 + lag, nchannel), row 0 the bias.
    Returns (y, h, rate): y, rate (ntrial, ntime, nchannel);
    h (nchannel, ntrial, ntime, 1 + lag).
    """
    device = _target(x, device, "simulation.spike")
    x = _as3d(torch.as_tensor(x, device=device))
    a = torch.as_tensor(a, dtype=x.dtype, device=device)
    b = torch.as_tensor(b, dtype=x.dtype, device=device)
    return _simulate(x, a, b, lambda rate: torch.clamp(
        torch.poisson(rate, generator=generator), max=1.0), link)


def lfp(x, a, b, K, generator: torch.Generator, link=identity, device=None):
    """Simulate Gaussian (LFP) observations with channel covariance K
    (simulation.py:62-105).  Returns (y, h, mean) shaped as in :func:`spike`."""
    device = _target(x, device, "simulation.lfp")
    x = _as3d(torch.as_tensor(x, device=device))
    a = torch.as_tensor(a, dtype=x.dtype, device=device)
    b = torch.as_tensor(b, dtype=x.dtype, device=device)
    L = torch.linalg.cholesky(torch.as_tensor(K, dtype=x.dtype, device=device))
    ntrial, nchannel = x.shape[0], a.shape[1]

    def draw(mean):
        eps = torch.randn((ntrial, nchannel), generator=generator, dtype=x.dtype,
                          device=device)
        return mean + eps @ L.T

    return _simulate(x, a, b, draw, link)


def _lorenz_plain(xs, dt, s, r, b) -> None:
    """Plain version of the ``lorenz`` kernel: the Euler steps from xs[0],
    one torch op at a time, into xs (n, 3)."""
    for i in range(xs.shape[0] - 1):
        x, y, z = xs[i]
        xs[i + 1] = xs[i] + dt * torch.stack([s * (y - x), r * x - y - x * z, x * y - b * z])


def _lorenz_cuda(xs, dt, s, r, b) -> None:
    """Launch the ``lorenz`` kernel (``csrc/lorenz.cu``, one thread) on the
    current stream: the Euler steps from xs[0] into xs (n, 3)."""
    from .ops._build import load_library

    if xs.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the lorenz kernel takes float32 or float64, got {xs.dtype}")
    lib = load_library("lorenz")
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        rc = lib.lorenz(_ptr(xs), xs.shape[0], int(xs.dtype == torch.float64), dt, s, r, b,
                        ctypes.c_void_p(stream))
    _raise_on(rc, lib, "lorenz")
    KERNEL_LAUNCHES["lorenz"] += 1


def lorenz(n: int, dt: float = 0.01, s: float = 10.0, r: float = 28.0,
           b: float = 2.667, x0=None, normalized: bool = False, *,
           dtype: torch.dtype = torch.float64, device=None):
    """Euler-integrated Lorenz attractor trajectory (simulation.py:108-151),
    (n, 3) on ``device`` (the current CUDA device when None).  With
    ``normalized`` it is centred and divided by each column's uncentred
    inf-norm, as the reference does.  On a CUDA device the steps run in one
    launch of the ``lorenz`` kernel, bit for bit the CPU's loop."""
    device = _resolve_device(device, "simulation.lorenz")
    if x0 is None:
        x0 = (0.0, 1.0, 1.05)
    xs = torch.empty((n, 3), dtype=dtype, device=device)
    xs[0] = torch.as_tensor(x0, dtype=dtype)
    if n > 1:
        (_lorenz_cuda if xs.is_cuda else _lorenz_plain)(xs, dt, s, r, b)
    if normalized:
        xs = (xs - xs.mean(dim=0)) / xs.abs().amax(dim=0)
    return xs
