"""Design-matrix builders for spike-history / autoregressive regressors
(counterpart of ``vlgp_tpu/utils/design.py``).

Reference: ``vlgp/util.py:20-37, 88-157, 333-382``, with shifted copies
instead of per-row Python loops.  Tensor inputs keep their device; arrays
and lists become CPU tensors.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

__all__ = ["lagmat", "add_constant", "history", "makeregressor", "auto", "regmat"]


def lagmat(x, lag: int) -> torch.Tensor:
    """Autoregression matrix: column block j holds x lagged by j+1, zeros
    before the start (util.py:135-157)."""
    x = torch.as_tensor(x)
    if x.ndim < 2:
        x = x[:, None]
    nrow = x.shape[0]
    if lag >= nrow:
        raise ValueError("lag should be < nrow")
    cols = [torch.nn.functional.pad(x, (0, 0, k, 0))[:nrow] for k in range(1, lag + 1)]
    if not cols:
        return torch.zeros((nrow, 0), dtype=x.dtype, device=x.device)
    return torch.cat(cols, dim=1)


def add_constant(x) -> torch.Tensor:
    """Prepend an all-ones column (util.py:121-132)."""
    x = torch.as_tensor(x)
    return torch.column_stack([torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device), x])


def history(obs, lag: int) -> torch.Tensor:
    """Per-channel autoregressive design (util.py:88-105):
    obs (ntime, nchannel) -> (nchannel, ntime, 1 + lag)."""
    obs = torch.as_tensor(obs)
    return torch.stack([add_constant(lagmat(obs[:, n], lag)) for n in range(obs.shape[1])])


def makeregressor(obs, p: int) -> torch.Tensor:
    """Full cross-history design (util.py:20-37): (T, 1 + p*N), float64,
    built on the host."""
    obs = np.asarray(obs)
    T, N = obs.shape
    reg = np.ones((T, 1 + p * N), float)
    for t in range(T):
        if t - p >= 0:
            reg[t, 1:] = obs[t - p: t, :].flatten()
        else:
            reg[t, 1 + (p - t) * N:] = obs[:t, :].flatten()
    return torch.from_numpy(reg)


def auto(y: List, lag: int) -> torch.Tensor:
    """Stacked per-channel autoregressive designs across trials
    (util.py:333-350): (ydim, total_time, 1 + lag)."""
    if len(y) == 0:
        raise ValueError("no trials given")
    return torch.cat([history(trial, lag) for trial in y], dim=1)


def regmat(y: List, x: Optional[List], lag: int = 0) -> torch.Tensor:
    """Autoregressive plus external regressors (util.py:363-382):
    (ydim, total_time, 1 + lag + xdim)."""
    automat = auto(y, lag)
    big_x = torch.cat([torch.as_tensor(t) for t in x], dim=0).to(automat)
    tiled = big_x[None].expand((automat.shape[0],) + big_x.shape)
    return torch.cat([automat, tiled], dim=2)
