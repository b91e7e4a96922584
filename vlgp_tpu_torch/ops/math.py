"""Elementary math ops on the fit path (counterpart of ``vlgp_tpu/ops/math.py``)."""
from __future__ import annotations

import torch

__all__ = ["trunc_exp", "identity"]


def trunc_exp(x: torch.Tensor, bound: float = 10.0) -> torch.Tensor:
    """exp with the argument clipped from above (``math.py:24-38``).

    Keeps Poisson rates finite during early, badly-scaled iterations.
    """
    return torch.exp(torch.clamp(x, max=bound))


def identity(x):
    return x
