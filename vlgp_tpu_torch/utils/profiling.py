"""Named trace regions (counterpart of ``vlgp_tpu/utils/profiling.py``)."""
from __future__ import annotations

import torch

__all__ = ["annotate"]


def annotate(name: str):
    """Named region that shows up in ``torch.profiler`` traces."""
    return torch.profiler.record_function(name)
