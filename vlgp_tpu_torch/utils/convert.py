"""Carry parameters and trial state between the JAX package and the port.

Both sides exchange plain NumPy arrays, so neither package imports the
other: the tests turn ``vlgp_tpu``'s ``Params`` and ``TrialSet`` into
dicts of arrays and feed the same state to both.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from ..config import Params
from ..data import TrialSet

__all__ = ["params_from_numpy", "params_to_numpy", "trialset_from_numpy",
           "trialset_to_numpy"]

_PARAM_ARRAYS = ("a", "b", "noise", "sigma", "omega", "poisson", "da", "db", "active")
_PARAM_STATIC = ("gp_noise", "dt", "rank", "likelihood_kind")
_INT_FIELDS = ("trial_idx", "start", "lengths")


def _float_dtype(arr: np.ndarray, dtype: Optional[torch.dtype]) -> torch.dtype:
    if dtype is not None:
        return dtype
    return torch.float64 if arr.dtype == np.float64 else torch.float32


def params_from_numpy(arrays: Mapping[str, np.ndarray], *, device="cpu",
                      dtype: Optional[torch.dtype] = None, **static) -> Params:
    """Build a :class:`Params` from a dict of arrays keyed by field name.

    ``static`` carries the scalar fields (``gp_noise``, ``dt``, ``rank``,
    ``likelihood_kind``).  Float arrays keep their precision unless
    ``dtype`` is given; ``poisson`` and ``active`` become bool tensors.
    """
    unknown = set(static) - set(_PARAM_STATIC)
    if unknown:
        raise TypeError(f"unknown static Params field(s): {sorted(unknown)}")
    kw = {}
    for name in _PARAM_ARRAYS:
        arr = arrays.get(name)
        if arr is None:
            kw[name] = None
            continue
        arr = np.asarray(arr)
        if name in ("poisson", "active"):
            kw[name] = torch.tensor(arr.astype(bool), device=device)
        else:
            kw[name] = torch.tensor(arr, dtype=_float_dtype(arr, dtype), device=device)
    return Params(**kw, **static)


def params_to_numpy(params: Params) -> dict:
    """Inverse of :func:`params_from_numpy`: arrays and static fields."""
    out = {}
    for name in _PARAM_ARRAYS:
        t = getattr(params, name)
        out[name] = None if t is None else t.detach().cpu().numpy()
    for name in _PARAM_STATIC:
        out[name] = getattr(params, name)
    return out


def trialset_from_numpy(arrays: Mapping[str, np.ndarray], *, device="cpu",
                        dtype: Optional[torch.dtype] = None) -> TrialSet:
    """Build a :class:`TrialSet` from a dict of arrays keyed by field name."""
    kw = {}
    for f in dataclasses.fields(TrialSet):
        arr = np.asarray(arrays[f.name])
        if f.name in _INT_FIELDS:
            kw[f.name] = torch.tensor(arr.astype(np.int32), device=device)
        else:
            kw[f.name] = torch.tensor(arr, dtype=_float_dtype(arr, dtype), device=device)
    return TrialSet(**kw)


def trialset_to_numpy(data: TrialSet) -> dict:
    """Inverse of :func:`trialset_from_numpy`."""
    return {f.name: getattr(data, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(TrialSet)}
