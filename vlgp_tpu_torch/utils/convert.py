"""Carry parameters and trial state between the JAX package and the port.

Both sides exchange plain NumPy arrays, so neither package imports the
other: the tests turn ``vlgp_tpu``'s ``Params``, ``TrialSet``,
``FactorModel``, ``FitResult`` state and GPFA ``(C, d, R, K)`` into arrays
and feed the same state to both.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from ..api import FitResult
from ..config import Config, Params
from ..data import TrialSet
from ..init import FactorModel

__all__ = ["params_from_numpy", "params_to_numpy", "trialset_from_numpy",
           "trialset_to_numpy", "factor_model_from_numpy", "gpfa_from_numpy",
           "fit_result_from_numpy"]

_PARAM_ARRAYS = ("a", "b", "noise", "sigma", "omega", "poisson", "da", "db", "active")
_PARAM_STATIC = ("gp_noise", "dt", "rank", "likelihood_kind")
_INT_FIELDS = ("trial_idx", "start", "lengths")


def _float_tensor(arr, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """A float tensor of ``arr``: float64 arrays stay float64 and the rest
    become float32, unless ``dtype`` is given."""
    arr = np.asarray(arr)
    if dtype is None:
        dtype = torch.float64 if arr.dtype == np.float64 else torch.float32
    return torch.tensor(arr, dtype=dtype, device=device)


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
            kw[name] = _float_tensor(arr, device, dtype)
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
            kw[f.name] = _float_tensor(arr, device, dtype)
    return TrialSet(**kw)


def trialset_to_numpy(data: TrialSet) -> dict:
    """Inverse of :func:`trialset_from_numpy`."""
    return {f.name: getattr(data, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(TrialSet)}


def factor_model_from_numpy(arrays: Mapping[str, np.ndarray], *, device="cpu",
                            dtype: Optional[torch.dtype] = None) -> FactorModel:
    """A :class:`FactorModel` from its ``mean``, ``a`` and ``psi`` arrays."""
    return FactorModel(**{k: _float_tensor(arrays[k], device, dtype)
                          for k in ("mean", "a", "psi")})


def gpfa_from_numpy(C, d, R, K, *, device="cpu", dtype: Optional[torch.dtype] = None):
    """GPFA's loading C (z, ydim), offset d (ydim,), noise R ((ydim,) or
    (ydim, ydim)) and prior K (n, n) as tensors."""
    return tuple(_float_tensor(x, device, dtype) for x in (C, d, R, K))


def fit_result_from_numpy(data: Mapping[str, np.ndarray], params: Mapping, G, config: Mapping,
                          *, device="cpu", dtype: Optional[torch.dtype] = None):
    """A :class:`~vlgp_tpu_torch.api.FitResult` from a fit's state: the
    TrialSet's arrays, the Params' arrays and static fields (as
    :func:`params_to_numpy` gives them), the prior factors G and the Config's
    fields (0-d arrays are taken as scalars).  It carries no factor model
    and an empty runtime."""
    params = dict(params)
    static = {k: params.pop(k) for k in _PARAM_STATIC if k in params}
    static = {k: (v.item() if isinstance(v, np.ndarray) else v) for k, v in static.items()}
    return FitResult(
        data=trialset_from_numpy(data, device=device, dtype=dtype),
        params=params_from_numpy(params, device=device, dtype=dtype, **static),
        config=Config(**config),
        factor_model=None,
        G=_float_tensor(G, device, dtype),
        runtime={},
    )
