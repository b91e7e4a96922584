"""Configuration and model parameters.

Counterpart of ``vlgp_tpu/config.py``.  ``Config`` keeps every field and
default of the JAX package (the rationale for each default is recorded
there); ``Params`` is a dataclass of tensors instead of a flax pytree.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Config", "Params", "default_config", "make_params"]


@dataclasses.dataclass(frozen=True)
class Config:
    """Fit options (reference defaults: ``vlgp/preprocess.py:84-112``)."""

    # identifiability constraints (core.py:366-416)
    constrain_loading: str = "fro"  # "fro" | "svd" | <ord> | "none"
    constrain_latent: str = "none"  # "none" | "location" | "scale" | "both"
    # optimization
    use_hessian: bool = True
    eps: float = 1e-8
    tol: float = 1e-8
    min_iter: int = 5
    method: str = "VB"  # "VB" | "MAP"
    learning_rate: float = 1.0
    max_iter: int = 20
    Eniter: int = 25
    Mniter: int = 25
    Hstep: bool = True
    # adaptive E-step / M-step exits (0 = reference-matched fixed count)
    estep_tol: float = 3e-3
    mstep_tol: float = 5e-3
    # update clipping (core.py:91, 200, 218)
    da_bound: float = 5.0
    db_bound: float = 5.0
    dmu_bound: float = 5.0
    # hyperparameter search box for omega = 1/(2*timescale^2) (gp.py:84)
    omega_bound: Tuple[float, float] = (5e-4, 5e-2)
    # trial segmentation window (util.py:457-499)
    window: int = 50
    # H-step optimizer (models/gp.py:hstep)
    hyper_iters: int = 24
    hyper_polish: bool = False
    hyper_refines: int = 2
    hyper_interval: int = 2
    hyper_trust: float = 4.0
    hyper_grid: int = 13
    hyper_window: float = 0.0
    hyper_tiebreak: float = 1e-4
    hyper_learn_sigma: bool = True
    # Newton-Schulz iteration counts (ops/spd.py): cold start, and warm
    # refinements inside the E-step sweep loop
    ns_iters: int = 16
    ns_warm_iters: int = 4
    omega_init: str = "staggered"
    # ELBO tracking (runtime["elbo"], evaluation.elbo_terms per EM
    # iteration) and the convergence test: "norms" (core.py:350-359) or an
    # ELBO stall |dELBO| <= tol |ELBO|
    track_elbo: bool = False
    convergence: str = "norms"
    # checkpointing: fit(path=...) wires a callback.Saver
    saving_interval: float = 1800.0
    path: Optional[str] = None
    # numerics
    dtype: str = "float32"
    seed: int = 0

    def __post_init__(self):
        if self.method not in ("VB", "MAP"):
            raise ValueError(f"method must be 'VB' or 'MAP', got {self.method!r}")
        if self.window is not None and self.window < 1:
            raise ValueError("window must be a positive int or None")
        if self.max_iter < 1:
            raise ValueError("max_iter must be >= 1")
        if self.hyper_interval < 1:
            raise ValueError(
                f"hyper_interval must be >= 1, got {self.hyper_interval}"
            )
        if self.convergence not in ("norms", "elbo"):
            raise ValueError(
                f"convergence must be 'norms' or 'elbo', got {self.convergence!r}"
            )
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"dtype must be 'float32' or 'float64', got {self.dtype!r}")

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def default_config(**kwargs) -> Config:
    """Build a :class:`Config`, raising on unknown keys."""
    valid = {f.name for f in dataclasses.fields(Config)}
    unknown = set(kwargs) - valid
    if unknown:
        raise TypeError(f"unknown config option(s): {sorted(unknown)}")
    return Config(**kwargs)


@dataclasses.dataclass(frozen=True)
class Params:
    """Model parameters (reference ``params`` dict, ``vlgp/preprocess.py:49-81``).

      a        (zdim, ydim)   loading matrix
      b        (xdim, ydim)   bias / history filter coefficients
      noise    (ydim,)        Gaussian channel observation variance
      sigma    (zdim,)        GP output scale
      omega    (zdim,)        GP inverse squared lengthscale 1/(2*tau^2)
      poisson  (ydim,) bool   per-channel likelihood mask (True=poisson)
      da, db                  last M-step updates (convergence check)
      active   (ydim,) bool   optional: False pins a channel to its state
    """

    a: torch.Tensor
    b: torch.Tensor
    noise: torch.Tensor
    sigma: torch.Tensor
    omega: torch.Tensor
    poisson: torch.Tensor
    da: torch.Tensor
    db: torch.Tensor
    active: Optional[torch.Tensor] = None
    gp_noise: float = 1e-4
    dt: float = 1.0
    rank: int = 50
    # "poisson", "gaussian" or "mixed": lets the M-step skip the unused
    # update family
    likelihood_kind: str = "mixed"

    @property
    def zdim(self) -> int:
        return self.a.shape[0]

    @property
    def ydim(self) -> int:
        return self.a.shape[1]

    @property
    def xdim(self) -> int:
        return self.b.shape[0]

    def replace(self, **kw) -> "Params":
        return dataclasses.replace(self, **kw)


def _resolve_device(device, caller: str) -> torch.device:
    """``device``, or CUDA when it is None; raises when CUDA is asked for
    and missing instead of falling back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"vlgp_tpu_torch.{caller} runs on a CUDA device by default and "
                           "none is available; pass device='cpu' to run on the CPU")
    return device


def _tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def make_params(
    ydim: int,
    zdim: int,
    xdim: int = 1,
    likelihood: Sequence[str] | str = "poisson",
    *,
    a=None,
    b=None,
    noise=None,
    sigma=None,
    omega=None,
    omega_bound: Tuple[float, float] = (5e-4, 5e-2),
    rank: int = 50,
    gp_noise: float = 1e-4,
    dt: float = 1.0,
    dtype: torch.dtype = torch.float32,
    device="cpu",
) -> Params:
    """Parameter defaults, mirroring ``vlgp/preprocess.py:49-81``.

    omega defaults to the *upper* omega bound (``preprocess.py:74``).
    """
    if isinstance(likelihood, str):
        likelihood = [likelihood] * ydim
    if len(likelihood) != ydim:
        raise ValueError("likelihood must have one entry per channel")
    for lik in likelihood:
        if lik not in ("poisson", "gaussian"):
            raise ValueError(f"unknown likelihood {lik!r}")
    poisson = torch.tensor([lik == "poisson" for lik in likelihood], device=device)
    if all(lik == "poisson" for lik in likelihood):
        kind = "poisson"
    elif all(lik == "gaussian" for lik in likelihood):
        kind = "gaussian"
    else:
        kind = "mixed"

    def arr(x, shape, fill):
        if x is None:
            return torch.full(shape, fill, dtype=dtype, device=device)
        return _tensor(x, dtype, device)

    a = arr(a, (zdim, ydim), 0.0)
    b = arr(b, (xdim, ydim), 0.0)
    return Params(
        a=a,
        b=b,
        noise=arr(noise, (ydim,), 1.0),
        sigma=arr(sigma, (zdim,), 1.0),
        omega=arr(omega, (zdim,), omega_bound[1]),
        poisson=poisson,
        da=torch.zeros_like(a),
        db=torch.zeros_like(b),
        gp_noise=gp_noise,
        dt=dt,
        rank=rank,
        likelihood_kind=kind,
    )
