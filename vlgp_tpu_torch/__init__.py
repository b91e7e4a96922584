"""vlgp_tpu_torch: variational Latent Gaussian Process in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

A port of ``vlgp_tpu`` (JAX on a TPU), which stays in the repository as
the reference.  This package imports neither JAX nor ``vlgp_tpu``.
"""
from .api import FitResult, fit, transform
from .config import Config, Params, default_config, make_params
from .data import TrialSet, cut_trials, pack_trials, unpack_trials

__all__ = [
    "fit",
    "transform",
    "FitResult",
    "Config",
    "Params",
    "default_config",
    "make_params",
    "TrialSet",
    "pack_trials",
    "cut_trials",
    "unpack_trials",
]
