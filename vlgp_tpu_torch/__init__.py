"""vlgp_tpu_torch: variational Latent Gaussian Process in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

A port of ``vlgp_tpu`` (JAX on a TPU), which stays in the repository as
the reference.  This package imports neither JAX nor ``vlgp_tpu``.
"""
from . import evaluation, model_selection, simulation
from .api import FitResult, fastfit, fit, map2vi, resume, sample_posterior, transform
from .config import Config, Params, default_config, make_params
from .data import TrialSet, cut_trials, pack_trials, unpack_trials
from .models import gpfa

__all__ = [
    "fit",
    "transform",
    "sample_posterior",
    "fastfit",
    "map2vi",
    "resume",
    "FitResult",
    "Config",
    "Params",
    "default_config",
    "make_params",
    "TrialSet",
    "pack_trials",
    "cut_trials",
    "unpack_trials",
    "evaluation",
    "model_selection",
    "simulation",
    "gpfa",
]
