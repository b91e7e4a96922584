"""vlgp_tpu_torch: variational Latent Gaussian Process in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

A port of ``vlgp_tpu`` (JAX on a TPU), which stays in the repository as
the reference.  This package imports neither JAX nor ``vlgp_tpu``.
"""
import logging as _logging

from . import evaluation, model_selection, simulation
from .api import FitResult, fastfit, fit, map2vi, resume, sample_posterior, transform
from .config import Config, Params, default_config, make_params
from .data import TrialSet, cut_trials, pack_trials, unpack_trials
from .models import gpfa
from .utils.io import load, load_reference, load_reference_trials, save

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
    "save",
    "load",
    "load_reference",
    "load_reference_trials",
    "evaluation",
    "model_selection",
    "simulation",
    "gpfa",
]

__version__ = "0.1.0"

# Structured logging to stderr by default; the reference appends to a file
# `vlgp.log` as an import side effect (vlgp/__init__.py:7-12): opt in via
# vlgp_tpu_torch.enable_file_logging() instead.
logger = _logging.getLogger("vlgp_tpu_torch")


def enable_file_logging(path: str = "vlgp_tpu_torch.log", level=_logging.INFO) -> None:
    handler = _logging.FileHandler(path)
    handler.setFormatter(
        _logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    )
    logger.addHandler(handler)
    logger.setLevel(level)
