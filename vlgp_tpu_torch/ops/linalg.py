"""The right singular vectors of the loading, for ``constrain_loading="svd"``.

Counterpart of ``jnp.linalg.svd(a, full_matrices=False)[2]`` in
``vlgp_tpu/models/vlgp.py:constrain_loading`` (XLA's SVD, no Pallas
kernel).  ``torch.linalg.svd`` reads its solver's info on the host, which a
CUDA graph capture refuses, so a CUDA tensor goes to the hand-written
kernel ``csrc/svd_loading.cu`` (the Gram's Jacobi eigen-decomposition in
one block, reading nothing back); a CPU tensor goes to the plain version,
``torch.linalg.svd``.  Both put the rows in descending singular value and
apply one sign convention: the entry of largest absolute value of each row
is positive (the first such entry on a tie).  A non-finite ``a`` gives a
NaN ``vh`` on both routes.
"""
from __future__ import annotations

import ctypes

import torch

from .spd import KERNEL_LAUNCHES, _ptr, _raise_on

__all__ = ["svd_loading", "Z_MAX"]

# largest number of rows (latents) the kernel takes: its Gram and
# eigenvectors sit in one block's shared memory
Z_MAX = 128


def _sign_convention(vh: torch.Tensor) -> torch.Tensor:
    """``vh`` with each row negated where its entry of largest absolute
    value (the first on a tie) is negative."""
    idx = vh.abs().argmax(dim=1, keepdim=True)
    sign = torch.where(torch.gather(vh, 1, idx) < 0, -1.0, 1.0).to(vh.dtype)
    return vh * sign


def _svd_loading_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain version: ``torch.linalg.svd`` (rows already in descending
    singular value) with the sign convention; NaN for a non-finite ``a``."""
    k = min(a.shape)
    if not bool(torch.isfinite(a).all()):
        return torch.full((k, a.shape[1]), float("nan"), dtype=a.dtype, device=a.device)
    _, _, vh = torch.linalg.svd(a, full_matrices=False)
    return _sign_convention(vh)


def _svd_loading_cuda(a: torch.Tensor) -> torch.Tensor:
    """Launch the ``svd_loading`` kernel (one block) on the current stream;
    the result is allocated here with ``torch.empty``."""
    from ._build import load_library

    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"svd_loading takes float32 or float64, got {a.dtype}")
    a = a.contiguous()
    Z, Y = a.shape
    vh = torch.empty((min(Z, Y), Y), dtype=a.dtype, device=a.device)
    lib = load_library("svd_loading")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.svd_loading(_ptr(a), _ptr(vh), Z, Y, int(a.dtype == torch.float64),
                             ctypes.c_void_p(stream))
    _raise_on(rc, lib, "svd_loading")
    KERNEL_LAUNCHES["svd_loading"] += 1
    return vh


def svd_loading(a: torch.Tensor) -> torch.Tensor:
    """``vh`` of ``a = U S Vh`` for the (Z, Y) loading, (min(Z, Y), Y), in
    descending singular value and the sign convention above.  CPU tensors
    run the plain version; CUDA tensors launch the kernel."""
    if a.ndim != 2 or min(a.shape) < 1:
        raise ValueError(f"svd_loading takes a non-empty (Z, Y) matrix, got {tuple(a.shape)}")
    if a.shape[0] > Z_MAX:
        raise ValueError(f"svd_loading takes at most Z_MAX = {Z_MAX} rows, got {a.shape[0]}")
    if a.is_cuda:
        return _svd_loading_cuda(a)
    if a.device.type != "cpu":
        raise ValueError(f"svd_loading runs on CUDA or the CPU, got {a.device}")
    return _svd_loading_plain(a)
