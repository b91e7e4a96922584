"""The H-step's pooled posterior statistic in one pass over the segments.

Counterpart of the three sums of ``vlgp_tpu/models/gp.py:435-450``, which
``vlgp_tpu`` leaves to XLA (no Pallas kernel).  Per latent, with P_s =
diag(w~_s) G and Q_s = P_s X_s:

  * ``sum_QP`` = sum_s valid_s Q_s P_s'    (Z, T, T)
  * ``sum_X``  = sum_s valid_s X_s         (Z, R, R)
  * ``sum_QA`` = sum_s valid_s (P_s - Q_s)  (Z, T, R)

On the card the hand-written CUDA kernel ``csrc/hstep_stat.cu`` forms P
and Q in shared memory and registers, never in device memory, writes
partial sums per chunk of segments, and a second launch adds the chunks in
a fixed order, so every run gives the same bits.  ``_hstep_stat_plain`` is
the torch code ``models/gp.py:hstep`` ran before, unchanged; the wrapper
runs it only for tensors on the CPU, and a CUDA tensor launches the kernel
or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .spd import KERNEL_LAUNCHES, _ptr, _raise_on

__all__ = ["hstep_stat"]


def _hstep_stat_plain(G, wt2, X, valid):
    """(sum_QP, sum_X, sum_QA) of G (Z, T, R), w~ (Z, S, T), X (Z, S, R, R)
    and valid (S,), in torch ops."""
    Zs, S, T = wt2.shape
    R = X.shape[-1]
    P = wt2[..., None] * G[:, None]  # (Z, S, T, R): diag(w~) G
    Q = P @ X  # (Z, S, T, R)
    vQ = valid[None, :, None, None] * Q
    # sum_s Q_s P_s' as one (T, S R) x (S R, T) product per latent
    sum_QP = vQ.permute(0, 2, 1, 3).reshape(Zs, T, S * R) @ \
        P.permute(0, 2, 1, 3).reshape(Zs, T, S * R).mT
    sum_X = torch.einsum("s,zsrq->zrq", valid, X)
    sum_QA = torch.einsum("s,zstr->ztr", valid, P - Q)  # Q A = P - Q
    return sum_QP, sum_X, sum_QA


def _check_shapes(G, wt2, X, valid) -> None:
    if G.ndim != 3 or wt2.ndim != 3 or X.ndim != 4 or valid.ndim != 1:
        raise ValueError("hstep_stat takes G (Z, T, R), wt2 (Z, S, T), X (Z, S, R, R) and "
                         "valid (S,)")
    Z, T, R = G.shape
    S = wt2.shape[1]
    want = {"wt2": (Z, S, T), "X": (Z, S, R, R), "valid": (S,)}
    for name, t in zip(want, (wt2, X, valid)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want[name]}")


def _hstep_stat_cuda(G, wt2, X, valid):
    """Launch ``hstep_stat`` and its reduction over the chunks."""
    from ._build import load_library

    _check_shapes(G, wt2, X, valid)
    if G.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the hstep_stat kernel takes float32 or float64, got {G.dtype}")
    for name, t in dict(G=G, wt2=wt2, X=X, valid=valid).items():
        if not t.is_cuda or t.device != G.device:
            raise ValueError(f"{name} must be a CUDA tensor on {G.device}, got {t.device}")
        if t.dtype != G.dtype:
            raise TypeError(f"{name} must be {G.dtype}, got {t.dtype}")
    Z, T, R = G.shape
    S = wt2.shape[1]
    if R > T:
        raise ValueError(f"the hstep_stat kernel takes R <= T, got R={R}, T={T}")
    G, wt2, X, valid = (t.contiguous() for t in (G, wt2, X, valid))
    lib = load_library("hstep_stat")
    chunks = lib.hstep_stat_plan(Z, S, T, R, int(G.dtype == torch.float64))
    if chunks < 1:
        raise ValueError(f"the hstep_stat kernel does not take Z={Z} S={S} T={T} R={R}")
    # scratch and outputs from torch's allocator (a capture's pool under a graph)
    part = torch.empty((Z, chunks, T * T + T * R + R * R), dtype=G.dtype, device=G.device)
    sum_QP = torch.empty((Z, T, T), dtype=G.dtype, device=G.device)
    sum_QA = torch.empty((Z, T, R), dtype=G.dtype, device=G.device)
    sum_X = torch.empty((Z, R, R), dtype=G.dtype, device=G.device)
    with torch.cuda.device(G.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(G.device).cuda_stream)
        rc = lib.hstep_stat(_ptr(G), _ptr(wt2), _ptr(X), _ptr(valid), _ptr(part), _ptr(sum_QP),
                            _ptr(sum_QA), _ptr(sum_X), Z, S, T, R,
                            int(G.dtype == torch.float64), stream)
    _raise_on(rc, lib, "hstep_stat")
    KERNEL_LAUNCHES["hstep_stat"] += 1  # the pass and its reduction, one call
    return sum_QP, sum_X, sum_QA


def hstep_stat(G, wt2, X, valid):
    """(sum_QP, sum_X, sum_QA), summed over this device's segments, of the
    running factor G (Z, T, R), the ridge-folded weights w~ (Z, S, T), the
    Woodbury inverses X (Z, S, R, R) and the segments' valid flags (S,).
    CPU tensors run the plain version."""
    if G.is_cuda:
        return _hstep_stat_cuda(G, wt2, X, valid)
    if G.device.type != "cpu":
        raise ValueError(f"hstep_stat runs on CUDA or the CPU, got {G.device}")
    _check_shapes(G, wt2, X, valid)
    return _hstep_stat_plain(G, wt2, X, valid)
