"""Batched (I + A)^{-1} for small PSD systems: the E-step's hot op.

Counterpart of ``vlgp_tpu/ops/spd.py``.  Two hand-written CUDA kernels
(``csrc/ns_inverse.cu``) carry the float32 path:

  * ``ns_gram``   replaces ``_ns_gram_pallas``: builds A = G_z' diag(w_zs) G_z
    per (latent, segment) in shared memory, runs Newton-Schulz
    X <- X (2I - (I+A) X), and optionally emits v = diag(G X G').
  * ``ns_packed`` replaces ``_ns_packed_pallas``: the same Newton-Schulz on
    a given A (B, R, R).

Each kernel has a plain PyTorch version beside it (``_ns_gram_plain``,
``_ns_packed_plain``) with the same starts, iterations, residual and v.
The dispatchers ``ns_gram`` / ``ns_packed`` run the plain version only for
tensors on the CPU; a CUDA tensor launches the kernel or raises.

Routing mirrors the JAX package's eligibility: float32 with R <= 128 takes
the Newton-Schulz route; float64, and R > 128, take the exact Cholesky
route.  Every exit of the Newton-Schulz route is residual-checked
(``_checked``), with the JAX package's fallback net: cold -> one escalation
-> exact Cholesky; warm -> probe -> refine -> cold.  Those checks are
host-synced branches.  ``FALLBACKS`` counts every branch of the net that
fires and ``KERNEL_LAUNCHES`` every kernel launch, as plain integers.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

__all__ = ["inv_one_plus_psd", "inv_one_plus_gram", "ns_gram", "ns_packed",
           "KERNEL_LAUNCHES", "FALLBACKS", "ROUTE_CALLS", "reset_counters"]

# Convergence threshold on max|(I+A)X - I| for Newton-Schulz results; also
# the accuracy contract of the float32 path (vlgp_tpu/ops/spd.py:156-178).
_RESID_TOL = 1e-2
# largest R the kernels take (three R x R float32 blocks in shared memory)
_R_MAX = 128

KERNEL_LAUNCHES = {"ns_gram": 0, "ns_packed": 0}
ROUTE_CALLS = {"gram": 0, "packed": 0}
FALLBACKS = {
    "gram_probe_reject": 0, "gram_refine_fail": 0,
    "gram_escalate": 0, "gram_exact": 0,
    "packed_probe_reject": 0, "packed_refine_fail": 0,
    "packed_escalate": 0, "packed_exact": 0,
}


def reset_counters() -> None:
    for d in (KERNEL_LAUNCHES, ROUTE_CALLS, FALLBACKS):
        for k in d:
            d[k] = 0


def _eye(R: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(R, dtype=like.dtype, device=like.device)


def _spd_inverse_exact(M: torch.Tensor) -> torch.Tensor:
    """Exact route: Cholesky + triangular inverse, M^{-1} = L^-T L^-1.

    A failed factorization yields NaN (as ``jnp.linalg.cholesky`` does)
    instead of raising, so the failure shows in the result.
    """
    L, info = torch.linalg.cholesky_ex(M)
    L = torch.where((info > 0)[..., None, None], torch.nan, L)
    eye = _eye(M.shape[-1], M).expand(M.shape)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return Linv.mT @ Linv


# ---------------------------------------------------------------------------
# Plain versions of the two kernels
# ---------------------------------------------------------------------------


def _ns_core(M, iters: int, x0: Optional[torch.Tensor], resid_only: bool):
    """Shared Newton-Schulz body on M = I + A (B, R, R).

    Returns (X, per-matrix residual max|M X - I|).  Cold starts begin at
    c I with c = 2 / (1 + max row-sum of |M|); ``resid_only`` measures x0
    with one product and runs no iteration.
    """
    R = M.shape[-1]
    eye = _eye(R, M)
    if x0 is None:
        lhat = M.abs().sum(-1).amax(-1)
        X = (2.0 / (1.0 + lhat))[:, None, None] * eye
    else:
        X = x0
    if not resid_only:
        for _ in range(iters):
            X = X @ (2.0 * eye - M @ X)
    resid = (M @ X - eye).abs().amax(dim=(-2, -1))
    return X, resid


def _ns_packed_plain(A, iters: int = 16, x0=None, resid_only: bool = False):
    """Plain version of the ``ns_packed`` kernel: A (B, R, R) ->
    (X or None, per-matrix residual (B,))."""
    M = A + _eye(A.shape[-1], A)
    X, resid = _ns_core(M, iters, x0, resid_only)
    return (None if resid_only else X), resid


def _ns_gram_plain(G, w, iters: int = 16, x0=None, resid_only: bool = False,
                   want_v: bool = False):
    """Plain version of the ``ns_gram`` kernel: G (Z, T, R), w (Z, S, T) ->
    (X (Z, S, R, R) or None, residual (Z*S,), v (Z, S, T) or None).
    With ``resid_only`` v comes from x0."""
    Z, T, R = G.shape
    S = w.shape[1]
    A = torch.einsum("ztr,zst,ztq->zsrq", G, w, G)
    M = (A + _eye(R, A)).reshape(Z * S, R, R)
    xf = None if x0 is None else x0.reshape(Z * S, R, R)
    X, resid = _ns_core(M, iters, xf, resid_only)
    X = X.reshape(Z, S, R, R)
    v = torch.einsum("ztr,zsrq,ztq->zst", G, X, G) if want_v else None
    return (None if resid_only else X), resid, v


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _check_cuda(name: str, t: torch.Tensor, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _raise_on(rc: int, lib, name: str) -> None:
    if rc != 0:
        msg = lib.ns_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel failed to launch: CUDA error {rc} ({msg})")


def _ns_packed_cuda(A, iters: int = 16, x0=None, resid_only: bool = False):
    """Launch the ``ns_packed`` kernel: one thread block per matrix."""
    from ._build import load_library

    B, R, _ = A.shape
    if not 1 <= R <= _R_MAX:
        raise ValueError(f"ns_packed takes 1 <= R <= {_R_MAX}, got R={R}")
    if iters < 0:
        raise ValueError("iters must be >= 0")
    if resid_only and x0 is None:
        raise ValueError("resid_only needs x0")
    _check_cuda("A", A, (B, R, R))
    if x0 is not None:
        _check_cuda("x0", x0, (B, R, R))
        if x0.device != A.device:
            raise ValueError("x0 and A must be on one device")
    X = None if resid_only else torch.empty_like(A)
    resid = torch.empty((B,), dtype=torch.float32, device=A.device)
    if B == 0:
        return X, resid
    lib = load_library()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = lib.ns_packed(_ptr(A), _ptr(x0), _ptr(X), _ptr(resid), B, R, iters,
                           int(x0 is not None), int(resid_only),
                           ctypes.c_void_p(stream))
    _raise_on(rc, lib, "ns_packed")
    KERNEL_LAUNCHES["ns_packed"] += 1
    return X, resid


def _ns_gram_cuda(G, w, iters: int = 16, x0=None, resid_only: bool = False,
                  want_v: bool = False):
    """Launch the ``ns_gram`` kernel: one thread block per (latent, segment)."""
    from ._build import load_library

    Z, T, R = G.shape
    S = w.shape[1]
    if not 1 <= R <= _R_MAX:
        raise ValueError(f"ns_gram takes 1 <= R <= {_R_MAX}, got R={R}")
    if iters < 0:
        raise ValueError("iters must be >= 0")
    if resid_only and x0 is None:
        raise ValueError("resid_only needs x0")
    _check_cuda("G", G, (Z, T, R))
    _check_cuda("w", w, (Z, S, T))
    if x0 is not None:
        _check_cuda("x0", x0, (Z, S, R, R))
    if any(t.device != G.device for t in (w, x0) if t is not None):
        raise ValueError("G, w and x0 must be on one device")
    X = None if resid_only else torch.empty((Z, S, R, R), dtype=G.dtype, device=G.device)
    resid = torch.empty((Z * S,), dtype=torch.float32, device=G.device)
    v = torch.empty((Z, S, T), dtype=G.dtype, device=G.device) if want_v else None
    if Z * S == 0:
        return X, resid, v
    lib = load_library()
    with torch.cuda.device(G.device):
        stream = torch.cuda.current_stream(G.device).cuda_stream
        rc = lib.ns_gram(_ptr(G), _ptr(w), _ptr(x0), _ptr(X), _ptr(resid), _ptr(v),
                         Z, S, T, R, iters, int(x0 is not None), int(resid_only),
                         int(want_v), ctypes.c_void_p(stream))
    _raise_on(rc, lib, "ns_gram")
    KERNEL_LAUNCHES["ns_gram"] += 1
    return X, resid, v


def ns_packed(A, iters: int = 16, x0=None, resid_only: bool = False):
    """Newton-Schulz (I + A)^{-1} for A (B, R, R): (X or None, max residual).

    The residual max propagates NaN.  CPU tensors run the plain version;
    CUDA tensors launch the kernel.
    """
    if A.is_cuda:
        X, resid = _ns_packed_cuda(A, iters, x0, resid_only)
    else:
        X, resid = _ns_packed_plain(A, iters, x0, resid_only)
    return X, resid.amax() if resid.numel() else resid.new_zeros(())


def ns_gram(G, w, iters: int = 16, x0=None, resid_only: bool = False,
            want_v: bool = False):
    """Fused (I + G' diag(w) G)^{-1}: (X or None, max residual, v or None).

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    if G.is_cuda:
        X, resid, v = _ns_gram_cuda(G, w, iters, x0, resid_only, want_v)
    else:
        X, resid, v = _ns_gram_plain(G, w, iters, x0, resid_only, want_v)
    return X, (resid.amax() if resid.numel() else resid.new_zeros(())), v


# ---------------------------------------------------------------------------
# Residual-checked routes
# ---------------------------------------------------------------------------


def _converged(resid: torch.Tensor) -> bool:
    return bool(torch.isfinite(resid) & (resid < _RESID_TOL))


def _checked(X, resid, fallback):
    """Accept X when its Newton-Schulz residual converged, else take
    ``fallback`` (a host-synced branch)."""
    return X if _converged(resid) else fallback()


def inv_one_plus_psd(A, iters: int = 16, force: Optional[str] = None,
                     warm: Optional[torch.Tensor] = None,
                     warm_iters: int = 8, probe: bool = True):
    """(I + A)^{-1} for PSD A (..., R, R).

    float32 with R <= 128 runs the residual-checked Newton-Schulz route
    (:func:`_ns_auto`, the ``ns_packed`` kernel on CUDA); float64 and
    larger R run the exact Cholesky route.  ``force="xla"`` selects the
    exact route, ``force="ns"`` / ``"packed"`` the Newton-Schulz route
    (the names of the JAX package's options).  ``warm`` is an approximate
    inverse of a nearby system: a probe accepts it when its residual is
    within tolerance, else ``warm_iters`` refinements run (``probe=False``
    always refines).
    """
    R = A.shape[-1]
    if force == "xla":
        return _spd_inverse_exact(A + _eye(R, A))
    if force in ("ns", "packed") or (A.dtype == torch.float32 and R <= _R_MAX):
        return _ns_auto(A, iters, force, warm, warm_iters, probe)
    return _spd_inverse_exact(A + _eye(R, A))


def _ns_auto(A, iters, force, warm, warm_iters, probe=True):
    """Newton-Schulz (I+A)^{-1}, residual-checked at every exit
    (``vlgp_tpu/ops/spd.py:259-360``)."""
    ROUTE_CALLS["packed"] += 1
    R = A.shape[-1]
    shape = A.shape
    flat = A.reshape(-1, R, R).contiguous()

    def exact():
        FALLBACKS["packed_exact"] += 1
        return _spd_inverse_exact(flat + _eye(R, flat))

    def cold():
        X, resid = ns_packed(flat, iters)

        def escalate():
            FALLBACKS["packed_escalate"] += 1
            X2, r2 = ns_packed(flat, iters, x0=X)
            return _checked(X2, r2, exact)

        return _checked(X, resid, escalate).reshape(shape)

    if warm is None:
        return cold()
    x0w = warm.to(A.dtype).reshape(flat.shape).contiguous()

    def refine():
        Xw, resid = ns_packed(flat, warm_iters, x0=x0w)

        def refine_failed():
            FALLBACKS["packed_refine_fail"] += 1
            return cold()

        return _checked(Xw.reshape(shape), resid, refine_failed)

    if not probe:
        return refine()
    _, resid0 = ns_packed(flat, 0, x0=x0w, resid_only=True)
    if _converged(resid0):
        return x0w.reshape(shape)
    FALLBACKS["packed_probe_reject"] += 1
    return refine()


def inv_one_plus_gram(G, w, iters: int = 16, force: Optional[str] = None,
                      warm: Optional[torch.Tensor] = None,
                      warm_iters: int = 8, probe: bool = True,
                      want_v: bool = False):
    """X = (I + G' diag(w) G)^{-1} for every (latent, segment) pair.

    G: (Z, T, R) prior factors; w: (Z, S, T) nonnegative weights.
    Returns X (Z, S, R, R), or (X, v) with ``want_v`` where
    v = diag(G X G') (Z, S, T).  float32 with R <= 128 takes the fused
    route (:func:`_gram_auto`, the ``ns_gram`` kernel on CUDA); otherwise,
    or with ``force`` set (``"xla"`` / ``"ns"`` / ``"packed"``), the Gram
    matrix is built with an einsum and inverted by :func:`inv_one_plus_psd`.
    """
    R = G.shape[-1]
    if force is None and G.dtype == torch.float32 and R <= _R_MAX:
        return _gram_auto(G, w, iters, warm, warm_iters, probe, want_v)
    A = torch.einsum("ztr,zst,ztq->zsrq", G, w, G)
    X = inv_one_plus_psd(A, iters=iters, warm=warm, warm_iters=warm_iters,
                         probe=probe, force=force)
    if want_v:
        return X, torch.einsum("ztr,zsrq,ztq->zst", G, X, G)
    return X


def _gram_auto(G, w, iters, warm, warm_iters, probe, want_v):
    """Residual-checked fused-Gram Newton-Schulz with the ``_ns_auto``
    fallback net (``vlgp_tpu/ops/spd.py:917-961``)."""
    ROUTE_CALLS["gram"] += 1
    R = G.shape[-1]
    G = G.contiguous()
    w = w.contiguous()

    def pack(X, v):
        return (X, v) if want_v else X

    def kern(n_iters, x0=None, resid_only=False):
        return ns_gram(G, w, iters=n_iters, x0=x0, resid_only=resid_only,
                       want_v=want_v)

    def exact():
        FALLBACKS["gram_exact"] += 1
        A = torch.einsum("ztr,zst,ztq->zsrq", G, w, G)
        Xe = _spd_inverse_exact(A + _eye(R, A))
        if want_v:
            return Xe, torch.einsum("ztr,zsrq,ztq->zst", G, Xe, G)
        return Xe

    def cold():
        X, resid, v = kern(iters)

        def escalate():
            FALLBACKS["gram_escalate"] += 1
            X2, r2, v2 = kern(iters, x0=X)
            return _checked(pack(X2, v2), r2, exact)

        return _checked(pack(X, v), resid, escalate)

    if warm is None:
        return cold()
    warm = warm.to(G.dtype).contiguous()

    def refine():
        Xw, resid, vw = kern(warm_iters, x0=warm)

        def refine_failed():
            FALLBACKS["gram_refine_fail"] += 1
            return cold()

        return _checked(pack(Xw, vw), resid, refine_failed)

    if not probe:
        return refine()
    _, resid0, v0 = kern(0, x0=warm, resid_only=True)
    if _converged(resid0):
        return pack(warm, v0)
    FALLBACKS["gram_probe_reject"] += 1
    return refine()
