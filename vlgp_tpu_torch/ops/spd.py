"""Batched (I + A)^{-1} for small PSD systems: the E-step's hot op.

Counterpart of ``vlgp_tpu/ops/spd.py``.  Hand-written CUDA kernels carry
the float32 path:

  * ``ns_gram``   replaces ``_ns_gram_pallas``: builds A = G_z' diag(w_zs) G_z
    per (latent, segment), runs Newton-Schulz X <- X (2I - (I+A) X), and
    optionally emits v = diag(G X G').  Two hand-written designs, chosen
    by (T, R) alone (``_ns_gram_design``): per matrix, its Gram built in
    shared memory (the segments, T = 50), or for long T the Gram and v as
    two GEMMs over the pairs of the upper triangle with a Newton-Schulz
    launch between them (``_ns_gram_pairs_plain`` mirrors its arithmetic).
    The per-matrix design has two paths with the same bits, chosen by
    ``gram_plan`` from (T, R, Z): a block per matrix, or persistent blocks
    with G resident and a warp per matrix (the streaming path).
  * ``ns_packed`` replaces ``_ns_packed_pallas``: the same Newton-Schulz on
    a given A (B, R, R); with ``probe_skip`` its fused probe + refine mode
    (``VLGP_FUSED_PROBE=1``), decided per group of matrices.
  * ``spd_inverse`` replaces ``_spd_inverse_pallas``: Cholesky (the TPU
    kernel's rank-1 updates, run left-looking, two columns a step) fused
    with the forward substitution for L^-1, then the lower triangle of
    L^-T L^-1.

The first two live in ``csrc/ns_inverse.cu``, the third in
``csrc/spd_inverse.cu``.  Each kernel has a plain PyTorch version beside it
(``_ns_gram_plain``, ``_ns_packed_plain``, ``_spd_inverse_plain``) with the
same arithmetic.  The dispatchers ``ns_gram`` / ``ns_packed`` and the
kernel route of ``spd_inverse`` run the plain version only for tensors on
the CPU; a CUDA tensor launches the kernel or raises.

Routing mirrors the JAX package's eligibility: float32 with R <= 128 takes
the Newton-Schulz route; float64, and R > 128, take the exact Cholesky
route.  Every exit of the Newton-Schulz route is residual-checked
(``_checked``), with the JAX package's fallback net: cold -> one escalation
-> exact Cholesky; warm -> probe -> refine -> cold.  Those checks go
through ``ops.control.cond``: host branches when run eagerly, IF nodes of a
CUDA graph under a capture (``vlgp_tpu/ops/spd.py:252-256``, ``:957``).
``FALLBACKS`` counts every branch of the net that fires and
``KERNEL_LAUNCHES`` every kernel launch, as plain integers; under a capture
they count once per capture, not per replay (``ops/control.py``), and the
device counters of the capture count the fallbacks that the replays took.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple, Optional

import torch

from . import control

__all__ = ["inv_one_plus_psd", "inv_one_plus_gram", "ns_gram", "ns_packed",
           "spd_inverse", "spd_solve", "gram_plan", "stream_plan", "gram_walk", "GramPlan",
           "BLOCK_PLAN", "pairs_plan", "pairs_stream_plan", "pairs_walk", "PairsPlan",
           "PairsGemm", "TILED_PLAN",
           "KERNEL_LAUNCHES", "FALLBACKS", "ROUTE_CALLS", "reset_counters"]

# Convergence threshold on max|(I+A)X - I| for Newton-Schulz results; also
# the accuracy contract of the float32 path (vlgp_tpu/ops/spd.py:156-178).
_RESID_TOL = 1e-2
# largest R the kernels take (three R x R float32 blocks in shared memory)
_R_MAX = 128
# largest R of spd_inverse's automatic kernel route (vlgp_tpu/ops/spd.py:_LANE)
_LANE = 64

# ns_gram's design by (T, R) alone, never by S, so a segment's bits do not
# depend on how many segments share the call (9c's batches, fit_sharded
# against fit).  "per_matrix": one block per (latent, segment) streams G
# over T through shared memory to build its Gram and v.  "pairs": the Gram
# A[s, p] = sum_t w[s, t] G[t, i] G[t, j] over the pairs p = (i <= j) and
# v[s, t] = sum_p Xp[s, p] G[t, i] G[t, j] as two register-tiled FP32 GEMMs
# that share each row of G among 128 segments, with one Newton-Schulz
# block per matrix between them (csrc/ns_inverse.cu:ns_gram_pairs).
# Crossover, from both designs timed at T = 50, 100, 200, 500 and 1000 with
# S = 100000 / T, R40 and R50, cold 16 + v, warm 4 + v and probe + v
# (tools/torch_kernel_ab.py --designs on an NVIDIA H100 80GB HBM3, 700 W;
# PERF.md, Findings): at T50 the pairs design took 0.98-1.16x the per-matrix
# time (slower in warm and probe, the E-step's modes), at T100 0.90-0.97x,
# at T200 0.68-0.92x, at T1000 0.62-0.75x (S100) and 0.32-0.57x (S2500),
# the same at both R.  So the rule reads T alone, and the segments (T50)
# keep the per-matrix design.
_PAIRS_MIN_T = 100


def _ns_gram_design(T: int, R: int) -> str:
    """``"pairs"`` (the long-T design) or ``"per_matrix"`` for G (Z, T, R)."""
    return "pairs" if T >= _PAIRS_MIN_T else "per_matrix"


# The per-matrix design's two paths (csrc/ns_inverse.cu): "block", a
# thread block per matrix, and "stream", persistent blocks with G_z resident
# in shared memory, a producer warp's bulk copies of each matrix's w row and
# x0 into the stage of the consumer warp that solves it, each warp one
# matrix at a time in 8 x 8 tiles (R <= 40).  The kernel's constants: shared
# memory a block can have on an H100, its SMs, consumer warps at most, the
# largest R, the mbarriers' bytes, the block path's rows of G a chunk.
SMEM_MAX = 232_448
SMS = 132
_GS_WARPS_MAX = 8
_GS_R_MAX = 40
_GS_BAR_BYTES = 6 * 8 * _GS_WARPS_MAX
_TC = 32


class GramPlan(NamedTuple):
    """A launch of the per-matrix design: ``path`` "stream" (``warps``
    consumer warps a block, each with its own stage, and ``per`` blocks a
    latent, at most) or "block" (a block per matrix; ``warps`` and ``per``
    0), ``threads`` a block, ``smem`` bytes of dynamic shared memory
    each."""
    path: str
    warps: int
    per: int
    threads: int
    smem: int


def _tiles(R: int) -> int:
    return -(-R // 4)


def _tiled_threads(R: int) -> int:
    return -(-_tiles(R) ** 2 // 32) * 32


def _gram_stream_smem(T: int, R: int, warps: int) -> int:
    """``StreamLayout`` (csrc/ns_inverse.cu): the mbarriers, G by rows and
    transposed, and each warp's two stages (a w row each, in a slot of its
    bytes rounded up to 16 and 16 more), Mt (or v's partial sums), X and
    Xt (at least x0's slot)."""
    npad = 8 * -(-R // 8)
    ld, tp = npad + 4 * ((npad - 1) // 32), 4 * (-(-T // 4) | 1)
    n = npad * ld
    slot = lambda count: (4 * count + 15) // 16 * 16 + 16  # noqa: E731
    warp = 2 * slot(T) + 4 * (max(n, _tiles(R) * tp) + n) + max(4 * n, slot(R * R))
    return _GS_BAR_BYTES + 4 * (T * ld + npad * tp) + warps * warp


def _gram_block_smem(R: int) -> int:
    nb = _tiles(R)
    return 4 * (3 * 4 * nb * 4 * (nb | 1) + _TC * 5 * nb + _TC + _tiled_threads(R) // 32)


# the block path, whatever the shape (the first design, which the
# streaming path is held to bit for bit)
BLOCK_PLAN = GramPlan("block", 0, 0, 0, 0)


def stream_plan(T: int, R: int, Z: int, nsm: int = SMS) -> Optional[GramPlan]:
    """The streaming path's launch at one shape, or None where it cannot
    run: a warp holds the matrix's 8 x 8 tiles (R <= 40), with the most
    consumer warps that fit 232,448 bytes (at most 8, two or more), and nsm
    // Z blocks a latent (a latent a block)."""
    if R <= _GS_R_MAX:
        for warps in range(_GS_WARPS_MAX, 1, -1):
            smem = _gram_stream_smem(T, R, warps)
            if smem <= SMEM_MAX:
                return GramPlan("stream", warps, max(1, nsm // Z), 32 * (warps + 1), smem)
    return None


@functools.lru_cache(maxsize=256)
def gram_plan(T: int, R: int, Z: int, nsm: int = SMS) -> GramPlan:
    """The per-matrix design's launch at one shape, never by S: the
    streaming path (``stream_plan``) where it runs and the block path would
    issue as many FMA instructions a product step (a block of 128 threads or
    more, so 37 <= R <= 40: the streaming path's single warp issues 64 a
    step, a block 16 a warp); else the block path.  At Z5 S2000 T50 the
    streaming path took 0.73-0.96x the block path's time at R38 and R40 in
    every mode, up to 1.03x at R33 and R36 (the warm modes), and up to 2.6x
    at R17-R32 (``tools/torch_kernel_ab.py --paths``; PERF.md, Findings)."""
    plan = stream_plan(T, R, Z, nsm) if _tiled_threads(R) >= 128 else None
    return plan or GramPlan("block", 0, 0, _tiled_threads(R), _gram_block_smem(R))


def gram_walk(plan: GramPlan, Z: int, S: int):
    """The matrices b = z S + s each block of a streaming launch takes, in
    its order, with the consumer warp that takes each: [[(b, warp), ...],
    ...] a block; block z per + j takes s = j, j + per, ... of latent z,
    its k-th matrix warp k mod ``warps`` (``per`` clipped to S, as the
    wrapper launches it)."""
    per = min(plan.per, S)
    return [[(z * S + s, k % plan.warps) for k, s in enumerate(range(j, S, per))]
            for z in range(Z) for j in range(per)]


# The long-T design's two GEMMs (csrc/ns_inverse.cu, "The streaming GEMM"):
# persistent blocks of consumer warps (a 64 x 32 warp tile, 8 x 8 sums a
# lane) and helper warps that copy A by tensor-memory-accelerator boxes and
# form B, around a ring of stages of 32 k.  The tile shapes by index: (BM,
# BN, consumer warps, helper warps).  The kernel's constants: the stage
# depth, the A stages' alignment and the mbarriers' bytes, an SM's shared
# memory (each block takes 1,024 bytes more), and the threads
# whose registers an SM holds under the kernels' launch bounds (384: one
# block of 384 threads, two of 192, three of 128).
_PAIRS_SHAPES = ((128, 128, 8, 4), (64, 128, 4, 2), (64, 64, 2, 2))
_PG_BK = 32
_PG_LDA = _PG_BK + 4
_PG_STAGES = (4, 3)
_PG_ALIGN = 128
_PG_BAR_BYTES = 96
_SM_SMEM = 233_472
_PG_BOUND_THREADS = 384


class PairsGemm(NamedTuple):
    """One GEMM of a long-T launch: ``shape`` an index of ``_PAIRS_SHAPES``
    (a ``bm`` x ``bn`` tile, ``threads`` a block), ``stages`` of the ring,
    ``grid`` persistent blocks, ``copy`` "tma" (A's rows by boxes of the
    tensor memory accelerator, 4-byte copies at the ends; the kernel takes
    4-byte copies throughout where A's address is not 16-byte aligned) or
    "async4" (4-byte copies throughout), ``smem`` bytes of dynamic shared
    memory a block."""
    shape: int
    bm: int
    bn: int
    threads: int
    stages: int
    grid: int
    copy: str
    smem: int


class PairsPlan(NamedTuple):
    """A launch of the long-T design: ``path`` "stream" (``gram`` and ``v``
    each a PairsGemm on the streaming GEMM, or None for that GEMM on the
    register-tiled kernel) or "tiled" (both GEMMs on the tiled kernels, which
    pick their own tiles; ``gram`` and ``v`` None)."""
    path: str
    gram: Optional[PairsGemm]
    v: Optional[PairsGemm]


# the tiled kernels, whatever the shape (the first design, which the
# streaming GEMM is held to bit for bit)
TILED_PLAN = PairsPlan("tiled", None, None)


def _pairs_smem(kind: int, bm: int, bn: int, R: int, stages: int) -> int:
    """``PairsLayout`` (csrc/ns_inverse.cu): 128 bytes of slack to align the
    A stages (bm rows of 36 floats), the B stages (32 rows of bn), then
    for the Gram (kind 0) a slot of 32 rows of G a stage (its bytes rounded
    up to 16 and 16 more) or for v (kind 1) the panel of bn rows of R | 1
    floats, then the mbarriers."""
    a = 4 * stages * bm * _PG_LDA
    b = 4 * stages * _PG_BK * bn
    g = stages * ((4 * _PG_BK * R + 15) // 16 * 16 + 16) if kind == 0 else 4 * bn * (R | 1)
    return _PG_ALIGN + a + b + g + _PG_BAR_BYTES


def _pairs_fit(kind: int, shape: int, R: int):
    """(stages, blocks an SM) of a tile shape: the blocks an SM holds with
    3 stages (by shared memory, threads and registers), then 4 stages where
    they hold as many; None where 3 stages pass 232,448 bytes."""
    bm, bn, cw, hw = _PAIRS_SHAPES[shape]
    threads = 32 * (cw + hw)
    cap = _PG_BOUND_THREADS // threads

    def blocks(stages):
        smem = _pairs_smem(kind, bm, bn, R, stages)
        return 0 if smem > SMEM_MAX else min(cap, _SM_SMEM // (smem + 1024))

    least = blocks(_PG_STAGES[-1])
    if least == 0:
        return None
    return next((st, least) for st in _PG_STAGES if blocks(st) == least)


def _pairs_candidate(kind: int, shape: int, Z: int, M: int, N: int, K: int, R: int,
                     nsm: int):
    """One GEMM (M x N x K a latent) at a tile shape: (modelled µs,
    PairsGemm), or None where the shape does not fit.  Each persistent block
    takes tiles in turn (rounds = tiles / grid, up), each tile its ceil(K /
    32) stages and about one more to start; a stage of a round takes
    max(3.2, 2.64 + 0.16 w) µs with w consumer warps on the SM (a warp's
    own chain of 32 k, then the SM's shared issue and shared-memory loads),
    as the streaming GEMM ran on an NVIDIA H100 80GB HBM3 at 700 W
    (tools/torch_ns_gram_pieces.py, every shape in turns: PERF.md,
    Findings).  A grid of at most one block an SM takes 4 stages where they
    fit, so its helpers copy two stages ahead."""
    fit = _pairs_fit(kind, shape, R)
    if fit is None:
        return None
    bm, bn, cw, hw = _PAIRS_SHAPES[shape]
    stages, per_sm = fit
    tiles = Z * -(-M // bm) * -(-N // bn)
    grid = min(tiles, nsm * per_sm)
    rounds, resident = -(-tiles // grid), -(-grid // nsm)
    if resident == 1 and _pairs_smem(kind, bm, bn, R, 4) <= SMEM_MAX:
        stages = 4
    stage_us = max(3.2, 2.64 + 0.16 * resident * cw)
    cost = rounds * (-(-K // _PG_BK) + 1) * stage_us
    return cost, PairsGemm(shape, bm, bn, 32 * (cw + hw), stages, grid, "tma",
                           _pairs_smem(kind, bm, bn, R, stages))


def _pairs_gemm(kind: int, Z: int, M: int, N: int, K: int, R: int, nsm: int) -> PairsGemm:
    """The tile shape, stages and grid of one GEMM: the candidate of least
    modelled cost (``_pairs_candidate``); ties go to the larger tile."""
    found = [c for shape in range(len(_PAIRS_SHAPES))
             if (c := _pairs_candidate(kind, shape, Z, M, N, K, R, nsm)) is not None]
    return min(found, key=lambda c: round(c[0], 9))[1]


@functools.lru_cache(maxsize=256)
def pairs_stream_plan(Z: int, S: int, T: int, R: int, nsm: int = SMS) -> PairsPlan:
    """Both GEMMs of the long-T design on the streaming GEMM, each with the
    tile shape, stages and grid of ``_pairs_gemm`` (the Gram: M = S, N =
    R (R + 1) / 2, K = T; v: M = S, N = T, K = R (R + 1) / 2).  Shape,
    stages and grid change no bit of any output."""
    P = R * (R + 1) // 2
    return PairsPlan("stream", _pairs_gemm(0, Z, S, P, T, R, nsm),
                     _pairs_gemm(1, Z, S, T, P, R, nsm))


# A GEMM of the long-T design takes the streaming GEMM where its 128 x 128
# tiles give every SM four rounds or more, else the tiled kernel: on an
# NVIDIA H100 80GB HBM3 at 700 W the streaming GEMM took 0.98 and 0.93x the
# tiled kernel's time at Z5 S2500 T1000 R50 (1,000 and 800 tiles), but
# 1.22x (the Gram) and 1.03x (v) at S100 T1000 (50 and 40 tiles) and 1.10
# to 1.22x for the Gram at S500 T200 (200 tiles), where a block's chain of k
# and its helpers' latency are not hidden (tools/torch_ns_gram_pieces.py;
# PERF.md, Findings).
_PAIRS_STREAM_ROUNDS = 4


@functools.lru_cache(maxsize=256)
def pairs_plan(Z: int, S: int, T: int, R: int, nsm: int = SMS) -> PairsPlan:
    """The long-T design's launch at one shape: each GEMM on the streaming
    GEMM (``pairs_stream_plan``) where Z ceil(M / 128) ceil(N / 128) >=
    ``_PAIRS_STREAM_ROUNDS`` nsm, else on the tiled kernel;
    ``TILED_PLAN`` where neither streams.  By shape alone; no choice changes
    a bit."""
    P = R * (R + 1) // 2
    full = pairs_stream_plan(Z, S, T, R, nsm)
    big = lambda N: Z * -(-S // 128) * -(-N // 128) >= _PAIRS_STREAM_ROUNDS * nsm  # noqa: E731
    gram, v = (full.gram if big(P) else None), (full.v if big(T) else None)
    return TILED_PLAN if gram is None and v is None else PairsPlan("stream", gram, v)


def pairs_walk(gemm: PairsGemm, Z: int, M: int, N: int):
    """The tiles each block of a streaming GEMM takes, in its order, as
    (z, m0, n0): block b takes tiles b, b + grid, ... of the list ordered by
    latent, then by column of tiles, then by row of tiles."""
    ntm, ntn = -(-M // gemm.bm), -(-N // gemm.bn)
    per_z = ntm * ntn

    def tile(tau):
        z, rem = divmod(tau, per_z)
        nt, mt = divmod(rem, ntm)
        return z, mt * gemm.bm, nt * gemm.bn

    return [[tile(tau) for tau in range(b, Z * per_z, gemm.grid)] for b in range(gemm.grid)]


# Warm-start probe architecture of the Newton-Schulz route: "0" (default) =
# probe launch + host-synced check + refine launch; "1" = the fused
# probe_skip kernel, one launch that refines only the groups whose carry
# drifted (vlgp_tpu/ops/spd.py:68-73).
_FUSED_PROBE = os.environ.get("VLGP_FUSED_PROBE", "0") == "1"

# Launch, route and fallback counters of every kernel of the port, those of
# the fused E-step sweep (ops/sweep.py), the loading's SVD (ops/linalg.py),
# the Lorenz trajectory (simulation.py), the M-step's Newton iteration
# (ops/mstep.py), the H-step's search (ops/golden.py) and the E-step's
# per-sweep chain (ops/estep.py) included.  Host
# integers: under a CUDA graph capture they count the capture, not the
# replays (ops/control.py).
# ``ns_gram`` counts every call of its kernels (either design or path),
# ``ns_gram_stream`` the calls that took the per-matrix streaming path,
# ``ns_gram_pairs_stream`` those of the long-T design with a GEMM on the
# streaming GEMM.
KERNEL_LAUNCHES = {"ns_gram": 0, "ns_gram_stream": 0, "ns_gram_pairs_stream": 0,
                   "ns_packed": 0, "probe_skip": 0,
                   "spd_inverse": 0, "sweep": 0, "svd_loading": 0, "lorenz": 0,
                   "mstep_stats": 0, "mstep_update": 0, "hstep_search": 0,
                   "hstep_stat": 0, "estep_project": 0, "estep_step": 0}
ROUTE_CALLS = {"gram": 0, "packed": 0, "sweep": 0}
FALLBACKS = {
    "gram_probe_reject": 0, "gram_refine_fail": 0,
    "gram_escalate": 0, "gram_exact": 0,
    "packed_probe_reject": 0, "packed_refine_fail": 0,
    "packed_escalate": 0, "packed_exact": 0,
    "sweep_core": 0,
}


def reset_counters() -> None:
    for d in (KERNEL_LAUNCHES, ROUTE_CALLS, FALLBACKS, control.TRIPS):
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
# Plain versions of the kernels
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


def _probe_skip_groups(R: int) -> int:
    """Matrices per ``probe_skip`` group: the TPU kernel's grid block,
    ``per_block`` of ``vlgp_tpu/ops/spd.py:_packed_geometry(B, R, tiles=12)``
    (24 at R = 50, 36 at R = 40)."""
    return 12 * max(1, 128 // R)


def _ns_packed_plain(A, iters: int = 16, x0=None, resid_only: bool = False,
                     probe_skip: bool = False):
    """Plain version of the ``ns_packed`` kernel: A (B, R, R) ->
    (X or None, per-matrix residual (B,)).

    ``probe_skip`` (needs x0): per group of ``_probe_skip_groups`` matrices,
    a group whose worst x0 residual is below tolerance returns x0 and those
    residuals; any other group (NaN included) takes the probe product as its
    first half-step, X1 = x0 (2I - M x0), then ``iters - 1`` more rounds
    (``vlgp_tpu/ops/spd.py:492-519``)."""
    R = A.shape[-1]
    M = A + _eye(R, A)
    if not probe_skip:
        X, resid = _ns_core(M, iters, x0, resid_only)
        return (None if resid_only else X), resid
    if x0 is None or resid_only:
        raise ValueError("probe_skip needs x0 and writes X")
    eye = _eye(R, M)
    MX0 = M @ x0
    r0 = (MX0 - eye).abs().amax(dim=(-2, -1))
    B, per = A.shape[0], _probe_skip_groups(R)
    ngroup = -(-B // per)
    worst = torch.nn.functional.pad(r0, (0, ngroup * per - B)).reshape(ngroup, per).amax(1)
    keep = (worst < _RESID_TOL).repeat_interleave(per)[:B]
    X = x0 @ (2.0 * eye - MX0)
    for _ in range(max(iters - 1, 0)):
        X = X @ (2.0 * eye - M @ X)
    resid = (M @ X - eye).abs().amax(dim=(-2, -1))
    return torch.where(keep[:, None, None], x0, X), torch.where(keep, r0, resid)


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


def _ns_gram_pairs_plain(G, w, iters: int = 16, x0=None, resid_only: bool = False,
                         want_v: bool = False):
    """The ``"pairs"`` design of ``ns_gram`` step by step, for the tests:
    K[z, t, p] = G[z, t, i] G[z, t, j] over the pairs p = (i <= j) of
    ``torch.triu_indices``, the Gram's pairs w @ K, Newton-Schulz on
    I + A unpacked, then v = Xp @ K' with Xp = X_ii on the diagonal and
    X_ij + X_ji off it.  Same arguments and results as ``_ns_gram_plain``."""
    Z, T, R = G.shape
    S = w.shape[1]
    i, j = torch.triu_indices(R, R, device=G.device)
    K = G[:, :, i] * G[:, :, j]
    Ap = w @ K
    A = Ap.new_zeros((Z, S, R, R))
    A[..., i, j] = Ap
    A[..., j, i] = Ap
    M = (A + _eye(R, A)).reshape(Z * S, R, R)
    xf = None if x0 is None else x0.reshape(Z * S, R, R)
    X, resid = _ns_core(M, iters, xf, resid_only)
    X = X.reshape(Z, S, R, R)
    v = None
    if want_v:
        Xp = torch.where(i == j, X[..., i, j], X[..., i, j] + X[..., j, i])
        v = Xp @ K.mT
    return (None if resid_only else X), resid, v


def _spd_inverse_plain(A):
    """Plain version of the ``spd_inverse`` kernel, the TPU kernel's
    algorithm step by step (``vlgp_tpu/ops/spd.py:76-119``): Cholesky by
    masked rank-1 updates with the pivot clamped at 1e-30, L^-1 by forward
    substitution, then L^-T L^-1.  A (B, R, R) -> A^{-1}."""
    R = A.shape[-1]
    idx = torch.arange(R, device=A.device)
    L = A.clone()
    for j in range(R):
        cj = L[:, :, j].clone()
        dj = cj[:, j]
        inv_piv = torch.rsqrt(torch.clamp(dj, min=1e-30))
        cjb = cj * inv_piv[:, None] * (idx > j)
        L = L - cjb[:, :, None] * cjb[:, None, :]
        L[:, :, j] = cjb + (idx == j) * (dj * inv_piv)[:, None]
    L = torch.tril(L)
    Linv = torch.zeros_like(L)
    for j in range(R):
        lrow = L[:, j, :]
        acc = torch.einsum("bk,bkq->bq", lrow * (idx < j), Linv)
        Linv[:, j, :] = ((idx == j).to(A.dtype) - acc) / lrow[:, j, None]
    return Linv.mT @ Linv


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


def _ns_packed_cuda(A, iters: int = 16, x0=None, resid_only: bool = False,
                    probe_skip: bool = False):
    """Launch the ``ns_packed`` kernel (one thread block per matrix), or with
    ``probe_skip`` the ``ns_packed_probe_skip`` pair (a probe and a refine
    launch, one block per matrix each; counted as one launch)."""
    from ._build import load_library

    B, R, _ = A.shape
    if not 1 <= R <= _R_MAX:
        raise ValueError(f"ns_packed takes 1 <= R <= {_R_MAX}, got R={R}")
    if iters < 0:
        raise ValueError("iters must be >= 0")
    if resid_only and x0 is None:
        raise ValueError("resid_only needs x0")
    if probe_skip and (x0 is None or resid_only):
        raise ValueError("probe_skip needs x0 and writes X")
    _check_cuda("A", A, (B, R, R))
    if x0 is not None:
        _check_cuda("x0", x0, (B, R, R))
        if x0.device != A.device:
            raise ValueError("x0 and A must be on one device")
    X = None if resid_only else torch.empty_like(A)
    resid = torch.empty((B,), dtype=torch.float32, device=A.device)
    if B == 0:
        return X, resid
    lib = load_library("ns_inverse")
    with torch.cuda.device(A.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(A.device).cuda_stream)
        if probe_skip:
            # one call, two launches on this stream: the probe writes every
            # x0's residual to r0, the refine reads its group's
            r0 = torch.empty((B,), dtype=torch.float32, device=A.device)
            rc = lib.ns_packed_probe_skip(_ptr(A), _ptr(x0), _ptr(X), _ptr(resid), _ptr(r0),
                                          B, R, _probe_skip_groups(R), iters, stream)
        else:
            rc = lib.ns_packed(_ptr(A), _ptr(x0), _ptr(X), _ptr(resid), B, R, iters,
                               int(x0 is not None), int(resid_only), stream)
    name = "probe_skip" if probe_skip else "ns_packed"
    _raise_on(rc, lib, name)
    KERNEL_LAUNCHES[name] += 1
    return X, resid


def _spd_inverse_cuda(A):
    """Launch the ``spd_inverse`` kernel: one warp per matrix for R <= 64,
    four warps per matrix above."""
    from ._build import load_library

    B, R, _ = A.shape
    if not 1 <= R <= _R_MAX:
        raise ValueError(f"spd_inverse takes 1 <= R <= {_R_MAX}, got R={R}")
    _check_cuda("A", A, (B, R, R))
    out = torch.empty_like(A)
    if B == 0:
        return out
    lib = load_library("spd_inverse")
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = lib.spd_inverse(_ptr(A), _ptr(out), B, R, ctypes.c_void_p(stream))
    _raise_on(rc, lib, "spd_inverse")
    KERNEL_LAUNCHES["spd_inverse"] += 1
    return out


def _check_gram_plan(plan: GramPlan, T: int, R: int) -> None:
    """Refuse a streaming plan the kernel would refuse: R past 40, warps or
    blocks out of range, or a layout other than the kernel's or past
    232,448 bytes."""
    if plan.path == "block":
        return
    if plan.path != "stream":
        raise ValueError(f"unknown ns_gram path {plan.path!r}")
    smem = _gram_stream_smem(T, R, plan.warps)
    if not (R <= _GS_R_MAX and 1 <= plan.warps <= _GS_WARPS_MAX and plan.per >= 1
            and plan.threads == 32 * (plan.warps + 1) and plan.smem == smem <= SMEM_MAX):
        raise ValueError(f"ns_gram streaming plan {plan} does not fit T={T} R={R} "
                         f"({smem} bytes; R <= {_GS_R_MAX})")


def _check_pairs_plan(plan: PairsPlan, Z: int, S: int, T: int, R: int) -> None:
    """Refuse a long-T plan the kernels would refuse: an unknown path or
    tile shape, stages outside 3-4, no blocks, a layout other than the
    kernel's or past 232,448 bytes, or an unknown copy path."""
    if plan.path == "tiled":
        return
    if plan.path != "stream":
        raise ValueError(f"unknown ns_gram_pairs path {plan.path!r}")
    for kind, gemm in ((0, plan.gram), (1, plan.v)):
        if gemm is None:  # this GEMM on the tiled kernel
            continue
        ok = 0 <= gemm.shape < len(_PAIRS_SHAPES)
        if ok:
            bm, bn, cw, hw = _PAIRS_SHAPES[gemm.shape]
            smem = _pairs_smem(kind, bm, bn, R, gemm.stages)
            ok = ((gemm.bm, gemm.bn, gemm.threads) == (bm, bn, 32 * (cw + hw))
                  and gemm.stages in _PG_STAGES and gemm.grid >= 1
                  and gemm.smem == smem <= SMEM_MAX
                  and gemm.copy in ("tma", "async4"))
        if not ok:
            raise ValueError(f"ns_gram_pairs plan {plan} does not fit Z={Z} S={S} T={T} R={R}")


def _ns_gram_cuda(G, w, iters: int = 16, x0=None, resid_only: bool = False,
                  want_v: bool = False, design: Optional[str] = None, plan=None):
    """Launch ``ns_gram`` in ``design`` (default ``_ns_gram_design(T, R)``):
    ``"per_matrix"``, under ``plan`` (a ``GramPlan``, default
    ``gram_plan``'s: the streaming path or a thread block per matrix), or
    ``"pairs"``, the Gram GEMM, the Newton-Schulz launch and the v GEMM on a
    (Z, S, R (R + 1) / 2) scratch (counted as one launch), under ``plan`` (a
    ``PairsPlan``, default ``pairs_plan``'s; ``TILED_PLAN`` runs the
    register-tiled GEMMs)."""
    from ._build import load_library

    Z, T, R = G.shape
    S = w.shape[1]
    design = _ns_gram_design(T, R) if design is None else design
    if design not in ("per_matrix", "pairs"):
        raise ValueError(f"unknown ns_gram design {design!r}")
    if not 1 <= R <= _R_MAX:
        raise ValueError(f"ns_gram takes 1 <= R <= {_R_MAX}, got R={R}")
    if iters < 0:
        raise ValueError("iters must be >= 0")
    if resid_only and x0 is None:
        raise ValueError("resid_only needs x0")
    if plan is not None:
        if isinstance(plan, PairsPlan) != (design == "pairs"):
            raise ValueError("a GramPlan is the per-matrix design's, a PairsPlan the "
                             "long-T design's")
        if design == "pairs":
            _check_pairs_plan(plan, Z, S, T, R)
        else:
            _check_gram_plan(plan, T, R)
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
    lib = load_library("ns_inverse")
    with torch.cuda.device(G.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(G.device).cuda_stream)
        flags = (Z, S, T, R, iters, int(x0 is not None), int(resid_only), int(want_v))
        nsm = torch.cuda.get_device_properties(G.device).multi_processor_count
        if design == "pairs":
            pairs = torch.empty((Z, S, R * (R + 1) // 2), dtype=torch.float32,
                                device=G.device)
            if plan is None:
                plan = pairs_plan(Z, S, T, R, nsm)
            args = (_ptr(G), _ptr(w), _ptr(x0), _ptr(X), _ptr(resid), _ptr(v), _ptr(pairs),
                    *flags)
            # shape -1: that GEMM on the tiled kernel (both, TILED_PLAN)
            gemms = [(g.shape, g.grid, g.stages, int(g.copy == "tma")) if g else (-1, 0, 0, 0)
                     for g in (plan.gram, plan.v)]
            rc = lib.ns_gram_pairs(*args, *gemms[0], *gemms[1], nsm, stream)
        else:
            if plan is None:
                plan = gram_plan(T, R, Z, nsm)
            if plan.path == "stream":
                rc = lib.ns_gram_stream(_ptr(G), _ptr(w), _ptr(x0), _ptr(X), _ptr(resid),
                                        _ptr(v), *flags, plan.warps, min(plan.per, S),
                                        stream)
            else:
                rc = lib.ns_gram(_ptr(G), _ptr(w), _ptr(x0), _ptr(X), _ptr(resid), _ptr(v),
                                 *flags, stream)
    _raise_on(rc, lib, "ns_gram")
    KERNEL_LAUNCHES["ns_gram"] += 1
    if design == "pairs":
        if plan.path == "stream" and (plan.gram is not None or plan.v is not None):
            KERNEL_LAUNCHES["ns_gram_pairs_stream"] += 1
    elif plan is not None and plan.path == "stream":
        KERNEL_LAUNCHES["ns_gram_stream"] += 1
    return X, resid, v


def ns_packed(A, iters: int = 16, x0=None, resid_only: bool = False,
              probe_skip: bool = False):
    """Newton-Schulz (I + A)^{-1} for A (B, R, R): (X or None, max residual).

    ``probe_skip`` (with x0) keeps the carry of every group that passes its
    probe and refines the others (see ``_ns_packed_plain``).  The residual
    max propagates NaN.  CPU tensors run the plain version; CUDA tensors
    launch the kernel.
    """
    fn = _ns_packed_cuda if A.is_cuda else _ns_packed_plain
    X, resid = fn(A, iters, x0, resid_only, probe_skip)
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


def _ok(resid: torch.Tensor) -> torch.Tensor:
    """The residual contract as a 0-d device bool: finite and below
    tolerance (NaN fails)."""
    return torch.isfinite(resid) & (resid < _RESID_TOL)


def _checked(X, resid, fallback):
    """Accept X (fresh from a kernel) when its Newton-Schulz residual
    converged, else take ``fallback`` (``control.cond``)."""
    return control.cond(_ok(resid), lambda: X, fallback)


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
        control.tally(FALLBACKS, "packed_exact")
        return _spd_inverse_exact(flat + _eye(R, flat))

    def cold():
        X, resid = ns_packed(flat, iters)

        def escalate():
            control.tally(FALLBACKS, "packed_escalate")
            X2, r2 = ns_packed(flat, iters, x0=X)
            return _checked(X2, r2, exact)

        return _checked(X, resid, escalate).reshape(shape)

    if warm is None:
        return cold()
    x0w = warm.to(A.dtype).reshape(flat.shape).contiguous()

    def refine():
        Xw, resid = ns_packed(flat, warm_iters, x0=x0w)

        def refine_failed():
            control.tally(FALLBACKS, "packed_refine_fail")
            return cold()

        return _checked(Xw.reshape(shape), resid, refine_failed)

    if not probe:
        return refine()
    if _FUSED_PROBE:
        # one launch: groups whose carry passes the probe keep it, the
        # others are refined (vlgp_tpu/ops/spd.py:316-328)
        Xw, resid = ns_packed(flat, warm_iters, x0=x0w, probe_skip=True)

        def fused_failed():
            control.tally(FALLBACKS, "packed_refine_fail")
            return cold()

        return _checked(Xw.reshape(shape), resid, fused_failed)
    _, resid0 = ns_packed(flat, 0, x0=x0w, resid_only=True)

    def probe_rejected():
        control.tally(FALLBACKS, "packed_probe_reject")
        return refine()

    return control.cond(_ok(resid0), lambda: control.private(x0w).reshape(shape),
                        probe_rejected)


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
        control.tally(FALLBACKS, "gram_exact")
        A = torch.einsum("ztr,zst,ztq->zsrq", G, w, G)
        Xe = _spd_inverse_exact(A + _eye(R, A))
        if want_v:
            return Xe, torch.einsum("ztr,zsrq,ztq->zst", G, Xe, G)
        return Xe

    def cold():
        X, resid, v = kern(iters)

        def escalate():
            control.tally(FALLBACKS, "gram_escalate")
            X2, r2, v2 = kern(iters, x0=X)
            return _checked(pack(X2, v2), r2, exact)

        return _checked(pack(X, v), resid, escalate)

    if warm is None:
        return cold()
    warm = warm.to(G.dtype).contiguous()

    def refine():
        Xw, resid, vw = kern(warm_iters, x0=warm)

        def refine_failed():
            control.tally(FALLBACKS, "gram_refine_fail")
            return cold()

        return _checked(pack(Xw, vw), resid, refine_failed)

    if not probe:
        return refine()
    _, resid0, v0 = kern(0, x0=warm, resid_only=True)

    def probe_rejected():
        control.tally(FALLBACKS, "gram_probe_reject")
        return refine()

    return control.cond(_ok(resid0), lambda: pack(control.private(warm), v0), probe_rejected)


# ---------------------------------------------------------------------------
# Batched SPD inverse (vlgp_tpu/ops/spd.py:363-390)
# ---------------------------------------------------------------------------


def spd_inverse(A, force: Optional[str] = None):
    """Batched inverse of SPD matrices A (..., R, R).

    ``force``: None picks the kernel route for float32 with R <= 64 (the
    ``spd_inverse`` kernel on CUDA, its plain version on the CPU) and the
    exact Cholesky route otherwise; ``"pallas"`` takes the kernel route at
    any R the kernel takes (R <= 128 on CUDA); ``"xla"`` the exact route;
    ``"interpret"`` the plain version on any device (the names of the JAX
    package's options).
    """
    R = A.shape[-1]
    flat = A.reshape(-1, R, R).contiguous()
    if force == "interpret":
        out = _spd_inverse_plain(flat)
    elif force == "pallas" or (force is None and A.dtype == torch.float32 and R <= _LANE):
        out = _spd_inverse_cuda(flat) if flat.is_cuda else _spd_inverse_plain(flat)
    elif force in (None, "xla"):
        out = _spd_inverse_exact(flat)
    else:
        raise ValueError(f"unknown force {force!r}")
    return out.reshape(A.shape)


def spd_solve(A, b):
    """Solve A x = b for SPD A (..., R, R) and b (..., R)."""
    return torch.einsum("...rq,...q->...r", spd_inverse(A), b)
