"""Fused E-step sweep: every Newton sweep of the E-step in one kernel.

Counterpart of ``vlgp_tpu/ops/sweep.py``.  The E-step's sweeps are
independent per segment, so one launch runs the whole chain for every
group of ``bs`` segments, all Z latents inside: the predictor, the working
residual, the Woodbury step clipped to ``dmu_bound``, the weight refresh,
the Gram and a warm Newton-Schulz refine of X = (I + G'WG)^{-1} (with
escalation and a cold restart per group) and, under VB, v = diag(G X G').
Each group stops on its own norms (|dmu| <= tol |mu| after at least two
sweeps) and reports its worst Newton-Schulz residual; the E-step falls back
to the per-sweep composition when any group's residual misses 1e-2
(``models/vlgp.py:estep``).

``sweep`` runs ``_sweep_plain`` for CPU tensors and launches the
``csrc/sweep.cu`` kernel (``_sweep_cuda``: one cooperative launch of a
persistent grid that walks the segments and the (latent, segment) matrices
of the live groups stage by stage, with a grid sync between stages) for
CUDA tensors.  Both return
(mu, w, v, dmu, X, resid, counts): the posterior tensors (Z, S, T), X
(Z, S, R, R), the worst residual of each group and, per group, the sweeps,
refine passes and Newton-Schulz rounds it ran.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .spd import (_R_MAX, _RESID_TOL, KERNEL_LAUNCHES, ROUTE_CALLS, _check_cuda, _ptr,
                  _raise_on)

__all__ = ["sweep", "sweep_fused_eligible"]

_EXP_BOUND = 10.0  # ops/math.py:trunc_exp
# shared memory one thread block may use on an H100
_SMEM_MAX = 232448
# rows of G per streamed chunk (csrc/ns_common.cuh:TC)
_TC = 32
# block 0's record of a kernel launch (csrc/sweep.cu:Stat): grid syncs,
# blocks, blocks per SM
_STATS = ("syncs", "blocks", "blocks_per_sm")


def _sweep_vmem_bytes(Z, T, Y, R, bs) -> int:
    """The TPU kernel's VMEM estimate (``vlgp_tpu/ops/sweep.py:321-335``).

    In the port it sets no memory budget: with ``_pick_bs`` it fixes the
    exit groups (a group of ``bs`` segments sweeps, escalates, restarts and
    exits together), so that the port takes the same trip counts as the
    JAX package under the same switch."""
    gpt = max(1, 128 // R)
    tiles = -(-(Z * bs) // gpt)
    big = 4 * bs * T * Y
    return (4 * big + 10 * 4 * Z * bs * T + 3 * 4 * Z * bs * R * R
            + 2 * 4 * tiles * 128 * 128 + 2 * 4 * tiles * 128 * 128)


def _pick_bs(Z, T, Y, R, budget: int = 11 * 2**20) -> int:
    """The exit-group size: the TPU kernel's block size
    (``vlgp_tpu/ops/sweep.py:338-345``), 0 where no block fits.  16 at the
    flagship E-step (Z5 T50 Y100 R40); 0 at the T = 1000 final inference."""
    for bs in (64, 48, 32, 24, 16, 8):
        if _sweep_vmem_bytes(Z, T, Y, R, bs) <= budget:
            return bs
    return 0


def _tiles(R) -> int:
    """Tiles per side of a padded R x R matrix (``csrc/ns_common.cuh:tiles_per_side``)."""
    return (R + 3) // 4


def _threads(R) -> int:
    """Threads of a kernel block: one per 4 x 4 tile, rounded up to a warp
    (``csrc/ns_common.cuh:tiled_threads``): 128 at R = 40, 1024 at R = 128."""
    return -(-(_tiles(R) ** 2) // 32) * 32


def _sweep_smem_bytes(Z, T, Y, R, ngroups: int = 1) -> int:
    """Dynamic shared memory of one kernel block (``csrc/sweep.cu``): the
    refine's Mt, X, Xt (4 nb rows of stride ``padded_ld``), G chunk, weights,
    partial sums of v and one float per warp, or the segment stage's four
    Z x T vectors, the mask, three Z x R vectors, a and a2 (Z x Y) and one
    row each of xb and y (Y rounded up to an odd number of 16-byte words),
    whichever is larger, then two bit sets of the ``ngroups`` exit groups."""
    nb, nwarp = _tiles(R), _threads(R) // 32
    ld = 4 * (nb | 1)
    ns = 3 * 4 * nb * ld + _TC * 5 * nb + _TC + nwarp
    seg = 4 * Z * T + T + 3 * Z * R + 2 * Z * Y + 2 * 4 * ((-(-Y // 4)) | 1)
    return 4 * (max(ns, seg) + 2 * -(-ngroups // 32))


def sweep_fused_eligible(data, params, G, dist) -> bool:
    """Static eligibility (``vlgp_tpu/ops/sweep.py:348-360``): no model axis
    in ``dist`` (a ``models.vlgp.Dist``; the sweep's channel contractions
    would need all_reduces inside the kernel), float32, R <= 128, an exit
    group that fits, and a block the kernel can launch."""
    Z, T, R = G.shape
    S, Y = data.y.shape[0], data.y.shape[-1]
    bs = _pick_bs(Z, T, Y, R)
    return (
        dist.model is None
        and G.dtype == torch.float32
        and data.y.dtype == torch.float32
        and params.a.dtype == torch.float32
        and 1 <= R <= _R_MAX
        and data.y.shape[1] == T
        and bs > 0
        and _sweep_smem_bytes(Z, T, Y, R, -(-S // bs)) <= _SMEM_MAX
    )


def _padded(y, xb, mask, a, noise, poisson, muz, wz, vz, xinv, bs):
    """Float32 contiguous operands with S zero-padded to a multiple of bs
    (zero-padded segments are inert: mask 0 -> w 0 -> X = I, delta 0; a
    zero-padded carry fails its probe and restarts its group cold, as in
    the TPU kernel) and the per-channel factors of the kernel."""
    S = y.shape[0]
    pad = -(-S // bs) * bs - S
    f32 = torch.float32
    padS = lambda t, dim: torch.nn.functional.pad(
        t.to(f32), (0, 0) * (t.ndim - 1 - dim) + (0, pad)).contiguous()
    a = a.to(f32).contiguous()
    ops = dict(
        y=padS(y, 0), xb=padS(xb, 0), mask=padS(mask, 0),
        a=a, a2=(0.5 * a * a).contiguous(),
        pois=poisson.to(f32).contiguous(),
        invn=(1.0 / torch.clamp(noise.to(f32), min=1e-30)).contiguous(),
        mu=padS(muz, 1), w=padS(wz, 1), v=padS(vz, 1),
        X=None if xinv is None else padS(xinv, 1),
    )
    return ops


def _sweep_plain(y, xb, mask, a, noise, poisson, G, muz, wz, vz, xinv, *,
                 niter: int, tol: float, dmu_bound: float, ns_iters: int,
                 ns_warm_iters: int, vb: bool, bs: int):
    """Plain version of the ``sweep`` kernel, the TPU kernel body's semantics
    (``vlgp_tpu/ops/sweep.py:74-318``) with all groups batched and a mask of
    the groups still sweeping; a group that has exited keeps its state."""
    S = y.shape[0]
    o = _padded(y, xb, mask, a, noise, poisson, muz, wz, vz, xinv, bs)
    y, xb, mask, a, a2, pois, invn = (o[k] for k in ("y", "xb", "mask", "a", "a2",
                                                      "pois", "invn"))
    G = G.to(torch.float32)
    Z, T, R = G.shape
    SP = y.shape[0]
    nblk = SP // bs
    dev = y.device
    eye = torch.eye(R, dtype=torch.float32, device=dev)
    counts = torch.zeros((nblk, 3), dtype=torch.int32, device=dev)

    def group_max(x):  # (Z, SP) -> (nblk,), NaN-propagating
        return x.reshape(Z, nblk, bs).amax(dim=(0, 2))

    def group_sum(x):  # (Z, SP, T) -> (nblk,)
        return x.reshape(Z, nblk, bs, T).sum(dim=(0, 2, 3))

    def per_matrix(g):  # (nblk,) -> (Z, SP, 1, 1)
        return g.repeat_interleave(bs)[None, :, None, None].expand(Z, SP, 1, 1)

    def gram(w):
        return torch.einsum("ztr,zst,ztq->zsrq", G, w, G) + eye

    def refine_pass(M, X, live, cold, iters):
        """``iters`` rounds on every matrix, kept for the live groups only;
        returns (X, per-group residual)."""
        if cold:
            lhat = M.abs().sum(-1).amax(-1)
            Xn = (2.0 / (1.0 + lhat))[..., None, None] * eye
        else:
            Xn = X
        for _ in range(iters):
            Xn = Xn @ (2.0 * eye - M @ Xn)
        r = group_max((M @ Xn - eye).abs().amax(dim=(-2, -1)))
        counts[:, 1] += live.int()
        counts[:, 2] += live.int() * iters
        return torch.where(per_matrix(live), Xn, X), r

    def refine(M, X, live, cold, first):
        # first pass, then up to two escalation passes (:165-183)
        X, r = refine_pass(M, X, live, cold, first)
        for _ in range(2):
            esc = live & ~(r < _RESID_TOL)
            if not bool(esc.any()):
                break
            X, r2 = refine_pass(M, X, esc, False, ns_iters)
            r = torch.where(esc, r2, r)
        return X, r

    def ns_refine(M, X, live, cold, first, was_warm):
        # a failed warm refine restarts the group cold (:185-204)
        X, r = refine(M, X, live, cold, first)
        restart = live & ~(r < _RESID_TOL)
        if was_warm and bool(restart.any()):
            X, r2 = refine(M, X, restart, True, ns_iters)
            r = torch.where(restart, r2, r)
        return X, r

    def predictor(mu, v):
        eta, arg = xb, torch.zeros_like(xb)
        for z in range(Z):
            eta = eta + mu[z][:, :, None] * a[z]
            arg = arg + v[z][:, :, None] * a2[z]
        return eta, torch.exp(torch.clamp(eta + arg, max=_EXP_BOUND))

    maskz = mask[None]
    mu, w, v = o["mu"], o["w"] * maskz, o["v"]
    dmu = torch.zeros_like(mu)
    all_groups = torch.ones(nblk, dtype=torch.bool, device=dev)
    if o["X"] is not None:
        X, worst = ns_refine(gram(w), o["X"], all_groups, False, ns_warm_iters, True)
    else:
        X, worst = ns_refine(gram(w), torch.zeros((Z, SP, R, R), device=dev), all_groups,
                             True, ns_iters, False)
    nd = torch.ones(nblk, device=dev)
    nm = torch.ones(nblk, device=dev)
    for i in range(niter):
        live = all_groups if tol <= 0 else (nd > tol * tol * nm) | (i < 2)
        if not bool(live.any()):
            break
        sel = per_matrix(live)[..., 0]  # (Z, SP, 1)
        eta, r = predictor(mu, v)
        res = (pois * (y - r) + (1.0 - pois) * (y - eta) * invn) * mask[..., None]
        s = torch.einsum("sty,zy->zst", res, a)
        Gts = torch.einsum("ztr,zst->zsr", G, s)
        u = torch.einsum("ztr,zsr->zst", G, Gts) - mu
        Gwu = torch.einsum("ztr,zst->zsr", G, w * u)
        Mv = torch.einsum("zsrq,zsq->zsr", X, Gwu)
        delta = u - torch.einsum("ztr,zsr->zst", G, Mv)
        delta = torch.clamp(delta, -dmu_bound, dmu_bound) * maskz
        mu_n = mu + delta
        # weight refresh under the new mu and the old v (:276-279)
        _, r = predictor(mu_n, v)
        U = pois * r + (1.0 - pois) * invn
        w_n = torch.einsum("sty,zy->zst", U, 2.0 * a2) * maskz
        X, r_ns = ns_refine(gram(w_n), X, live, False, ns_warm_iters, True)
        worst = torch.where(live, torch.maximum(worst, r_ns), worst)
        mu = torch.where(sel, mu_n, mu)
        w = torch.where(sel, w_n, w)
        dmu = torch.where(sel, delta, dmu)
        if vb:
            v_n = torch.einsum("ztr,zsrq,ztq->zst", G, X, G) * maskz
            v = torch.where(sel, v_n, v)
        nd = torch.where(live, group_sum(dmu * dmu), nd)
        nm = torch.where(live, group_sum(mu * mu), nm)
        counts[:, 0] += live.int()
    return (mu[:, :S], w[:, :S], v[:, :S], dmu[:, :S], X[:, :S], worst, counts)


def _scratch(Z, SP, ngrp, device) -> dict:
    """The kernel's scratch (``csrc/sweep.cu:SweepArgs``): the residual of
    each matrix in two parities, |dmu|^2 and |mu|^2 of each segment in two
    sweep parities, each group's last residual."""
    f32 = dict(dtype=torch.float32, device=device)
    return dict(rmat=torch.empty((2 * Z * SP,), **f32), npart=torch.empty((4 * SP,), **f32),
                rlast=torch.empty((ngrp,), **f32))


def _sweep_cuda(y, xb, mask, a, noise, poisson, G, muz, wz, vz, xinv, *,
                niter: int, tol: float, dmu_bound: float, ns_iters: int,
                ns_warm_iters: int, vb: bool, bs: int, grid: Optional[dict] = None):
    """Launch the ``sweep`` kernel: one cooperative launch whose grid is
    every block that fits on the card at once.  Raises if the card refuses
    it (a grid that cannot be co-resident included); nothing falls back.
    With ``grid``, the kernel also counts its grid syncs, and ``grid`` takes
    them, the blocks and the blocks per SM (``_STATS``) as int64 scalars on
    the card, to read after a synchronize."""
    from ._build import load_library

    Z, T, R = G.shape
    S, _, Y = y.shape
    if not 1 <= R <= _R_MAX:
        raise ValueError(f"sweep takes 1 <= R <= {_R_MAX}, got R={R}")
    if bs < 4 or bs % 4 or min(niter, ns_iters, ns_warm_iters) < 0:
        raise ValueError("sweep needs bs a multiple of 4 and nonnegative iteration counts")
    ngrp = -(-S // bs)
    smem = _sweep_smem_bytes(Z, T, Y, R, ngrp)
    if smem > _SMEM_MAX:
        raise ValueError(f"sweep needs {smem} bytes of shared memory (Z={Z}, T={T}, "
                         f"Y={Y}, R={R}), more than a block may use")
    o = _padded(y, xb, mask, a, noise, poisson, muz, wz, vz, xinv, bs)
    SP = o["y"].shape[0]
    for name, shape in (("y", (SP, T, Y)), ("xb", (SP, T, Y)), ("mask", (SP, T)),
                        ("a", (Z, Y)), ("pois", (Y,)), ("invn", (Y,)),
                        ("mu", (Z, SP, T)), ("w", (Z, SP, T)), ("v", (Z, SP, T))):
        _check_cuda(name, o[name], shape)
    G = G.to(torch.float32).contiguous()
    _check_cuda("G", G, (Z, T, R))
    if o["X"] is not None:
        _check_cuda("xinv", o["X"], (Z, SP, R, R))
        X = o["X"]
    else:
        X = torch.empty((Z, SP, R, R), dtype=torch.float32, device=G.device)
    if any(t.device != G.device for t in (o["y"], o["mu"], X)):
        raise ValueError("every operand of sweep must be on one device")
    dmu = torch.zeros_like(o["mu"])
    sc = _scratch(Z, SP, ngrp, G.device)
    resid = torch.empty((ngrp,), dtype=torch.float32, device=G.device)
    counts = torch.empty((ngrp, 3), dtype=torch.int32, device=G.device)
    stats = None if grid is None else torch.empty((len(_STATS),), dtype=torch.int64,
                                                  device=G.device)
    lib = load_library("sweep")
    with torch.cuda.device(G.device):
        stream = torch.cuda.current_stream(G.device).cuda_stream
        rc = lib.vlgp_sweep(
            *(_ptr(t) for t in (o["y"], o["xb"], o["mask"], o["a"], o["a2"], o["pois"],
                                o["invn"], G, o["mu"], o["w"], o["v"], dmu, X,
                                sc["rmat"], sc["npart"], sc["rlast"], resid, counts,
                                stats)),
            SP, T, Y, Z, R, bs, niter, int(tol > 0), tol * tol, dmu_bound,
            ns_iters, ns_warm_iters, int(vb), int(xinv is not None),
            ctypes.c_void_p(stream))
    _raise_on(rc, lib, "sweep")
    KERNEL_LAUNCHES["sweep"] += 1
    if grid is not None:
        grid.update(zip(_STATS, stats))
    return (o["mu"][:, :S], o["w"][:, :S], o["v"][:, :S], dmu[:, :S], X[:, :S],
            resid, counts)


def sweep(y, xb, mask, a, noise, poisson, G, muz, wz, vz,
          xinv: Optional[torch.Tensor] = None, *, niter: int, tol: float,
          dmu_bound: float, ns_iters: int, ns_warm_iters: int, vb: bool):
    """The whole E-step for every group of ``_pick_bs`` segments.

    y/xb: (S, T, Y); mask: (S, T); a: (Z, Y); noise/poisson: (Y,);
    G: (Z, T, R); muz/wz/vz: (Z, S, T); xinv: (Z, S, R, R) or None.
    Returns (muz, wz, vz, dmuz, X, resid, counts), see the module notes.
    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    ROUTE_CALLS["sweep"] += 1
    Z, T, R = G.shape
    bs = _pick_bs(Z, T, y.shape[-1], R)
    if bs == 0:
        raise ValueError(f"no exit group fits Z={Z} T={T} Y={y.shape[-1]} R={R}")
    fn = _sweep_cuda if y.is_cuda else _sweep_plain
    return fn(y, xb, mask, a, noise, poisson, G, muz, wz, vz, xinv, niter=niter,
              tol=tol, dmu_bound=dmu_bound, ns_iters=ns_iters,
              ns_warm_iters=ns_warm_iters, vb=vb, bs=bs)
