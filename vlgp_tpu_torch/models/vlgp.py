"""vLGP inference engine: batched variational EM on one device.

Counterpart of ``vlgp_tpu/models/vlgp.py`` (reference ``vlgp/core.py``).
The reference's loops over trials, latents and neurons are independent
given the sufficient statistics, so each phase is a batched tensor
computation; the hot-loop math runs latent-major (Z, N, T).  The JAX
package's on-device loop exits and branches go through ``ops.control``:
Python loops and host branches when run eagerly, conditional nodes of a
CUDA graph under a capture (``models/driver.py``).

Every phase takes a :class:`Dist` naming the process group of each mesh
axis; with the default (no groups) it runs on one device.  ``data`` splits
segments/trials over the ranks of a group: cross-segment sums become
``all_reduce``s.  ``model`` splits the channels: the E-step's channel
contractions (``residual @ a`` and the weight refresh) and the norms of the
loading become ``all_reduce``s over the model group, so every rank of a
data row holds the same posterior.  Every branch whose body holds a
collective decides on reduced (rank-uniform) values, so no rank waits on a
collective the others skip.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as tdist

from ..config import Config, Params
from ..data import TrialSet
from ..ops import control
from ..ops.estep import _eta, _member_weights, _rates, _safe_noise, estep_project, estep_step
from ..ops.linalg import svd_loading
from ..ops.mstep import _solve, moving, mstep_stats, mstep_update, squared_norms
from ..ops.spd import FALLBACKS, _ok, inv_one_plus_gram, inv_one_plus_psd
from ..ops.sweep import sweep as fused_sweep
from ..ops.sweep import sweep_fused_eligible

# Fused E-step sweep (ops/sweep.py): every Newton sweep of the E-step in one
# launch per call, the Woodbury inverses never leaving the kernel between
# sweeps.  VLGP_SWEEP_FUSED=1 enables it (vlgp_tpu/models/vlgp.py:51); the
# per-sweep composition is the default.
_SWEEP_FUSED = os.environ.get("VLGP_SWEEP_FUSED", "0") == "1"

__all__ = [
    "Dist",
    "COLLECTIVES",
    "estep",
    "estep_members",
    "infer_members",
    "mstep",
    "update_w",
    "update_v",
    "constrain_loading",
    "constrain_latent",
    "em_norms",
]


class Dist(NamedTuple):
    """Process group of each mesh axis (None: not sharded on that axis);
    the counterpart of ``vlgp_tpu.models.vlgp.Dist``, whose fields are axis
    names.  ``data`` splits segments, ``model`` channels."""

    data: Optional[object] = None
    model: Optional[object] = None


# collectives made in this process: calls by kind (``_all_reduce`` and
# ``parallel.mesh``'s broadcast and all_gather each add one per call), the
# all_reduces by axis, and the bytes of each all_reduce's buffer and each
# all_gather's part of one rank, by the axis whose group carried them
COLLECTIVES = {"all_reduce": 0, "broadcast": 0, "all_gather": 0,
               "all_reduce_data": 0, "all_reduce_model": 0,
               "bytes_data": 0, "bytes_model": 0}


def _count(kind: str, axis: str, t: torch.Tensor) -> None:
    """Add one ``kind`` collective of buffer ``t`` over ``axis`` to COLLECTIVES."""
    COLLECTIVES[kind] += 1
    if kind == "all_reduce":
        COLLECTIVES[f"all_reduce_{axis}"] += 1
    COLLECTIVES[f"bytes_{axis}"] += t.numel() * t.element_size()


def _all_reduce(x, dist: Dist, axis: str, op):
    """Reduce ``x`` (a tensor, or a sequence of tensors of one dtype sent as
    one flat buffer) over the ranks of ``dist``'s ``axis`` group on a copy;
    ``x`` itself when that axis has no group."""
    group = getattr(dist, axis)
    if group is None:
        return x
    parts = [x] if isinstance(x, torch.Tensor) else list(x)
    flat = torch.cat([t.reshape(-1) for t in parts])
    tdist.all_reduce(flat, op=op, group=group)
    _count("all_reduce", axis, flat)
    # each result in an allocation of its own, as an unreduced tensor is: a
    # library kernel may take another path for an unaligned view, and then
    # a world of one would not repeat the single-device fit bit for bit
    out, k = [], 0
    for t in parts:
        out.append(flat[k:k + t.numel()].reshape(t.shape).clone())
        k += t.numel()
    return out[0] if isinstance(x, torch.Tensor) else out


def _psum(x, dist: Dist, axis: str):
    """Sum over the ranks of ``dist``'s ``axis`` (``lax.psum`` over a mesh
    axis in ``vlgp_tpu``); the identity where the axis has no group."""
    return _all_reduce(x, dist, axis, tdist.ReduceOp.SUM)


def _pmax(x, dist: Dist, axis: str):
    """Max over the ranks of ``dist``'s ``axis`` (``lax.pmax``)."""
    return _all_reduce(x, dist, axis, tdist.ReduceOp.MAX)


def _zmajor(x):
    """(N, T, Z) -> (Z, N, T)."""
    return x.permute(2, 0, 1)


def _zminor(x):
    """(Z, N, T) -> (N, T, Z)."""
    return x.permute(1, 2, 0).contiguous()


def _xb(x, b):
    """Regressor contribution (core.py:66)."""
    return torch.einsum("stxy,xy->sty", x, b)


def _weights(U, a, dist: Dist):
    """w = U @ (a.T)^2, latent-major (core.py:104), summed over the
    channels of every model rank."""
    return _psum(torch.einsum("sty,zy->zst", U, a * a), dist, "model")


def _woodbury_inverse(G, wmz, iters: int = 16, warm=None, warm_iters: int = 8):
    """X = (I + G'WG)^{-1} for every (latent, segment) pair: the Gram
    matrices are built with an einsum and inverted by the ``ns_packed``
    route (float32) or the exact route."""
    GtWG = torch.einsum("ztr,zst,ztq->zsrq", G, wmz, G)
    return inv_one_plus_psd(GtWG, iters=iters, warm=warm, warm_iters=warm_iters)


def _marginal_variance(G, wmz, iters: int = 16):
    """VB marginal posterior variance v = diag(G (I + G'WG)^{-1} G')
    (core.py:105-114, 445-471)."""
    X = _woodbury_inverse(G, wmz, iters)
    return torch.einsum("ztr,zsrq,ztq->zst", G, X, G)


def estep(
    data: TrialSet, params: Params, G: torch.Tensor, config: Config,
    niter: Optional[int] = None, dist: Dist = Dist(),
    xinv: Optional[torch.Tensor] = None, return_xinv: bool = False,
):
    """E-step: up to Eniter Newton sweeps over all segments and latents
    (``infer_single_trial``, core.py:22-126).

    ``xinv`` warm-starts the first sweep's Woodbury inverse (Z, S, R, R);
    with ``return_xinv`` the final sweep's inverse is returned as
    ``(data, xinv)``.  ``config.estep_tol > 0`` stops once
    |dmu| <= estep_tol * |mu| after at least 2 sweeps
    (``control.bounded_while``); 0 runs the fixed count.  With ``_SWEEP_FUSED`` an
    eligible call runs every sweep in one ``ops.sweep.sweep`` call, whose
    groups of segments exit on their own norms.  Under ``dist.data`` the
    exit norms are summed and the fused call's residual maxed over the
    ranks before each test, so every rank sweeps the same count.  Under
    ``dist.model`` each sweep sums ``residual @ a`` and the weights over the
    model group (two (Z, S, T) all_reduces), so every rank of a data row
    sweeps the same posterior; the fused sweep is not eligible there
    (``ops.sweep.sweep_fused_eligible``).
    """
    niter = config.Eniter if niter is None else niter
    if niter < 1:
        return (data, xinv) if return_xinv else data

    y, mask = data.y, data.mask
    xb = _xb(data.x, params.b)
    a = params.a
    vb = config.method == "VB"
    maskz = mask[None]
    poisson, noise = params.poisson, params.noise

    def sweep(muz, wz, vz, X):
        # X is (I + G'WG)^{-1} at the carried weights wz (core.py:85-89).
        # Stage a (predictor, rates, residual, s) and stages b-c (the
        # Woodbury step, then the weights under the updated posterior,
        # core.py:100-104) are one kernel each on the card (ops/estep.py);
        # s and w are summed over the model group between and after them.
        s = _psum(estep_project(y, xb, mask, a, muz, vz, poisson, noise), dist, "model")
        muz, delta, wz = estep_step(G, s, muz, wz, X, mask, a, xb, vz, poisson, noise,
                                    config.dmu_bound)
        wz = _psum(wz, dist, "model")
        if vb:
            X, vz = inv_one_plus_gram(G, wz, iters=config.ns_iters, warm=X,
                                      warm_iters=config.ns_warm_iters, want_v=True)
            vz = vz * maskz
        else:
            X = inv_one_plus_gram(G, wz, iters=config.ns_iters, warm=X,
                                  warm_iters=config.ns_warm_iters)
        return muz, wz, vz, delta, X

    def core():
        """Per-sweep composition: one fused Gram + Newton-Schulz route call
        per sweep, the (Z, S, R, R) inverse carried between them."""
        muz = _zmajor(data.mu)
        wz = _zmajor(data.w) * maskz
        vz = _zmajor(data.v)
        dmuz = _zmajor(data.dmu)
        X = inv_one_plus_gram(G, wz, iters=config.ns_iters, warm=xinv,
                              warm_iters=config.ns_warm_iters)
        tol = config.estep_tol

        def keep_going(i, carry):
            if not (tol > 0 and i >= 2):
                return None
            muz, _, _, dmuz, _ = carry
            nd, nm = _psum((torch.sum(dmuz * dmuz), torch.sum(muz * muz)), dist, "data")
            return nd > tol * tol * nm

        return control.bounded_while(niter, keep_going,
                                     lambda c: sweep(c[0], c[1], c[2], c[4]),
                                     (muz, wz, vz, dmuz, X), name="estep_sweeps")

    if _SWEEP_FUSED and sweep_fused_eligible(data, params, G, dist):
        # the whole E-step in one launch (ops/sweep.py), with ``core`` as the
        # net when any group's inverse misses its residual contract
        # (vlgp_tpu/models/vlgp.py:262-290), through control.cond
        *fused, resid, _ = fused_sweep(
            y, xb, mask, a, params.noise, params.poisson, G,
            _zmajor(data.mu), _zmajor(data.w), _zmajor(data.v), xinv,
            niter=niter, tol=config.estep_tol, dmu_bound=config.dmu_bound,
            ns_iters=config.ns_iters, ns_warm_iters=config.ns_warm_iters, vb=vb)

        def net():
            control.tally(FALLBACKS, "sweep_core")
            return core()

        muz, wz, vz, dmuz, X = control.cond(_ok(_pmax(resid.amax(), dist, "data")),
                                            lambda: tuple(fused), net)
    else:
        muz, wz, vz, dmuz, X = core()
    out = data.replace(mu=_zminor(muz), w=_zminor(wz), v=_zminor(vz),
                       dmu=_zminor(dmuz))
    return (out, X) if return_xinv else out


def update_w(data: TrialSet, params: Params, config: Config, dist: Dist = Dist()
             ) -> TrialSet:
    """Recompute likelihood precision weights (core.py:419-442); local to
    each segment, summed over the model axis's channels."""
    muz, vz = _zmajor(data.mu), _zmajor(data.v)
    eta = _eta(muz, params.a, _xb(data.x, params.b))
    r = _rates(eta, vz, params.a)
    U = torch.where(params.poisson, r, 1.0 / _safe_noise(params.noise))
    wz = _weights(U, params.a, dist) * data.mask[None]
    return data.replace(w=_zminor(wz))


def update_v(data: TrialSet, params: Params, G, config: Config, dist: Dist = Dist()
             ) -> TrialSet:
    """Recompute the VB marginal posterior variance (core.py:445-471);
    local to each segment and to the (model-summed) weights."""
    if config.method != "VB":
        return data
    wz = _zmajor(data.w) * data.mask[None]
    vz = _marginal_variance(G, wz, iters=config.ns_iters) * data.mask[None]
    return data.replace(v=_zminor(vz))


# ---------------------------------------------------------------------------
# B held-out problems at once, folded into the segment axis
# (vlgp_tpu/model_selection.py:_lono_scorer's vmap)
# ---------------------------------------------------------------------------


def estep_members(data: TrialSet, params: Params, G: torch.Tensor, config: Config,
                  cmask: torch.Tensor, state: Tuple[torch.Tensor, ...],
                  niter: Optional[int] = None):
    """The E-step of B problems at once, on one device: member b runs on
    ``data``'s S segments with the channel weights ``cmask[b]`` (B, Y), 0 on
    the channels it holds out.  ``state`` is its (mu, w, v, dmu), each
    latent-major (Z, B*S, T) and member-major, so every kernel sees B*S
    segments.  Returns the state after the sweeps and each member's sweep
    count (B,).

    A zero channel weight multiplies that channel's residual and weight,
    which is all a zero loading column changes in the posterior
    (``vlgp_tpu/model_selection.py:150-155``).  Each round is one
    ``estep_project`` and one ``estep_step`` over the B*S segments (their
    member axis: y, xb and the mask shared, ``cmask`` the channel weights),
    then the inverse route.  With ``estep_tol > 0`` each
    member stops on its own norms, |dmu|^2 <= tol^2 |mu|^2 after at least 2
    sweeps, as ``vmap`` of ``vlgp_tpu``'s while loop does: a stopped
    member's state is kept while the others sweep on, and the loop ends when
    none is left or at ``niter`` (one host read per sweep; rounds in
    ``control.TRIPS["lono_rounds"]``).  The inverse routes decide once for
    all members.  The fused sweep (``ops/sweep.py``) is never used: its
    kernel has no channel weights.
    """
    niter = config.Eniter if niter is None else niter
    B = cmask.shape[0]
    y, a, mask = data.y, params.a, data.mask
    poisson, noise = params.poisson, params.noise
    xb = _xb(data.x, params.b)
    vb = config.method == "VB"
    maskz = mask.repeat(B, 1)[None]

    def sweep(muz, wz, vz, X):
        s = estep_project(y, xb, mask, a, muz, vz, poisson, noise, cmask)
        muz, delta, wz = estep_step(G, s, muz, wz, X, mask, a, xb, vz, poisson, noise,
                                    config.dmu_bound, cmask)
        if vb:
            X, vz = inv_one_plus_gram(G, wz, iters=config.ns_iters, warm=X,
                                      warm_iters=config.ns_warm_iters, want_v=True)
            vz = vz * maskz
        else:
            X = inv_one_plus_gram(G, wz, iters=config.ns_iters, warm=X,
                                  warm_iters=config.ns_warm_iters)
        return muz, wz, vz, delta, X

    muz, wz, vz, dmuz = state
    wz = wz * maskz
    X = inv_one_plus_gram(G, wz, iters=config.ns_iters, warm_iters=config.ns_warm_iters)
    tol = config.estep_tol
    alive = torch.ones(B, dtype=torch.bool, device=y.device)
    sweeps = torch.zeros(B, dtype=torch.int64, device=y.device)

    def by_member(t):
        return t.reshape(t.shape[0], B, -1)

    def sq(t):
        t = by_member(t)
        return torch.sum(t * t, dim=(0, 2))

    def keep_going(i, carry):
        nonlocal alive
        if not (tol > 0 and i >= 2):
            return None
        alive = alive & (sq(carry[3]) > tol * tol * sq(carry[0]))
        return alive.any()

    def body(carry):
        nonlocal sweeps
        new = sweep(carry[0], carry[1], carry[2], carry[4])
        sweeps = sweeps + alive
        keep = alive.view(1, B, 1)
        return tuple(torch.where(keep, by_member(n), by_member(o)).reshape(o.shape)
                     for n, o in zip(new, carry))

    muz, wz, vz, dmuz, _ = control.bounded_while(niter, keep_going, body,
                                                 (muz, wz, vz, dmuz, X), name="lono_rounds")
    return (muz, wz, vz, dmuz), sweeps


def infer_members(data: TrialSet, params: Params, G: torch.Tensor, config: Config,
                  cmask: torch.Tensor, niter: Optional[int] = None):
    """``update_w``, ``update_v`` and :func:`estep_members` from a zero
    posterior, for B members at once (``vlgp_tpu/model_selection.py:150-155``
    per held-out channel).  ``data`` holds the S segments the members share;
    ``cmask`` (B, Y) their channel weights.  Returns mu and v latent-major
    (Z, B*S, T), member-major, and each member's sweep count (B,)."""
    B = cmask.shape[0]
    S, T = data.mask.shape
    maskz = data.mask.repeat(B, 1)[None]
    zeros = data.y.new_zeros((params.zdim, B * S, T))
    wz = _member_weights(zeros, zeros, params.a, _xb(data.x, params.b), params.poisson,
                         params.noise, cmask[:, None, None, :], maskz)
    vz = zeros
    if config.method == "VB":
        vz = _marginal_variance(G, wz, iters=config.ns_iters) * maskz
    (muz, _, vz, _), sweeps = estep_members(data, params, G, config, cmask,
                                            (zeros, wz, vz, zeros), niter=niter)
    return muz, vz, sweeps


def _masked_var(resid, mask, dist: Dist):
    """Per-channel variance of masked residuals (M-step noise MLE,
    core.py:177)."""
    m = mask[..., None]
    n, s1, s2 = _psum((torch.sum(mask), torch.sum(resid * m, dim=(0, 1)),
                       torch.sum(resid * resid * m, dim=(0, 1))), dist, "data")
    mean = s1 / n
    return s2 / n - mean * mean


def mstep(data: TrialSet, params: Params, config: Config,
          niter: Optional[int] = None, dist: Dist = Dist()) -> Params:
    """M-step: Newton (or plain gradient) for Poisson channels, closed form
    for Gaussian (core.py:129-249).  ``config.mstep_tol > 0`` stops once
    |da| <= tol |a| and |db| <= tol |b| after at least 2 iterations.

    A Poisson iteration is ``ops.mstep``'s two calls: ``mstep_stats`` (one
    pass over the data for the step's statistics) and ``mstep_update`` (the
    per-channel Newton solve); on one CUDA device two kernel launches, the
    partial sums going from the first to the second unreduced.  Under
    ``dist.data`` the statistics are summed over the ranks between the two
    (one all_reduce per Newton iteration, and one of the mask's count per
    M-step), so a, b, da and db come out bitwise equal on every rank of a
    model column.  Every update is per channel, so ``dist.model`` adds
    nothing to an iteration; the exit test's four squared norms (from
    ``mstep_update`` on a pure Poisson fit: on the card its kernel sums
    them, so the test launches only its compare) are summed over the model
    group (``vlgp_tpu/models/vlgp.py:483-490``), so every model rank takes
    the same trip count.  ``params.active`` pins the channels it
    marks False (the padding of ``parallel.mesh.pad_channels``) to their
    state."""
    niter = config.Mniter if niter is None else niter
    if niter < 1:
        return params

    y, x, mask = data.y, data.x, data.mask
    muz = _zmajor(data.mu)
    m = mask[..., None]
    maskz = mask[None]
    mum = muz * maskz
    eps = config.eps
    xdim = params.xdim
    Ix = torch.eye(xdim, dtype=y.dtype, device=y.device)
    pois = params.poisson
    kind = params.likelihood_kind
    need_pois = kind != "gaussian"
    need_gauss = kind != "poisson"
    # one CUDA device: mstep_update reduces mstep_stats' partial sums itself
    partial = y.is_cuda and dist.data is None
    n = _psum(torch.sum(mask), dist, "data")
    # a pure Poisson fit pins its inert channels inside mstep_update
    active_pois = params.active if not need_gauss else None

    if need_gauss:
        # data-independent Gaussian normal equations (core.py:224-226)
        xm = x * m[..., None]
        Mg, vsum, xtx = _psum((torch.einsum("zst,kst->zk", mum, muz),
                               torch.sum(_zmajor(data.v) * maskz, dim=(1, 2)),
                               torch.einsum("stxn,stqn->nxq", xm, x)), dist, "data")
        Mg = Mg + torch.diag(vsum)

    mtol = config.mstep_tol

    def iteration(a, b, noise_prev, norms):
        if need_pois:
            # ---- Poisson loading and regression update (core.py:182-218) ----
            stats = mstep_stats(y, x, mask, data.mu, data.v, a, b, config.use_hessian,
                                partial=partial)
            if not partial:
                stats = _psum(stats, dist, "data")
            a_pois, b_pois, noise, delta_a, delta_b, norms_pois = mstep_update(
                stats, n, a, b, noise_prev, active_pois, use_hessian=config.use_hessian,
                eps=eps, learning_rate=config.learning_rate, da_bound=config.da_bound,
                db_bound=config.db_bound)
            if not need_gauss:
                return a_pois, b_pois, noise, delta_a, delta_b, norms_pois
        else:
            noise = _masked_var(y - _eta(muz, a, _xb(x, b)), mask, dist)

        # ---- Gaussian closed form (core.py:221-235) ----
        rhs_a = _psum(torch.einsum("zst,sty->zy", mum, y - _xb(x, b)), dist, "data")
        a_gauss = _solve(Mg, rhs_a)
        resid = y * m - _eta(mum, a_gauss, torch.zeros_like(y))
        rhs_b = _psum(torch.einsum("stxy,sty->yx", x, resid), dist, "data")
        b_gauss = _solve(xtx + eps * Ix, rhs_b[..., None])[..., 0].T
        # zero the history-filter rows, keep the bias (core.py:235)
        b_gauss = b_gauss * (torch.arange(xdim, device=b.device) == 0)[:, None].to(b.dtype)

        if not need_pois:
            a_new, b_new = a_gauss, b_gauss
            da, db = a_new - a, b_new - b
        else:
            a_new = torch.where(pois, a_pois, a_gauss)
            b_new = torch.where(pois, b_pois, b_gauss)
            da = torch.where(pois, delta_a, a_new - a)
            db = torch.where(pois, delta_b, b_new - b)
        if params.active is not None:
            # inert channels stay pinned to their carried state
            act = params.active
            a_new = torch.where(act, a_new, a)
            b_new = torch.where(act, b_new, b)
            noise = torch.where(act, noise, noise_prev)
            da = torch.where(act, da, torch.zeros_like(da))
            db = torch.where(act, db, torch.zeros_like(db))
        if mtol > 0:
            norms = squared_norms(da, a_new, db, b_new)
        return a_new, b_new, noise, da, db, norms

    def keep_going(i, carry):
        if not (mtol > 0 and i >= 2):
            return None
        # this device's squared norms (the update kernel's own on a pure
        # Poisson fit), summed over the model group's channels
        return moving(_psum(carry[5], dist, "model"), mtol)

    a, b, noise, da, db, _ = control.bounded_while(
        niter, keep_going, lambda c: iteration(c[0], c[1], c[2], c[5]),
        (params.a, params.b, params.noise, params.da, params.db, params.a.new_zeros(4)),
        name="mstep_iters")
    return params.replace(a=a, b=b, noise=noise, da=da, db=db)


def constrain_loading(data: TrialSet, params: Params, config: Config,
                      dist: Dist = Dist()) -> Tuple[TrialSet, Params]:
    """Normalize the loading, compensating the latents (core.py:392-416);
    the loading is replicated over the data axis, and its norms are summed
    over the model axis's channels.  ``"svd"`` takes ``vh`` from
    ``ops.linalg.svd_loading`` (the kernel on CUDA, eagerly and under a
    capture; its rows' signs follow that module's convention, not LAPACK's)
    and raises under a model axis, as in ``vlgp_tpu``
    (``models/vlgp.py:510-511``)."""
    c = config.constrain_loading
    if not c or c == "none":
        return data, params
    a = params.a
    if c == "svd":
        if dist.model is not None:
            raise NotImplementedError("svd loading constraint under model sharding")
        vh = svd_loading(a)
        us = a @ vh.T
        mu = torch.einsum("stz,zk->stk", data.mu, us)
        return data.replace(mu=mu), params.replace(a=vh)
    if c == "fro":
        s = torch.sqrt(_psum(torch.sum(a * a), dist, "model")) + config.eps
        return data.replace(mu=data.mu * s), params.replace(a=a / s)
    # row-wise vector norm with ord=c (core.py:413)
    ord_ = float(c) if not isinstance(c, (int, float)) else c
    if ord_ == 2:
        s = torch.sqrt(_psum(torch.sum(a * a, dim=1), dist, "model")) + config.eps
    elif ord_ == 1:
        s = _psum(torch.sum(torch.abs(a), dim=1), dist, "model") + config.eps
    else:
        raise ValueError(f"unsupported loading constraint {c!r}")
    return data.replace(mu=data.mu * s[None, None, :]), params.replace(a=a / s[:, None])


def constrain_latent(data: TrialSet, params: Params, config: Config,
                     dist: Dist = Dist()) -> Tuple[TrialSet, Params]:
    """Center/scale the posterior mean, compensating (b, a)
    (core.py:366-389).  Off by default, as in the reference.  The
    compensation of b and a is per channel, so the model axis reduces
    nothing."""
    c = config.constrain_latent
    if not c or c == "none":
        return data, params
    m = data.mask[..., None]
    n, s1 = _psum((torch.sum(data.mask), torch.sum(data.mu * m, dim=(0, 1))), dist, "data")
    mean = s1 / n
    std = torch.sqrt(_psum(torch.sum((data.mu - mean) ** 2 * m, dim=(0, 1)), dist, "data") / n)
    mu, a, b = data.mu, params.a, params.b
    if c in ("location", "both"):
        mu = (mu - mean) * m
        b = b.clone()
        b[0, :] += mean @ a
    if c in ("scale", "both"):
        mu = mu / std
        a = a * std[:, None]
    return data.replace(mu=mu), params.replace(a=a, b=b)


def em_norms(data: TrialSet, params: Params, dist: Dist = Dist()) -> dict:
    """Squared norms used by the convergence test (core.py:300-305,
    350-359); the posterior's are summed over the data axis, the
    parameters' over the model axis."""
    m = data.mask[..., None]

    def sq(t):
        return torch.sum(t * t)

    mu, dmu = _psum((sq(data.mu * m), sq(data.dmu * m)), dist, "data")
    a, da, b, db = _psum((sq(params.a), sq(params.da), sq(params.b), sq(params.db)),
                         dist, "model")
    return dict(mu=mu, dmu=dmu, a=a, da=da, b=b, db=db)
