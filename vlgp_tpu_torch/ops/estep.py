"""The E-step's per-sweep chain in two kernels.

Counterpart of the body of ``sweep`` in ``vlgp_tpu/models/vlgp.py:estep``
(:196-216), which ``vlgp_tpu`` leaves to XLA inside one
``lax.while_loop`` (no Pallas kernel).  Two hand-written CUDA kernels carry
it on the card (``csrc/estep.cu``), split at the sweep's two sums over the
channels, so that a fit whose channels are split over a model group sums s
and w over that group between and after them:

  * ``estep_project`` (stage a): the predictor eta = xb + mu a, the rates
    r = exp(min(eta + v (0.5 a a), 10)), the masked working residual (y - r
    on a Poisson channel, (y - eta) / max(noise, 1e-30) on a Gaussian one)
    and its projection s = residual a', (Z, S, T);
  * ``estep_step`` (stages b and c): the Woodbury step delta = u - G X G'(w
    u) with u = G G's - mu, clipped to ``dmu_bound`` and masked, mu +
    delta, and the weights w = (U (a a)') masked from the new mu and the
    old v (U = r on a Poisson channel, 1 / max(noise, 1e-30) on a Gaussian
    one).

Each has a plain PyTorch version beside it (``_estep_project_plain``,
``_estep_step_plain``): the torch code ``models/vlgp.estep``'s sweep ran
before, moved here unchanged.  The wrappers run the plain version only for
tensors on the CPU; a CUDA tensor launches the kernel or raises.

Both take a member axis for leave-one-neuron-out (``models/vlgp.
estep_members``): with a channel weight ``cm`` (B, Y), mu, v, w, s and X
hold B members' segments member-major (segment b S + s is member b's
segment s) while y, xb and the mask (S, T) are the members' shared base
rows; ``cm[b]`` multiplies member b's masked residual and its U.  Without
``cm`` (B = 1) the kernels run as before, with the same bits.

The launch plan lives here (``project_plan``, ``step_plan``): which of the
kernels' paths a shape takes, and for the streaming path (persistent
blocks fed through a ring of shared-memory stages, ``csrc/estep.cu``) the
rows a tile or the consumer groups, the stages, the grid and the shared
memory, from a copy of the kernels' layout; for ``estep_step`` on whole
trials (T > 64) whose G does not fit one block, the cluster path (a
thread-block cluster a base segment, each block one chunk of the sums
over t with its rows of G resident).  The kernels check the plan and lay out the same
bytes (``estep_smem``, held equal on the card).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .math import trunc_exp
from .spd import KERNEL_LAUNCHES, _ptr, _raise_on

__all__ = ["estep_project", "estep_step", "project_plan", "step_plan", "block_plans",
           "project_walk", "step_walk", "cluster_rows", "Plan", "Z_MAX", "R_MAX", "SMEM_MAX"]

# largest Z and R the kernels take (the step's latent groups keep three
# R-vectors a latent in shared memory; ns_gram takes R <= 128 too)
Z_MAX = 128
R_MAX = 128

# the kernels' constants (csrc/estep.cu): shared memory a block can have on
# an H100, its SMs, the streaming path's consumer warps a project block,
# threads a step consumer group, the mbarriers' bytes; the block path's
# rows a tile and threads; the sums over t's chunks
SMEM_MAX = 232_448
SMS = 132
_PW = 15
_GT = 256
_BAR_BYTES = 128
_RT = 32
_NT, _NT_FEW = 256, 512
_TCH, _NCH_MAX = 64, 16
_ZMAX_GROUP = 128  # the block path's latent groups fit 3 ZMAX RT values
# the cluster path: threads a block, and the largest cluster Hopper launches
# (non-portable above 8)
_CT = 384
_CLUSTER_MAX = 16
# clusters of the cluster path resident at once, read from the card once a
# (device, shape) and cached: never inside a capture
_RESIDENT: dict = {}


class Plan(NamedTuple):
    """One launch of ``estep_project`` or ``estep_step``: ``path`` "stream"
    (persistent blocks, ``units`` rows a tile or consumer groups a block,
    ``stages`` ring stages), "cluster" (``estep_step`` only: persistent
    clusters of ``units`` blocks, one chunk of the sums over t a block,
    ``stages`` ring stages) or "block" (a block per tile of 32 rows or per
    segment; ``units`` and ``stages`` 0), ``grid`` blocks of ``threads``,
    ``smem`` bytes of dynamic shared memory each."""
    path: str
    units: int
    stages: int
    grid: int
    threads: int
    smem: int


def _slot(count: int, size: int) -> int:
    """Bytes of a shared-memory slot for ``count`` values staged from any
    address (``span_slot``)."""
    return (count * size + 15) // 16 * 16 + 16


def _t_chunks(T: int) -> int:
    return min(-(-T // _TCH), _NCH_MAX)


def _project_smem(rows: int, stages: int, Y: int, Z: int, size: int, B: int = 1) -> int:
    """``ProjectLayout``: the mbarriers, the stages (y and xb rows, the mask,
    mu and v by latent and member), each consumer warp's scratch (its rows'
    mu and v by row, its sums, one member at a time)."""
    stage = 2 * _slot(rows * Y, size) + (1 + 2 * Z * B) * _slot(rows, size)
    return _BAR_BYTES + stages * stage + _PW * 3 * Z * (rows // _PW) * size


def _step_smem(groups: int, stages: int, T: int, Y: int, Z: int, R: int, size: int) -> int:
    """``StepLayout``: the mbarriers, G, the stages (X by latent, the xb
    rows, the mask, s, mu, w and v by latent), each group's scratch."""
    nch = _t_chunks(T)
    g = (Z * T * (R | 1) * size + 15) // 16 * 16  # G's rows at an odd stride
    stage = Z * _slot(R * R, size) + _slot(T * Y, size) + (1 + 4 * Z) * _slot(T, size)
    group = ((3 + (nch if nch > 1 else 0)) * Z * R + 5 * Z * T) * size
    return _BAR_BYTES + g + stages * stage + groups * group


def cluster_rows(T: int, C: int):
    """[(first row, rows)] of each block of a cluster of C blocks at T: block
    q owns chunk q of the sums over t (``t_chunks(T)`` chunks of ceil(T /
    chunks) rows, the block path's), so C is the chunk count."""
    nch = _t_chunks(T)
    if C != nch:
        raise ValueError(f"the cluster path takes a cluster of t_chunks(T) = {nch} blocks, got {C}")
    tch = -(-T // nch)
    return [(q * tch, min(T, (q + 1) * tch) - q * tch) for q in range(C)]


def _cluster_smem(C: int, stages: int, T: int, Y: int, Z: int, R: int, size: int) -> int:
    """``ClusterLayout``: the mbarriers, the block's rows of G (at most ceil(T
    / C) rows of each latent at an odd stride), the stages (its share of X's
    rows by latent, its xb rows, its mask rows, then s, mu, w and v of each
    latent on its rows), then its scratch: every block's chunk sums of A and
    of C (C Z R each), Gs, Gwu and M (Z R each), u (then delta), w u (then
    the new w) and the new mu on its rows (Z rows each), and the new mu and
    the old v by row (rows x 2 Z)."""
    rows = -(-T // C)
    xr = -(-R // C)
    g = (Z * rows * (R | 1) * size + 15) // 16 * 16
    stage = (Z * _slot(xr * R, size) + _slot(rows * Y, size) + (1 + 4 * Z) * _slot(rows, size))
    scratch = ((2 * C + 3) * Z * R + 5 * Z * rows) * size
    return _BAR_BYTES + g + stages * stage + scratch


@functools.lru_cache(maxsize=256)
def project_plan(S: int, T: int, Y: int, Z: int, dtype=torch.float32, B: int = 1) -> Plan:
    """The launch of ``estep_project`` at one shape of B members: the
    streaming path with the most rows a tile (4 a consumer warp down to 1),
    then the most stages (4 down to 2), that fit, one block an SM, a tile
    holding every member's mu and v on its base rows; else (very long rows)
    the block path.  Rows before stages: at leave-one-neuron-out's chunk
    (B25 S100 T1000 Y100 Z5) 60 rows in 2 stages take 1.127 ms, 15 rows
    in 4 stages 1.714 (chip_smoke.py 6e, graph replays, NVIDIA H100 80GB
    HBM3, 700 W); the flagship's plan (60 rows, 4 stages) is the same
    either way."""
    size = torch.empty((), dtype=dtype).element_size()
    N = S * T
    for rows in (_PW * k for k in (4, 3, 2, 1)):
        for stages in (4, 3, 2):
            smem = _project_smem(rows, stages, Y, Z, size, B)
            if smem <= SMEM_MAX:
                return Plan("stream", rows, stages, min(-(-N // rows), SMS), 32 * (_PW + 1), smem)
    return _block_project(S, T, Y, Z, size, B)


@functools.lru_cache(maxsize=256)
def step_plan(S: int, T: int, Y: int, Z: int, R: int, dtype=torch.float32, B: int = 1) -> Plan:
    """The launch of ``estep_step`` at one shape of B members: the streaming
    path (G resident) with two consumer groups and three stages, else two
    and two, else one and two, one block an SM; else, where the sums over t
    have two chunks or more (T > 64), the cluster path (a cluster of one
    block a chunk, three stages, else two; the final inference's and
    leave-one-neuron-out's T1000); else (float64 at T1000, R near 128) the
    block path.  The cluster path's grid here is one cluster a base segment
    up to SMS / C clusters; the launch takes the clusters the card holds at
    once (``_resident_clusters``)."""
    size = torch.empty((), dtype=dtype).element_size()
    for groups, stages in ((2, 3), (2, 2), (1, 2)):
        smem = _step_smem(groups, stages, T, Y, Z, R, size)
        if smem <= SMEM_MAX:
            return Plan("stream", groups, stages, min(B * S, SMS), groups * _GT + 32, smem)
    C = _t_chunks(T)
    if C >= 2:
        for stages in (3, 2):
            smem = _cluster_smem(C, stages, T, Y, Z, R, size)
            if smem <= SMEM_MAX:
                return Plan("cluster", C, stages, C * min(S, SMS // C), _CT, smem)
    return _block_step(S, T, Y, Z, R, size, B)


def _block_project(S, T, Y, Z, size, B=1) -> Plan:
    return Plan("block", 0, 0, B * -(-(S * T) // _RT), _NT, 3 * Z * _RT * size)


def _block_step(S, T, Y, Z, R, size, B=1) -> Plan:
    zg = min(3 * _ZMAX_GROUP * _RT // ((3 + _t_chunks(T)) * R), Z)
    smem = max((3 + _t_chunks(T)) * zg * R * size, 3 * Z * _RT * size)
    return Plan("block", 0, 0, B * S, _NT_FEW if B * S < 2 * SMS else _NT, smem)


def block_plans(S: int, T: int, Y: int, Z: int, R: int, dtype=torch.float32, B: int = 1):
    """The block path's plans of both kernels at one shape (the first
    design, which the other paths are held against)."""
    size = torch.empty((), dtype=dtype).element_size()
    return _block_project(S, T, Y, Z, size, B), _block_step(S, T, Y, Z, R, size, B)


def project_walk(plan: Plan, N: int, B: int = 1):
    """The (first base row, rows, member) each block of an ``estep_project``
    launch takes, in its order, as the kernel walks them: [[(first row,
    rows, member), ...], ...] a block.  Streaming: tiles b, b + grid, ... of
    ``units`` base rows, each tile for every member in turn; block path:
    block u takes member u mod B of tile u / B of 32 rows (a tile's members
    side by side)."""
    rows = plan.units if plan.path == "stream" else _RT
    tiles = -(-N // rows)
    if plan.path == "stream":
        return [[(t * rows, min(rows, N - t * rows), m) for t in range(b, tiles, plan.grid)
                 for m in range(B)] for b in range(plan.grid)]
    return [[((u // B) * rows, min(rows, N - (u // B) * rows), u % B)]
            for u in range(plan.grid)]


def step_walk(plan: Plan, S: int, B: int = 1):
    """The segments each block of an ``estep_step`` launch takes, in its
    order, with the consumer group that takes each: [[(segment, group),
    ...], ...] a block, a segment being b S + s for member b's base
    segment s.  The work units u = s B + b take a base segment's members
    side by side.  Streaming: units b + k grid, group k mod ``units``;
    cluster: the clusters (grid / units of them) walk base segments c, c +
    clusters, ..., each for every member in turn, and every block of a
    cluster takes the cluster's segments (group 0); block path: unit b."""
    def seg(u):
        return (u % B) * S + u // B

    if plan.path == "block":
        return [[(seg(b), 0)] for b in range(plan.grid)]
    if plan.path == "cluster":
        ncl = plan.grid // plan.units
        return [[(m * S + s, 0) for s in range(b // plan.units, S, ncl) for m in range(B)]
                for b in range(plan.grid)]
    return [[(seg(u), k % plan.units) for k, u in enumerate(range(b, B * S, plan.grid))]
            for b in range(plan.grid)]


def _eta(muz, a, xb):
    """Linear predictor (S, T, Y) from latent-major mu (core.py:69)."""
    return torch.einsum("zst,zy->sty", muz, a) + xb


def _rates(eta, vz, a):
    """Posterior mean of the Poisson rate exp(eta + 0.5 Var[eta]) with a
    truncated exponent (core.py:70)."""
    return trunc_exp(eta + torch.einsum("zst,zy->sty", vz, 0.5 * a * a))


def _safe_noise(noise):
    """Division-safe Gaussian noise (padded channels may carry 0)."""
    return torch.clamp(noise, min=1e-30)


def _woodbury_delta(G, s, muz, wmz, X):
    """Natural-gradient E-step update by the low-rank Woodbury identity,
    delta = u - G (I + G'WG)^{-1} G'(w u)  (core.py:85-97)."""
    Gts = torch.einsum("ztr,zst->zsr", G, s)
    u = torch.einsum("ztr,zsr->zst", G, Gts) - muz
    Gwu = torch.einsum("ztr,zst->zsr", G, wmz * u)
    M = torch.einsum("zsrq,zsq->zsr", X, Gwu)
    return u - torch.einsum("ztr,zsr->zst", G, M)


def _eta_rates_members(muz, vz, a, xb):
    """eta and the Poisson rates (B, S, T, Y) of B members whose latent-major
    mu and v are (Z, B*S, T), member-major (segment b*S + s is member b's
    segment s); xb (S, T, Y) broadcasts over the members.  The einsums and
    adds of ``_eta`` and ``_rates``."""
    shape = (-1,) + tuple(xb.shape)
    eta = torch.einsum("zst,zy->sty", muz, a).reshape(shape) + xb
    r = trunc_exp(eta + torch.einsum("zst,zy->sty", vz, 0.5 * a * a).reshape(shape))
    return eta, r


def _member_weights(muz, vz, a, xb, poisson, noise, cm, maskz):
    """The weights (Z, B*S, T) of every member under its channel weights
    ``cm`` (B, 1, 1, Y), masked by ``maskz`` (1, B*S, T)."""
    _, r = _eta_rates_members(muz, vz, a, xb)
    U = torch.where(poisson, r, 1.0 / _safe_noise(noise)) * cm
    return torch.einsum("sty,zy->zst", U.reshape(-1, *U.shape[-2:]), a * a) * maskz


def _estep_project_plain(y, xb, mask, a, muz, vz, poisson, noise, cm=None):
    """s (Z, S, T): the masked working residual projected on the loading
    (core.py:69-83), before the sum over the model group.  With ``cm`` (B,
    Y): s (Z, B*S, T) of B members, member b's residual times cm[b]."""
    if cm is not None:
        T, Y = y.shape[1:]
        eta, r = _eta_rates_members(muz, vz, a, xb)
        residual = (torch.where(poisson, y - r, (y - eta) / _safe_noise(noise))
                    * mask[..., None] * cm[:, None, None, :])
        return torch.einsum("sty,zy->zst", residual.reshape(-1, T, Y), a)
    eta = _eta(muz, a, xb)
    r = _rates(eta, vz, a)
    residual = torch.where(poisson, y - r, (y - eta) / _safe_noise(noise)) * mask[..., None]
    return torch.einsum("sty,zy->zst", residual, a)


def _estep_step_plain(G, s, muz, wz, X, mask, a, xb, vz, poisson, noise, dmu_bound: float,
                      cm=None):
    """(mu + delta, delta, w): the Woodbury step at the carried weights,
    clipped and masked (core.py:85-99), then the masked weights under the
    new mu and the old v (core.py:100-104), before the sum over the model
    group.  With ``cm`` (B, Y): B members' (Z, B*S, T), member b's U times
    cm[b]."""
    maskz = mask[None] if cm is None else mask.repeat(cm.shape[0], 1)[None]
    delta = _woodbury_delta(G, s, muz, wz * maskz, X)
    delta = torch.clamp(delta, -dmu_bound, dmu_bound) * maskz
    muz = muz + delta
    if cm is not None:
        return muz, delta, _member_weights(muz, vz, a, xb, poisson, noise,
                                           cm[:, None, None, :], maskz)
    eta = _eta(muz, a, xb)
    r = _rates(eta, vz, a)
    U = torch.where(poisson, r, 1.0 / _safe_noise(noise))
    wz = torch.einsum("sty,zy->zst", U, a * a) * maskz
    return muz, delta, wz


def _check_shapes(name, tensors: dict, want: dict) -> None:
    for key, t in tensors.items():
        if tuple(t.shape) != want[key]:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected {want[key]}")


def _members(cm, Y: int, name: str) -> int:
    """B, the member count of a channel weight ``cm`` (B, Y), or 1 without one."""
    if cm is None:
        return 1
    if cm.ndim != 2 or cm.shape[1] != Y or cm.shape[0] < 1:
        raise ValueError(f"{name}: cm has shape {tuple(cm.shape)}, expected (B, {Y})")
    return cm.shape[0]


def _project_shapes(y, xb, mask, a, muz, vz, poisson, noise, cm=None):
    if y.ndim != 3 or a.ndim != 2:
        raise ValueError("estep_project takes y and xb (S, T, Y), mask (S, T), a (Z, Y), mu and "
                         "v (Z, B S, T), poisson and noise (Y,), cm (B, Y) or None")
    S, T, Y = y.shape
    Z = a.shape[0]
    B = _members(cm, Y, "estep_project")
    _check_shapes("estep_project", dict(xb=xb, mask=mask, a=a, mu=muz, v=vz, poisson=poisson,
                                        noise=noise),
                  dict(xb=(S, T, Y), mask=(S, T), a=(Z, Y), mu=(Z, B * S, T), v=(Z, B * S, T),
                       poisson=(Y,), noise=(Y,)))
    return S, T, Y, Z, B


def _step_shapes(G, s, muz, wz, X, mask, a, xb, vz, poisson, noise, cm=None):
    if G.ndim != 3 or xb.ndim != 3:
        raise ValueError("estep_step takes G (Z, T, R), s, mu, w and v (Z, B S, T), X (Z, B S, "
                         "R, R), mask (S, T), a (Z, Y), xb (S, T, Y), poisson and noise (Y,), "
                         "cm (B, Y) or None")
    Z, T, R = G.shape
    S, Y = xb.shape[0], xb.shape[2]
    B = _members(cm, Y, "estep_step")
    zst = (Z, B * S, T)
    _check_shapes("estep_step", dict(s=s, mu=muz, w=wz, X=X, mask=mask, a=a, xb=xb, v=vz,
                                     poisson=poisson, noise=noise),
                  dict(s=zst, mu=zst, w=zst, X=(Z, B * S, R, R), mask=(S, T), a=(Z, Y),
                       xb=(S, T, Y), v=zst, poisson=(Y,), noise=(Y,)))
    return S, T, Y, Z, R, B


def _check_cuda(name, tensors: dict, like: torch.Tensor, poisson: torch.Tensor) -> None:
    if like.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the {name} kernel takes float32 or float64, got {like.dtype}")
    for key, t in dict(tensors, poisson=poisson).items():
        if t is None:
            continue
        if not t.is_cuda or t.device != like.device:
            raise ValueError(f"{key} must be a CUDA tensor on {like.device}, got {t.device}")
        if key != "poisson" and t.dtype != like.dtype:
            raise TypeError(f"{key} must be {like.dtype}, got {t.dtype}")
    if poisson.dtype != torch.bool:
        raise TypeError(f"poisson must be bool, got {poisson.dtype}")


def _check_sizes(name, S, T, Y, Z, R=1, B=1) -> None:
    if min(S, T, Y, Z, R) < 1:
        raise ValueError(f"the {name} kernel takes no empty axis, got S={S} T={T} Y={Y} Z={Z}")
    if Z > Z_MAX or R > R_MAX:
        raise ValueError(f"the {name} kernel takes Z <= {Z_MAX} and R <= {R_MAX}, got Z={Z}, "
                         f"R={R}")
    if B * S * T >= 2 ** 31:
        raise ValueError(f"the {name} kernel takes B S T < 2^31 rows, got {B * S * T}")


def _resident_clusters(plan: Plan, T, Y, Z, R, dtype, device) -> int:
    """Clusters of ``plan`` (the cluster path) the card holds at once, read
    from the card once a (device, shape) and cached; the first call at a
    shape must not be inside a capture."""
    from ._build import load_library

    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, T, Y, Z, R, dtype, plan.units, plan.stages)
    if key not in _RESIDENT:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("estep_step's first call at a shape on the cluster path must run "
                               "before a capture (its grid is read from the card)")
        with torch.cuda.device(index):
            n = load_library("estep").estep_cluster_resident(T, Y, Z, R,
                                                             int(dtype == torch.float64),
                                                             plan.units, plan.stages)
        if n < 1:
            raise RuntimeError(f"estep_step: no cluster of {plan.units} blocks fits this card at "
                               f"Z={Z} T={T} Y={Y} R={R} (estep_cluster_resident returned {n})")
        _RESIDENT[key] = n
    return _RESIDENT[key]


def _estep_project_cuda(y, xb, mask, a, muz, vz, poisson, noise, cm=None,
                        plan: Plan | None = None):
    """Launch ``estep_project`` under ``plan`` (``project_plan``'s by
    default)."""
    from ._build import load_library

    S, T, Y, Z, B = _project_shapes(y, xb, mask, a, muz, vz, poisson, noise, cm)
    _check_sizes("estep_project", S, T, Y, Z, B=B)
    _check_cuda("estep_project", dict(y=y, xb=xb, mask=mask, a=a, mu=muz, v=vz, noise=noise,
                                      cm=cm), y, poisson)
    if plan is None:
        plan = project_plan(S, T, Y, Z, y.dtype, B)
    y, xb, mask, a, muz, vz, poisson, noise = (
        t.contiguous() for t in (y, xb, mask, a, muz, vz, poisson, noise))
    cm = None if cm is None else cm.contiguous()
    s = torch.empty((Z, B * S, T), dtype=y.dtype, device=y.device)
    lib = load_library("estep")
    with torch.cuda.device(y.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(y.device).cuda_stream)
        rc = lib.estep_project(_ptr(y), _ptr(xb), _ptr(mask), _ptr(a), _ptr(muz), _ptr(vz),
                               _ptr(poisson), _ptr(noise), None if cm is None else _ptr(cm),
                               _ptr(s), S * T, Y, Z, B, int(y.dtype == torch.float64),
                               plan.units if plan.path == "stream" else 0, plan.stages,
                               plan.grid, stream)
    _raise_on(rc, lib, "estep_project")
    KERNEL_LAUNCHES["estep_project"] += 1
    return s


_PATHS = {"block": 0, "stream": 1, "cluster": 2}


def _estep_step_cuda(G, s, muz, wz, X, mask, a, xb, vz, poisson, noise, dmu_bound, cm=None,
                     plan: Plan | None = None):
    """Launch ``estep_step`` under ``plan`` (``step_plan``'s by default; on
    the cluster path, as many clusters as the card holds at once up to one
    a base segment)."""
    from ._build import load_library

    S, T, Y, Z, R, B = _step_shapes(G, s, muz, wz, X, mask, a, xb, vz, poisson, noise, cm)
    _check_sizes("estep_step", S, T, Y, Z, R, B)
    _check_cuda("estep_step", dict(G=G, s=s, mu=muz, w=wz, X=X, mask=mask, a=a, xb=xb, v=vz,
                                   noise=noise, cm=cm), G, poisson)
    if plan is None:
        plan = step_plan(S, T, Y, Z, R, G.dtype, B)
        if plan.path == "cluster":
            ncl = min(S, _resident_clusters(plan, T, Y, Z, R, G.dtype, G.device))
            plan = plan._replace(grid=plan.units * ncl)
    G, s, muz, wz, X, mask, a, xb, vz, poisson, noise = (
        t.contiguous() for t in (G, s, muz, wz, X, mask, a, xb, vz, poisson, noise))
    cm = None if cm is None else cm.contiguous()
    mu_out, dmu, w_out = (torch.empty((Z, B * S, T), dtype=G.dtype, device=G.device)
                          for _ in range(3))
    lib = load_library("estep")
    with torch.cuda.device(G.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(G.device).cuda_stream)
        rc = lib.estep_step(_ptr(G), _ptr(s), _ptr(muz), _ptr(wz), _ptr(X), _ptr(mask), _ptr(a),
                            _ptr(xb), _ptr(vz), _ptr(poisson), _ptr(noise),
                            None if cm is None else _ptr(cm), _ptr(mu_out), _ptr(dmu),
                            _ptr(w_out), S, T, Y, Z, R, B, float(dmu_bound),
                            int(G.dtype == torch.float64), _PATHS[plan.path], plan.units,
                            plan.stages, plan.grid, stream)
    _raise_on(rc, lib, "estep_step")
    KERNEL_LAUNCHES["estep_step"] += 1
    return mu_out, dmu, w_out


def estep_project(y, xb, mask, a, muz, vz, poisson, noise, cm=None):
    """s (Z, S, T) of one sweep: y and xb (S, T, Y), mask (S, T), the
    loading a (Z, Y), latent-major mu and v (Z, S, T), the channels'
    ``poisson`` flags (Y,) bool and Gaussian ``noise`` (Y,).  Summed over
    this device's channels only.  With ``cm`` (B, Y), B members on the
    shared y, xb and mask: mu, v and s (Z, B S, T), member-major, member
    b's residual times cm[b].  CPU tensors run the plain version."""
    if y.is_cuda:
        return _estep_project_cuda(y, xb, mask, a, muz, vz, poisson, noise, cm)
    if y.device.type != "cpu":
        raise ValueError(f"estep_project runs on CUDA or the CPU, got {y.device}")
    _project_shapes(y, xb, mask, a, muz, vz, poisson, noise, cm)
    return _estep_project_plain(y, xb, mask, a, muz, vz, poisson, noise, cm)


def estep_step(G, s, muz, wz, X, mask, a, xb, vz, poisson, noise, dmu_bound: float, cm=None):
    """(mu + delta, delta, w) of one sweep from the prior factors G (Z, T,
    R), the model-summed s (Z, S, T), the carried mu and weights w (Z, S, T)
    and their inverses X (Z, S, R, R), the mask, the loading, xb, the old
    v, the channel flags and noise; w is masked and summed over this
    device's channels only.  With ``cm`` (B, Y), B members as for
    ``estep_project`` (X (Z, B S, R, R)), member b's U times cm[b].  CPU
    tensors run the plain version."""
    if G.is_cuda:
        return _estep_step_cuda(G, s, muz, wz, X, mask, a, xb, vz, poisson, noise, dmu_bound, cm)
    if G.device.type != "cpu":
        raise ValueError(f"estep_step runs on CUDA or the CPU, got {G.device}")
    _step_shapes(G, s, muz, wz, X, mask, a, xb, vz, poisson, noise, cm)
    return _estep_step_plain(G, s, muz, wz, X, mask, a, xb, vz, poisson, noise, dmu_bound, cm)
