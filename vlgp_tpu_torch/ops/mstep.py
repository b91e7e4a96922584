"""One Newton iteration of the M-step's Poisson update in two kernels.

Counterpart of the Poisson branch of ``iteration`` in
``vlgp_tpu/models/vlgp.py:mstep`` (:374-497), which ``vlgp_tpu`` leaves to
XLA inside one ``lax.while_loop`` (no Pallas kernel).  Two hand-written
CUDA kernels carry it on the card (``csrc/mstep.cu``):

  * ``mstep_stats``: one pass over the data for the sufficient statistics
    of the step, the noise sums s1, s2 (Y), C1, C2 (Z, Y), grad_b (X, Y)
    and, with the Hessian, E1, E2, E3 (Y, Z, Z) and nhess_b (Y, X, X).  With
    ``partial=True`` it returns the per-chunk partial sums (:class:`Partials`)
    for ``mstep_update``'s prologue to reduce; else it reduces them too
    (a second launch) and returns the tensors in the layouts above, for the
    all-reduce of a data-sharded fit.  Both reductions run one device
    routine in one order, so the two routes give the same bits.
  * ``mstep_update``: per channel, the noise, the Newton step on the
    loading and the regression (or the gradient step), the clamps, and the
    pinning of inert channels (``active``); and the exit test's four
    squared norms over the channels (``vlgp_tpu/models/vlgp.py:483-490``),
    summed by the kernel's last block in a fixed channel order.

Each has a plain PyTorch version beside it (``_mstep_stats_plain``,
``_mstep_update_plain``): the einsum code the M-step ran before, unchanged
in what it computes.  The wrappers run the plain version only for tensors
on the CPU; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Optional

import torch

from .math import trunc_exp
from .spd import KERNEL_LAUNCHES, _ptr, _raise_on

__all__ = ["Partials", "mstep_stats", "mstep_update", "squared_norms", "moving", "Z_MAX",
           "X_MAX"]

# largest Z and X the kernels take: the update solves a Z x Z and an X x X
# system in one block's shared memory
Z_MAX = 128
X_MAX = 128


# values of storage a Partials tensor holds past its end (16 bytes or more)
_PART_TAIL = 4


class Partials(NamedTuple):
    """The per-chunk partial sums of one ``mstep_stats`` launch, (Y,
    chunks, entries), reduced by ``mstep_update``'s prologue."""

    part: torch.Tensor


def _pair_stats(rm, p, q):
    """einsum('sty,zst,kst->yzk', rm, p, q) as one (Z*K, S*T) x (S*T, Y)
    product (the three-operand einsum would build an (S,T,Y,Z) temporary)."""
    Z, K = p.shape[0], q.shape[0]
    pq = (p[:, None] * q[None]).reshape(Z * K, -1)
    out = pq @ rm.reshape(-1, rm.shape[-1])  # (Z*K, Y)
    return out.reshape(Z, K, -1).permute(2, 0, 1)


def _mstep_stats_plain(y, x, mask, mu, v, a, b, use_hessian: bool) -> List[torch.Tensor]:
    """The statistics of one Newton step (core.py:177-218): [s1, s2, C1, C2,
    grad_b] and with ``use_hessian`` [E1, E2, E3, nhess_b] after them.
    y (S, T, Y), x (S, T, X, Y), mask (S, T), mu and v (S, T, Z)."""
    muz, vz = mu.permute(2, 0, 1), v.permute(2, 0, 1)
    m = mask[..., None]
    maskz = mask[None]
    mum, vm = muz * maskz, vz * maskz
    eta = torch.einsum("zst,zy->sty", muz, a) + torch.einsum("stxy,xy->sty", x, b)
    resid = y - eta
    s1 = torch.sum(resid * m, dim=(0, 1))
    s2 = torch.sum(resid * resid * m, dim=(0, 1))
    r = trunc_exp(eta + torch.einsum("zst,zy->sty", vz, 0.5 * a * a))
    rm = r * m
    stats = [s1, s2, torch.einsum("zst,sty->zy", mum, y - r),
             torch.einsum("zst,sty->zy", vm, r),
             torch.einsum("stxy,sty->xy", x, y * m - rm)]
    if use_hessian:
        # Hessian of -loglik w.r.t. a[:, n]:
        # (mu + v a_n)' diag(r_n) (mu + v a_n) + diag(r_n' v)
        stats += [_pair_stats(rm, muz, muz), _pair_stats(rm, vz, muz),
                  _pair_stats(rm, vz, vz),
                  torch.einsum("stxy,sty,stqy->yxq", x, rm, x)]
    return stats


def _solve(A, B):
    """``torch.linalg.solve`` without the host read of its LU's info."""
    return torch.linalg.solve_ex(A, B, check_errors=False)[0]


def squared_norms(da, a, db, b):
    """The M-step exit test's (sum da^2, sum a^2, sum db^2, sum b^2), one
    (4,) tensor."""
    return torch.stack([torch.sum(da * da), torch.sum(a * a), torch.sum(db * db),
                        torch.sum(b * b)])


def moving(norms, tol: float):
    """The M-step's exit predicate on :func:`squared_norms`' (or the
    kernel's) norms: |da|^2 > tol^2 |a|^2 or |db|^2 > tol^2 |b|^2."""
    m = norms[0::2] > (tol * tol) * norms[1::2]
    return m[0] | m[1]


def _mstep_update_plain(stats, n, a, b, noise_prev, active, use_hessian: bool, eps: float,
                        learning_rate: float, da_bound: float, db_bound: float):
    """(a + da, b + db, noise, da, db, norms) from the summed statistics;
    ``active`` (Y,) bool or None pins the channels it marks False to a, b
    and ``noise_prev`` with da = db = 0; norms is :func:`squared_norms` of
    da, a + da, db and b + db."""
    s1, s2, C1, C2, grad_b, *hess = stats
    mean = s1 / n
    noise = s2 / n - mean * mean
    grad_a = C1 - a * C2
    zdim, xdim = a.shape[0], b.shape[0]
    if use_hessian:
        E1, E2, E3, nhess_b = hess
        Iz = torch.eye(zdim, dtype=a.dtype, device=a.device)
        Ix = torch.eye(xdim, dtype=a.dtype, device=a.device)
        an = a.T  # (y, z)
        nhess = (
            E1
            + an[:, :, None] * E2
            + an[:, None, :] * E2.transpose(1, 2)
            + an[:, :, None] * an[:, None, :] * E3
            + C2.T[:, :, None] * Iz
        )
        # solve_ex: the LU of solve without its host check of info
        # (a singular system gives NaN, as jnp.linalg.solve does)
        delta_a = _solve(nhess + eps * Iz, grad_a.T[..., None])[..., 0].T
        # ---- Poisson regression update (core.py:205-218) ----
        delta_b = _solve(nhess_b + eps * Ix, grad_b.T[..., None])[..., 0].T
    else:
        # gradient mode (core.py:196-197, 215-216)
        delta_a = learning_rate * grad_a
        delta_b = learning_rate * grad_b
    delta_a = torch.clamp(delta_a, -da_bound, da_bound)
    delta_b = torch.clamp(delta_b, -db_bound, db_bound)
    a_new, b_new = a + delta_a, b + delta_b
    if active is not None:
        # inert channels stay pinned to their carried state
        a_new = torch.where(active, a_new, a)
        b_new = torch.where(active, b_new, b)
        noise = torch.where(active, noise, noise_prev)
        delta_a = torch.where(active, delta_a, torch.zeros_like(delta_a))
        delta_b = torch.where(active, delta_b, torch.zeros_like(delta_b))
    return a_new, b_new, noise, delta_a, delta_b, squared_norms(delta_a, a_new, delta_b, b_new)


def _check_shapes(y, x, mask, mu, v, a, b, kernel: bool):
    if y.ndim != 3 or x.ndim != 4 or mask.ndim != 2 or mu.ndim != 3 or v.ndim != 3:
        raise ValueError("mstep_stats takes y (S, T, Y), x (S, T, X, Y), mask (S, T), "
                         "mu and v (S, T, Z)")
    S, T, Y = y.shape
    Z, X = mu.shape[2], x.shape[2]
    want = {"x": (S, T, X, Y), "mask": (S, T), "mu": (S, T, Z), "v": (S, T, Z),
            "a": (Z, Y), "b": (X, Y)}
    for name, t in zip(want, (x, mask, mu, v, a, b)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want[name]}")
    if kernel and not (1 <= Z <= Z_MAX and 1 <= X <= X_MAX):
        raise ValueError(f"mstep kernels take 1 <= Z <= {Z_MAX} and 1 <= X <= {X_MAX}, "
                         f"got Z={Z}, X={X}")
    return S * T, Y, Z, X


def _check_cuda(tensors: dict, like: torch.Tensor) -> None:
    if like.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the mstep kernels take float32 or float64, got {like.dtype}")
    for name, t in tensors.items():
        if not t.is_cuda or t.device != like.device:
            raise ValueError(f"{name} must be a CUDA tensor on {like.device}, got {t.device}")
        if t.dtype != like.dtype:
            raise TypeError(f"{name} must be {like.dtype}, got {t.dtype}")


def _plan(lib, N, Y, Z, X, hess, is_double):
    chunks, entries = ctypes.c_int(), ctypes.c_int()
    rc = lib.mstep_stats_plan(N, Y, Z, X, int(hess), is_double, ctypes.byref(chunks),
                              ctypes.byref(entries))
    _raise_on(rc, lib, "mstep_stats")
    return chunks.value, entries.value


def _stat_shapes(Y, Z, X, use_hessian):
    """Shapes of the statistics, in the order of the reduce kernel's flat
    buffer: s1, s2, C1, C2, grad_b (+ E1, E2, E3, nhess_b)."""
    shapes = [(Y,), (Y,), (Z, Y), (Z, Y), (X, Y)]
    return shapes + [(Y, Z, Z)] * 3 + [(Y, X, X)] if use_hessian else shapes


def _flat_size(Y, Z, X, use_hessian):
    return sum(math.prod(s) for s in _stat_shapes(Y, Z, X, use_hessian))


def _flat_views(flat, Y, Z, X, use_hessian):
    """The statistics as views of the reduce kernel's flat buffer."""
    out, k = [], 0
    for s in _stat_shapes(Y, Z, X, use_hessian):
        out.append(flat[k:k + math.prod(s)].view(s))
        k += math.prod(s)
    return out


def _mstep_stats_cuda(y, x, mask, mu, v, a, b, use_hessian: bool, partial: bool):
    """Launch ``mstep_stats`` (and with ``partial=False`` the reduction)."""
    from ._build import load_library

    N, Y, Z, X = _check_shapes(y, x, mask, mu, v, a, b, kernel=True)
    _check_cuda(dict(y=y, x=x, mask=mask, mu=mu, v=v, a=a, b=b), y)
    y, x, mask, mu, v, a, b = (t.contiguous() for t in (y, x, mask, mu, v, a, b))
    is_double = int(y.dtype == torch.float64)
    lib = load_library("mstep")
    chunks, entries = _plan(lib, N, Y, Z, X, use_hessian, is_double)
    # (Y, chunks, entries) and _PART_TAIL values of storage past the end:
    # mstep_update's prologue copies the 16-byte span around a channel's
    size = chunks * Y * entries
    part = torch.empty((size + _PART_TAIL,), dtype=y.dtype,
                       device=y.device)[:size].view(Y, chunks, entries)
    with torch.cuda.device(y.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(y.device).cuda_stream)
        rc = lib.mstep_stats(_ptr(y), _ptr(x), _ptr(mask), _ptr(mu), _ptr(v), _ptr(a), _ptr(b),
                             _ptr(part), N, Y, Z, X, int(use_hessian), is_double, stream)
        _raise_on(rc, lib, "mstep_stats")
        if partial:
            KERNEL_LAUNCHES["mstep_stats"] += 1
            return Partials(part)
        flat = torch.empty((_flat_size(Y, Z, X, use_hessian),), dtype=y.dtype, device=y.device)
        red = torch.empty((Y, entries), dtype=y.dtype, device=y.device)
        rc = lib.mstep_reduce(_ptr(part), chunks, _ptr(flat), _ptr(red), Y, Z, X,
                              int(use_hessian), is_double, stream)
    _raise_on(rc, lib, "mstep_reduce")
    KERNEL_LAUNCHES["mstep_stats"] += 1  # the pass and its reduction, one call
    return _flat_views(flat, Y, Z, X, use_hessian)


def mstep_stats(y, x, mask, mu, v, a, b, use_hessian: bool = True, partial: bool = False):
    """The statistics of one Newton step of the M-step at loading ``a`` (Z,
    Y) and regression ``b`` (X, Y): a list [s1, s2, C1, C2, grad_b] (+ [E1,
    E2, E3, nhess_b] with ``use_hessian``), summed over this device's
    segments; y (S, T, Y), x (S, T, X, Y), mask (S, T), mu and v (S, T, Z).
    On a CUDA tensor with ``partial`` it returns the unreduced
    :class:`Partials` for ``mstep_update``.  CPU tensors run the plain
    version."""
    if y.is_cuda:
        return _mstep_stats_cuda(y, x, mask, mu, v, a, b, use_hessian, partial)
    if y.device.type != "cpu":
        raise ValueError(f"mstep_stats runs on CUDA or the CPU, got {y.device}")
    _check_shapes(y, x, mask, mu, v, a, b, kernel=False)
    return _mstep_stats_plain(y, x, mask, mu, v, a, b, use_hessian)


# the ticket counters of mstep_update's last block.  The kernel needs its
# counter at 0 at launch and leaves it at 0, so launches that share a
# counter must not overlap: each (device, stream) has its own, and launches
# on one stream are ordered.  The counters are slots of one zeroed block per
# device, made at the device's first call (outside any capture: a capture
# would not run the fill), so that a stream's first call may be captured.
# A graph keeps the counter of the stream its launch was captured on: two
# graphs captured on one stream must not be replayed at once.
_TICKET_SLOTS = 256
_TICKETS: dict = {}


def _ticket(device: torch.device, stream: int) -> torch.Tensor:
    block, slots = _TICKETS.get(device, (None, None))
    if block is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("mstep_update's first call on a device must not be captured: "
                               "call it once eagerly first")
        block = torch.zeros(_TICKET_SLOTS, dtype=torch.int32, device=device)
        torch.cuda.synchronize(device)  # zero before any stream's launch reads it
        slots = {}
        _TICKETS[device] = (block, slots)
    slot = slots.get(stream)
    if slot is None:
        if len(slots) == _TICKET_SLOTS:
            raise RuntimeError(f"mstep_update ran on more than {_TICKET_SLOTS} streams of "
                               f"{device}")
        slot = slots[stream] = len(slots)
    return block[slot:slot + 1]


def _mstep_update_cuda(stats, n, a, b, noise_prev, active, use_hessian, eps, learning_rate,
                       da_bound, db_bound):
    """Launch ``mstep_update``: one block per channel."""
    from ._build import load_library

    Z, Y = a.shape
    X = b.shape[0]
    if not (1 <= Z <= Z_MAX and 1 <= X <= X_MAX):
        raise ValueError(f"mstep kernels take 1 <= Z <= {Z_MAX} and 1 <= X <= {X_MAX}, "
                         f"got Z={Z}, X={X}")
    _check_cuda(dict(a=a, b=b, noise_prev=noise_prev, n=n), a)
    if tuple(b.shape) != (X, Y) or tuple(noise_prev.shape) != (Y,) or n.numel() != 1:
        raise ValueError("mstep_update takes a (Z, Y), b (X, Y), noise_prev (Y,) and one n")
    if active is not None and (active.dtype != torch.bool or tuple(active.shape) != (Y,)
                               or active.device != a.device):
        raise ValueError("active must be a (Y,) bool tensor on the device of a")
    is_double = int(a.dtype == torch.float64)
    lib = load_library("mstep")
    entries = _plan(lib, 1, Y, Z, X, use_hessian, is_double)[1]
    if isinstance(stats, Partials):
        part = stats.part
        _check_cuda(dict(part=part), a)
        chunks = part.shape[1]
        if (part.ndim != 3 or part.shape[0] != Y or part.shape[2] != entries
                or not part.is_contiguous()):
            raise ValueError(f"partials of shape {tuple(part.shape)} do not fit Y={Y} and "
                             f"{entries} statistics a channel")
        end = (part.storage_offset() + part.numel() + _PART_TAIL) * part.element_size()
        if part.untyped_storage().nbytes() < end:
            raise ValueError("Partials need the storage tail that mstep_stats allocates")
        flat = None
    else:
        part, chunks = None, 0
        flat = torch.cat([t.reshape(-1) for t in stats])
        _check_cuda(dict(stats=flat), a)
        size = _flat_size(Y, Z, X, use_hessian)
        if flat.numel() != size:
            raise ValueError(f"statistics of {flat.numel()} values, expected {size}")
    a, b, noise_prev, n = (t.contiguous() for t in (a, b, noise_prev, n))
    red = torch.empty((Y, entries), dtype=a.dtype, device=a.device)
    a_new, b_new = torch.empty_like(a), torch.empty_like(b)
    da, db = torch.empty_like(a), torch.empty_like(b)
    noise = torch.empty_like(noise_prev)
    cn = torch.empty((Y, 4), dtype=a.dtype, device=a.device)
    norms = torch.empty((4,), dtype=a.dtype, device=a.device)
    active = None if active is None else active.contiguous()
    with torch.cuda.device(a.device):
        handle = torch.cuda.current_stream(a.device).cuda_stream
        counter = _ticket(a.device, handle)
        stream = ctypes.c_void_p(handle)
        rc = lib.mstep_update(_ptr(part), chunks, _ptr(flat), _ptr(red), _ptr(n), _ptr(a),
                              _ptr(b), _ptr(noise_prev), _ptr(active), _ptr(a_new), _ptr(b_new),
                              _ptr(noise), _ptr(da), _ptr(db), _ptr(cn), _ptr(norms),
                              _ptr(counter), Y, Z, X, int(use_hessian), float(eps),
                              float(learning_rate), float(da_bound), float(db_bound), is_double,
                              stream)
    _raise_on(rc, lib, "mstep_update")
    KERNEL_LAUNCHES["mstep_update"] += 1
    return a_new, b_new, noise, da, db, norms


def mstep_update(stats, n, a, b, noise_prev, active: Optional[torch.Tensor] = None, *,
                 use_hessian: bool = True, eps: float = 1e-8, learning_rate: float = 1.0,
                 da_bound: float = 5.0, db_bound: float = 5.0):
    """(a + da, b + db, noise, da, db, norms) of one Newton step (gradient
    step without ``use_hessian``) from ``mstep_stats``' output summed over
    the data ranks (or its :class:`Partials` on one CUDA device) and ``n`` =
    sum(mask) (one value).  ``active`` (Y,) bool pins the channels it marks
    False.  norms (4,) is (sum da^2, sum (a + da)^2, sum db^2, sum (b +
    db)^2) over this device's channels, the exit test's squared norms (the
    kernel sums them in another order than ``torch.sum``).  CPU tensors run
    the plain version."""
    if a.is_cuda:
        return _mstep_update_cuda(stats, n, a, b, noise_prev, active, use_hessian, eps,
                                  learning_rate, da_bound, db_bound)
    if a.device.type != "cpu":
        raise ValueError(f"mstep_update runs on CUDA or the CPU, got {a.device}")
    if isinstance(stats, Partials):
        raise ValueError("Partials come from the CUDA kernel only")
    return _mstep_update_plain(stats, n, a, b, noise_prev, active, use_hessian, eps,
                               learning_rate, da_bound, db_bound)
