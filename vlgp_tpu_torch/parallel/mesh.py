"""Process-group mesh and the sharding contract (counterpart of
``vlgp_tpu/parallel/mesh.py``).

``vlgp_tpu`` shards over a 2-D ``jax.sharding.Mesh`` of devices: ``data``
(segments/trials) and ``model`` (channels).  The port runs one process per
card in a ``torch.distributed`` process group, and ports the ``data``
axis: every rank holds a contiguous block of the segment rows and the
whole of the parameters, and cross-segment sums are ``all_reduce``s
(``models/vlgp.py:_psum``).  The ``model`` axis is ROADMAP item 16b.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch
import torch.distributed as tdist

from ..config import Params, _resolve_device
from ..data import TrialSet
from ..models.vlgp import COLLECTIVES, Dist

__all__ = [
    "Mesh",
    "make_mesh",
    "data_specs",
    "params_specs",
    "shard_data",
    "replicate",
    "gather",
    "pad_segments",
]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of one process group seen from this rank: ``group`` (None
    when no process group is initialised: a world of one), this ``rank``,
    the ``world`` size, this rank's ``device``, and ``shape`` = (world, 1)
    over the ("data", "model") axes."""

    group: Optional[object]
    rank: int
    world: int
    device: torch.device

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.world, 1)

    def dist(self, axes: Dist) -> Dist:
        """``axes`` (a :class:`Dist` of axis names) with its data axis bound
        to this mesh's process group (the mesh has no model axis)."""
        return Dist(data=self.group if axes.data is not None else None)


def default_device() -> torch.device:
    """``cuda:<LOCAL_RANK>`` (as ``torchrun`` sets it), else the current CUDA
    device; raises when CUDA is missing."""
    _resolve_device(None, "fit_sharded")
    local = os.environ.get("LOCAL_RANK")
    if local is not None:
        return torch.device("cuda", int(local))
    return torch.device("cuda", torch.cuda.current_device())


def make_mesh(shape: Optional[Tuple[int, int]] = None, group=None, device=None) -> Mesh:
    """A ("data", "model") mesh over the ranks of ``group`` (default: the
    world group when ``torch.distributed`` is initialised, else a world of
    one with no group).  ``device`` defaults to :func:`default_device`.
    Only a model size of 1 is ported (ROADMAP item 16b)."""
    if group is None and tdist.is_available() and tdist.is_initialized():
        group = tdist.group.WORLD
    if group is None:
        rank, world = 0, 1
    else:
        rank, world = tdist.get_rank(group), tdist.get_world_size(group)
    if shape is None:
        shape = (world, 1)
    if shape[1] != 1:
        raise NotImplementedError(
            "a model axis larger than 1 (channels sharded over ranks) is not "
            "ported yet: ROADMAP.md Queue 1, item 16b")
    if shape[0] != world:
        raise ValueError(f"mesh shape {tuple(shape)} != {world} ranks")
    device = default_device() if device is None else torch.device(device)
    return Mesh(group=group, rank=rank, world=world, device=device)


# The one statement of the sharding contract: the axis each field's leading
# dimension is split over ("data") or None (replicated on every rank).
# Segment rows go over "data"; every parameter is replicated (its
# channel-indexed fields would go over "model" in item 16b).
TRIALSET_SPEC_FIELDS = dict(y="data", x="data", mask="data", mu="data", w="data",
                            v="data", dmu="data", trial_idx="data", start="data",
                            lengths="data")
PARAMS_SPEC_FIELDS = dict(a=None, b=None, noise=None, sigma=None, omega=None,
                          poisson=None, da=None, db=None, active=None)


def data_specs(data: TrialSet) -> dict:
    """Field -> axis name for a TrialSet: every row-indexed field over "data"."""
    return dict(TRIALSET_SPEC_FIELDS)


def params_specs(params: Params) -> dict:
    """Field -> axis name for Params: every tensor field replicated."""
    specs = dict(PARAMS_SPEC_FIELDS)
    if params.active is None:
        specs.pop("active")
    return specs


def pad_segments(data: TrialSet, multiple: int) -> TrialSet:
    """Pad the segment axis with fully masked zero rows to a multiple of the
    data-axis size; masked rows contribute nothing to any reduction."""
    n = data.ntrial
    pad = -(-n // multiple) * multiple - n
    if pad == 0:
        return data

    def padrow(t):
        return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])

    return data.replace(**{f: padrow(getattr(data, f)) for f in data_specs(data)})


def _block(n: int, mesh: Mesh) -> slice:
    if n % mesh.world:
        raise ValueError(f"{n} rows do not split over {mesh.world} ranks: pad_segments first")
    per = n // mesh.world
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_data(data: TrialSet, mesh: Mesh) -> TrialSet:
    """This rank's contiguous block of rows of every "data" field, on the
    mesh's device (a copy: the full set may be dropped)."""
    rows = _block(data.ntrial, mesh)
    return data.replace(**{f: getattr(data, f)[rows].to(mesh.device, copy=True)
                           for f, axis in data_specs(data).items() if axis == "data"})


def _broadcast(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    # bool goes as uint8, which every backend carries
    out = (t.to(torch.uint8) if t.dtype == torch.bool else t).contiguous().clone()
    tdist.broadcast(out, src=tdist.get_global_rank(mesh.group, 0), group=mesh.group)
    COLLECTIVES["broadcast"] += 1
    return out.to(torch.bool) if t.dtype == torch.bool else out


def replicate(tree, mesh: Mesh):
    """Rank 0's value of ``tree`` on every rank: a tensor, or a dataclass
    (Params, TrialSet, FactorModel), or a tuple of those, broadcast field by
    field; other leaves are kept.  The identity for a world of one."""
    if mesh.group is None:
        return tree
    if isinstance(tree, tuple):
        return tuple(replicate(t, mesh) for t in tree)
    if isinstance(tree, torch.Tensor):
        return _broadcast(tree, mesh)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _broadcast(getattr(tree, f.name), mesh)
            for f in dataclasses.fields(tree) if isinstance(getattr(tree, f.name), torch.Tensor)})
    return tree


def _all_gather_rows(parts, mesh: Mesh):
    """Concatenate each rank's rows of every tensor in ``parts`` (one dtype)
    in rank order, on every rank: one all_gather of one flat buffer."""
    flat = torch.cat([t.reshape(-1) for t in parts])
    chunks = [torch.empty_like(flat) for _ in range(mesh.world)]
    tdist.all_gather(chunks, flat, group=mesh.group)
    COLLECTIVES["all_gather"] += 1
    out, k = [], 0
    for t in parts:
        out.append(torch.cat([c[k:k + t.numel()].reshape(t.shape) for c in chunks]))
        k += t.numel()
    return out


# the fields an EM step or an E-step writes
_POSTERIOR = ("mu", "w", "v", "dmu")


def gather(data: TrialSet, mesh: Mesh, static: Optional[TrialSet] = None) -> TrialSet:
    """Every rank's rows of the "data" fields, concatenated in rank order on
    every rank (the counterpart of ``vlgp_tpu``'s ``to_host``).  With
    ``static``, the full (padded) set that ``data`` was sharded from, only
    the posterior fields that the EM step writes travel and the rest are
    taken from ``static``.  The identity for a world of one."""
    if mesh.group is None:
        return data if static is None else static.replace(
            **{f: getattr(data, f) for f in _POSTERIOR})
    names = [f for f, axis in data_specs(data).items() if axis == "data"
             and (static is None or f in _POSTERIOR)]
    out = {}
    # one all_gather per dtype, in the fields' order (the same on every rank)
    for dtype in dict.fromkeys(getattr(data, f).dtype for f in names):
        group = [f for f in names if getattr(data, f).dtype == dtype]
        out.update(zip(group, _all_gather_rows([getattr(data, f) for f in group], mesh)))
    return (data if static is None else static).replace(**out)
