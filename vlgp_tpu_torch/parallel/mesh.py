"""Process-group mesh and the sharding contract (counterpart of
``vlgp_tpu/parallel/mesh.py``).

``vlgp_tpu`` shards over a 2-D ``jax.sharding.Mesh`` of devices: ``data``
(segments/trials) and ``model`` (channels).  The port runs one process per
card in a ``torch.distributed`` process group and lays the ranks out as
that mesh does: rank ``r`` of a (d, m) mesh sits at (r // m, r % m).  Each
rank holds a contiguous block of the segment rows and a contiguous block
of the channels; cross-segment sums are ``all_reduce``s over its data
group (the ranks of its model column) and cross-channel sums over its
model group (the ranks of its data row) (``models/vlgp.py:_psum``).

The model axis is one for memory capacity, as in ``vlgp_tpu``: it splits
the channel-indexed tensors (y, x, a, b and the M-step's statistics), but
the E-step's weights are summed over the model group, so every model rank
runs the E-step's kernels on its whole data block.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch
import torch.distributed as tdist

from ..config import Params, _resolve_device
from ..data import TrialSet
from ..models.vlgp import COLLECTIVES, Dist, _count

__all__ = [
    "Mesh",
    "make_mesh",
    "data_specs",
    "params_specs",
    "shard_data",
    "replicate",
    "gather",
    "pad_segments",
    "pad_channels",
    "trim_channels",
]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of one process group seen from this rank, as a (data,
    model) mesh: ``group`` (None when no process group is initialised: a
    world of one), this ``rank``, the ``world`` size, this rank's
    ``device``, the ``model`` axis size, and the process groups of this
    rank's two axes: ``data_group``, the ranks of its model column (the
    whole group when ``model`` is 1), and ``model_group``, the ranks of its
    data row.  An axis of one rank has no group (None), except the data
    axis of a one-dimensional mesh, which keeps the mesh's group."""

    group: Optional[object]
    rank: int
    world: int
    device: torch.device
    model: int = 1
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.world // self.model, self.model)

    @property
    def coords(self) -> Tuple[int, int]:
        """This rank's (data, model) coordinates."""
        return divmod(self.rank, self.model)

    def dist(self, axes: Dist) -> Dist:
        """``axes`` (a :class:`Dist` of axis names) with each named axis
        bound to this rank's process group of that axis."""
        return Dist(data=self.data_group if axes.data is not None else None,
                    model=self.model_group if axes.model is not None else None)


def default_device() -> torch.device:
    """``cuda:<LOCAL_RANK>`` (as ``torchrun`` sets it), else the current CUDA
    device; raises when CUDA is missing."""
    _resolve_device(None, "fit_sharded")
    local = os.environ.get("LOCAL_RANK")
    if local is not None:
        return torch.device("cuda", int(local))
    return torch.device("cuda", torch.cuda.current_device())


def make_mesh(shape: Optional[Tuple[int, int]] = None, group=None, device=None,
              timeout=None) -> Mesh:
    """A ("data", "model") mesh over the ranks of ``group`` (default: the
    world group when ``torch.distributed`` is initialised, else a world of
    one with no group).  ``shape`` defaults to every rank on the data axis;
    d * m must equal the group's size.  ``device`` defaults to
    :func:`default_device`.

    A model size above 1 needs ``group`` to span the world group: the axes'
    subgroups are made with ``torch.distributed.new_subgroups_by_enumeration``,
    which every process calls with the same arguments (data groups first,
    then model groups), each with ``timeout`` (torch's default when None)."""
    if group is None and tdist.is_available() and tdist.is_initialized():
        group = tdist.group.WORLD
    if group is None:
        rank, world = 0, 1
    else:
        rank, world = tdist.get_rank(group), tdist.get_world_size(group)
    d, m = (world, 1) if shape is None else (int(shape[0]), int(shape[1]))
    if d < 1 or m < 1 or d * m != world:
        raise ValueError(f"mesh shape {(d, m)} != {world} ranks")
    device = default_device() if device is None else torch.device(device)
    if m == 1:
        return Mesh(group=group, rank=rank, world=world, device=device, data_group=group)
    if world != tdist.get_world_size():
        raise ValueError("a model axis is made over the world group: every process "
                         "makes the subgroups of both axes")
    # rank r at (r // m, r % m), as np.reshape(devices, shape) places them
    data_group = None
    if d > 1:
        data_group, _ = tdist.new_subgroups_by_enumeration(
            [[i * m + j for i in range(d)] for j in range(m)], timeout=timeout)
    model_group, _ = tdist.new_subgroups_by_enumeration(
        [[i * m + j for j in range(m)] for i in range(d)], timeout=timeout)
    return Mesh(group=group, rank=rank, world=world, device=device, model=m,
                data_group=data_group, model_group=model_group)


# The one statement of the sharding contract (``vlgp_tpu/parallel/mesh.py:
# 56-95``): the mesh axis each dimension of a field is split over, or None.
# Segment rows go over "data", channels over "model"; the latent-indexed
# fields are replicated.
TRIALSET_SPEC_FIELDS = dict(
    y=("data", None, "model"),
    x=("data", None, None, "model"),
    mask=("data", None),
    mu=("data", None, None),
    w=("data", None, None),
    v=("data", None, None),
    dmu=("data", None, None),
    trial_idx=("data",),
    start=("data",),
    lengths=("data",),
)
PARAMS_SPEC_FIELDS = dict(
    a=(None, "model"),
    b=(None, "model"),
    noise=("model",),
    sigma=(),
    omega=(),
    poisson=("model",),
    da=(None, "model"),
    db=(None, "model"),
)


def data_specs(data: TrialSet) -> dict:
    """Field -> spec (the axis of each dimension) for a TrialSet: rows over
    "data", channels over "model"."""
    return dict(TRIALSET_SPEC_FIELDS)


def params_specs(params: Params) -> dict:
    """Field -> spec for Params: channel-indexed fields over "model",
    latent-indexed fields replicated."""
    specs = dict(PARAMS_SPEC_FIELDS)
    if params.active is not None:
        specs["active"] = ("model",)
    return specs


def _specs(tree) -> dict:
    return params_specs(tree) if isinstance(tree, Params) else data_specs(tree)


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


def _padlast(t: torch.Tensor, pad: int, value=0) -> torch.Tensor:
    return torch.cat([t, t.new_full(tuple(t.shape[:-1]) + (pad,), value)], dim=-1)


def pad_channels(data: TrialSet, params: Params, multiple: int) -> Tuple[TrialSet, Params]:
    """Pad the channel axis to a multiple of the model-axis size
    (``vlgp_tpu/parallel/mesh.py:139-192``).

    Padded channels are exactly inert: their y and x are zero and their a,
    b, da and db are zero, so they add nothing to ``residual @ a`` or to the
    weights, and ``params.active`` marks them so the M-step pins them (noise
    stays 1).  They take the model's majority family (Poisson unless the
    model is all Gaussian), and ``likelihood_kind`` is kept, not recomputed:
    an all-Poisson model stays "poisson"."""
    y = data.ydim
    pad = -(-y // multiple) * multiple - y
    if pad == 0:
        return data, params
    data = data.replace(y=_padlast(data.y, pad), x=_padlast(data.x, pad))
    params = params.replace(
        a=_padlast(params.a, pad),
        b=_padlast(params.b, pad),
        da=_padlast(params.da, pad),
        db=_padlast(params.db, pad),
        noise=_padlast(params.noise, pad, 1),
        poisson=_padlast(params.poisson, pad, params.likelihood_kind != "gaussian"),
        active=torch.arange(y + pad, device=params.a.device) < y,
    )
    return data, params


def trim_channels(data: TrialSet, params: Params, ydim: int) -> Tuple[TrialSet, Params]:
    """Undo :func:`pad_channels`: the first ``ydim`` channels, no ``active``."""
    if data.ydim == ydim:
        return data, params
    params = params.replace(**{f: getattr(params, f)[..., :ydim]
                               for f, spec in PARAMS_SPEC_FIELDS.items() if "model" in spec},
                            active=None)
    return data.replace(y=data.y[..., :ydim], x=data.x[..., :ydim]), params


def _block(n: int, size: int, index: int, what: str) -> slice:
    if n % size:
        raise ValueError(f"{n} {what} do not split over {size} ranks: pad them first")
    per = n // size
    return slice(index * per, (index + 1) * per)


def shard_data(tree, mesh: Mesh):
    """This rank's block of a TrialSet (its rows over "data" and channels
    over "model") or of Params (its channels), on the mesh's device (a
    copy: the full set may be dropped)."""
    d, m = mesh.shape
    i, j = mesh.coords
    out = {}
    for f, spec in _specs(tree).items():
        t = getattr(tree, f)
        index = tuple(_block(t.shape[k], d, i, "rows") if axis == "data"
                      else _block(t.shape[k], m, j, "channels") if axis == "model"
                      else slice(None) for k, axis in enumerate(spec))
        out[f] = t[index].to(mesh.device, copy=True)
    return tree.replace(**out)


def _broadcast(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    # bool goes as uint8, which every backend carries
    out = (t.to(torch.uint8) if t.dtype == torch.bool else t).contiguous().clone()
    tdist.broadcast(out, src=tdist.get_global_rank(mesh.group, 0), group=mesh.group)
    COLLECTIVES["broadcast"] += 1  # over the whole mesh, at set-up: no axis's bytes
    return out.to(torch.bool) if t.dtype == torch.bool else out


def replicate(tree, mesh: Mesh):
    """Rank 0's value of ``tree`` on every rank of the mesh: a tensor, or a
    dataclass (Params, TrialSet, FactorModel), or a tuple of those,
    broadcast field by field; other leaves are kept.  The identity for a
    world of one."""
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


def _all_gather(parts, group, axis: str, dim: int):
    """Concatenate each rank's ``parts`` (tensors of one dtype) along ``dim``
    in the order of ``group``'s ranks, on every rank: one all_gather of one
    flat buffer (bool goes as uint8)."""
    flat = torch.cat([t.reshape(-1) for t in parts])
    if flat.dtype == torch.bool:
        flat = flat.to(torch.uint8)
    chunks = [torch.empty_like(flat) for _ in range(tdist.get_world_size(group))]
    tdist.all_gather(chunks, flat, group=group)
    _count("all_gather", axis, flat)
    out, k = [], 0
    for t in parts:
        out.append(torch.cat([c[k:k + t.numel()].reshape(t.shape) for c in chunks],
                             dim=dim).to(t.dtype))
        k += t.numel()
    return out


def _gather_axis(tree, names, group, axis: str, dim: int) -> dict:
    out = {}
    # one all_gather per dtype, in the fields' order (the same on every rank)
    for dtype in dict.fromkeys(getattr(tree, f).dtype for f in names):
        same = [f for f in names if getattr(tree, f).dtype == dtype]
        out.update(zip(same, _all_gather([getattr(tree, f) for f in same], group, axis, dim)))
    return out


# the fields an EM step or an E-step writes
_POSTERIOR = ("mu", "w", "v", "dmu")


def gather(tree, mesh: Mesh, static: Optional[TrialSet] = None):
    """Every rank's block of a TrialSet or of Params, put together on every
    rank (the counterpart of ``vlgp_tpu``'s ``to_host``): rows over the data
    group in rank order, then channels over the model group.  With
    ``static``, the full (padded) TrialSet that ``tree`` was sharded from,
    only the posterior fields that the EM step writes travel (they hold no
    channel axis) and the rest are taken from ``static``.  The identity for
    a world of one."""
    specs = _specs(tree)
    if static is not None:
        names = list(_POSTERIOR)
        tree = static.replace(**{f: getattr(tree, f) for f in names})
    else:
        names = list(specs)
    out = {}
    if mesh.data_group is not None:
        rows = [f for f in names if "data" in specs[f]]
        out.update(_gather_axis(tree, rows, mesh.data_group, "data", 0))
    tree = tree.replace(**out)
    if mesh.model_group is not None:
        chans = [f for f in names if "model" in specs[f]]
        tree = tree.replace(**_gather_axis(tree, chans, mesh.model_group, "model", -1))
    return tree
