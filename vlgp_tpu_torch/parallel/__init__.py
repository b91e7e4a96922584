"""Multi-device fits over ``torch.distributed`` (counterpart of
``vlgp_tpu/parallel``): a (data, model) mesh of the ranks of a process
group, segments split over the data axis and channels over the model axis.
``fit_sharded`` and ``initialize_distributed`` live in ``parallel.driver``,
as in ``vlgp_tpu``."""
from .mesh import (
    data_specs,
    gather,
    make_mesh,
    pad_channels,
    pad_segments,
    params_specs,
    replicate,
    shard_data,
    trim_channels,
)
from .spmd import DIST, sharded_em_scan, sharded_em_step, sharded_infer

__all__ = [
    "make_mesh",
    "data_specs",
    "params_specs",
    "shard_data",
    "replicate",
    "gather",
    "pad_segments",
    "pad_channels",
    "trim_channels",
    "sharded_em_step",
    "sharded_em_scan",
    "sharded_infer",
    "DIST",
]
