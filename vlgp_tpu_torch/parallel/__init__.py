"""Multi-device fits over ``torch.distributed`` (counterpart of
``vlgp_tpu/parallel``): the data axis, segments split over the ranks of a
process group.  ``fit_sharded`` and ``initialize_distributed`` live in
``parallel.driver``, as in ``vlgp_tpu``."""
from .mesh import (
    data_specs,
    gather,
    make_mesh,
    pad_segments,
    params_specs,
    replicate,
    shard_data,
)
from .spmd import DIST, sharded_em_step, sharded_infer

__all__ = [
    "make_mesh",
    "data_specs",
    "params_specs",
    "shard_data",
    "replicate",
    "gather",
    "pad_segments",
    "sharded_em_step",
    "sharded_infer",
    "DIST",
]
