"""The EM step and the inference E-step over the data axis of a mesh
(counterpart of ``vlgp_tpu/parallel/spmd.py``).

``vlgp_tpu`` wraps its single-device phases in ``shard_map``.  Here each
rank runs the same phases on its own rows with ``dist.data`` bound to the
mesh's process group: cross-segment reductions (the M-step's and the
H-step's sufficient statistics, the convergence norms) become
``all_reduce``s, and every rank ends the step with the same parameters.
"""
from __future__ import annotations

from typing import Callable, Optional

from ..config import Config, Params
from ..data import TrialSet
from ..models.driver import make_em_step
from ..models.vlgp import Dist, estep
from .mesh import Mesh

__all__ = ["sharded_em_step", "sharded_infer", "DIST"]

# the axes the step shards, by name; ``Mesh.dist`` binds them to a group
DIST = Dist(data="data")


def sharded_em_step(mesh: Mesh, config: Config, data: TrialSet, params: Params) -> Callable:
    """The EM step over ``mesh``'s data axis, for row-sharded data (see
    :func:`~vlgp_tpu_torch.parallel.mesh.shard_data`).  ``data`` and
    ``params`` are ``vlgp_tpu``'s signature, where they fix the compiled
    shapes; the port builds nothing from them.

    Returns (data, params, G, xinv, it) -> (data, params, G, norms, xinv):
    ``xinv`` is this rank's (Z, S_local, R, R) Woodbury carry
    (``models.driver.xinv_zeros`` of the sharded data to start) and ``it``
    the 0-based EM iteration, which applies the ``hyper_interval`` cadence
    (unused at ``hyper_interval=1``; the signature stays fixed).  ``norms``
    are summed over the ranks, so every rank takes the same convergence
    decision.
    """
    em = make_em_step(config, mesh.dist(DIST), carry_xinv=True)
    with_it = config.hyper_interval > 1

    def step(data, params, G, xinv, it):
        return em(data, params, G, xinv, it=it if with_it else None)

    return step


def sharded_infer(mesh: Mesh, config: Config, data: TrialSet, params: Params,
                  niter: Optional[int] = None) -> Callable:
    """The inference-only E-step (core.py:260-266) over ``mesh``'s data
    axis: (data, params, G) -> data, ``niter`` sweeps (default
    ``config.max_iter``), the adaptive exit decided on norms summed over
    the ranks."""
    n = config.max_iter if niter is None else niter
    dist = mesh.dist(DIST)

    def infer(d, p, g):
        return estep(d, p, g, config, niter=n, dist=dist)

    return infer
