"""The EM step and the inference E-step over a (data, model) mesh
(counterpart of ``vlgp_tpu/parallel/spmd.py``).

``vlgp_tpu`` wraps its single-device phases in ``shard_map``.  Here each
rank runs the same phases on its own block, with ``dist.data`` bound to its
data group and ``dist.model`` to its model group: cross-segment reductions
(the M-step's and the H-step's sufficient statistics, the posterior's
convergence norms) become ``all_reduce``s over the data group, and
cross-channel contractions (the E-step's ``residual @ a`` and weight
refresh, the loading's norms) ``all_reduce``s over the model group.  Every
rank ends the step with the same posterior as the other ranks of its data
row and the same parameters as the other ranks of its model column.
"""
from __future__ import annotations

from typing import Callable, Optional

from ..config import Config, Params
from ..data import TrialSet
from ..models.driver import make_em_step, make_steps
from ..models.vlgp import Dist, estep
from .mesh import Mesh

__all__ = ["sharded_em_step", "sharded_em_scan", "sharded_infer", "DIST"]

# the axes the step shards, by name; ``Mesh.dist`` binds them to a group
DIST = Dist(data="data", model="model")


def sharded_em_step(mesh: Mesh, config: Config, data: TrialSet, params: Params) -> Callable:
    """The EM step over ``mesh``, for this rank's block of the data and of
    the params (:func:`~vlgp_tpu_torch.parallel.mesh.shard_data` of each;
    on a mesh of model size 1 the params are whole).  ``data`` and
    ``params`` are ``vlgp_tpu``'s signature, where they fix the compiled
    shapes; the port builds nothing from them.

    Returns (data, params, G, xinv, it) -> (data, params, G, norms, xinv):
    ``xinv`` is this rank's (Z, S_local, R, R) Woodbury carry
    (``models.driver.xinv_zeros`` of the sharded data to start) and ``it``
    the 0-based EM iteration, which applies the ``hyper_interval`` cadence
    (unused at ``hyper_interval=1``; the signature stays fixed).  ``norms``
    are summed over the ranks (the posterior's over the data axis, the
    params' over the model axis), so every rank takes the same convergence
    decision.  (:func:`sharded_em_scan` returns ``norms`` after ``xinv``,
    as ``vlgp_tpu``'s does.)
    """
    em = make_em_step(config, mesh.dist(DIST), carry_xinv=True)
    with_it = config.hyper_interval > 1

    def step(data, params, G, xinv, it):
        return em(data, params, G, xinv, it=it if with_it else None)

    return step


def sharded_em_scan(mesh: Mesh, config: Config, data: TrialSet, params: Params,
                    k: int) -> Callable:
    """k EM steps over ``mesh`` per call, with one set of norms per step
    (``vlgp_tpu/parallel/spmd.py:105-154``; ``data`` and ``params`` are its
    signature, as in :func:`sharded_em_step`).

    Returns (data, params, G, xinv, it0) -> (data, params, G, xinv, norms):
    ``it0`` is the 0-based iteration of the first step (the
    ``hyper_interval`` cadence), and ``norms`` maps each key to a (k,)
    tensor of the steps' norms, summed over the ranks as in the step.  The
    output order is ``vlgp_tpu``'s, which puts ``norms`` last, unlike
    :func:`sharded_em_step`.  On the CPU the steps run eagerly.  On CUDA
    tensors with ``nccl`` groups they are replays of the step captured as
    CUDA graphs (``models.driver.make_steps``), enqueued with no host read
    between them; the returned tensors are copies.  A ``gloo`` group with
    CUDA tensors raises a ValueError: gloo's CUDA collectives synchronize
    with the host, which a capture refuses.
    """
    dist = mesh.dist(DIST)

    def scan(data, params, G, xinv, it0):
        steps = make_steps(config, dist, data, params, G, xinv, k)
        steps.run(int(it0), k)
        data, params, G, xinv = steps.state()
        return data, params, G, xinv, steps.norm_tensors()

    return scan


def sharded_infer(mesh: Mesh, config: Config, data: TrialSet, params: Params,
                  niter: Optional[int] = None) -> Callable:
    """The inference-only E-step (core.py:260-266) over ``mesh``: (data,
    params, G) -> data for this rank's blocks, ``niter`` sweeps (default
    ``config.max_iter``), the adaptive exit decided on norms summed over
    the data axis."""
    n = config.max_iter if niter is None else niter
    dist = mesh.dist(DIST)

    def infer(d, p, g):
        return estep(d, p, g, config, niter=n, dist=dist)

    return infer
