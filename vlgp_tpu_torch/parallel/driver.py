"""The multi-device fit: the ``fit`` pipeline over a (data, model) mesh of
a process group (counterpart of ``vlgp_tpu/parallel/driver.py``).

Run one process per card, each calling :func:`initialize_distributed`
and then :func:`fit_sharded` with the same arguments, for example under
``torchrun --nproc-per-node N script.py``.  The segments are split over
the data axis and the channels over the model axis; the EM step and the
final inference run through ``parallel.spmd``, and every rank returns the
same :class:`FitResult`.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as tdist

from ..api import FitResult, _prepare
from ..config import Config, default_config
from ..data import TrialSet, cut_trials, scatter_segments
from ..models.driver import (NORM_KEYS, _converged, _elbo_record, _iter_converged, _track_elbo,
                             check_capturable, xinv_zeros)
from ..models.gp import effective_rank, hstep, make_cholesky
from ..models.vlgp import update_v, update_w
from .mesh import (Mesh, gather, make_mesh, pad_channels, pad_segments, replicate,
                   shard_data, trim_channels)
from .spmd import DIST, sharded_em_scan, sharded_em_step, sharded_infer

__all__ = ["fit_sharded", "initialize_distributed"]


def initialize_distributed(**kwargs) -> None:
    """``torch.distributed.init_process_group(**kwargs)`` with the ``nccl``
    backend unless ``backend`` is given.  Under ``torchrun`` the rank, the
    world size and the rendezvous come from the environment; otherwise
    pass ``init_method``, ``rank`` and ``world_size``.  With ``nccl`` and
    ``LOCAL_RANK`` set, ``cuda:<LOCAL_RANK>`` becomes the current device
    first: one card per process, as NCCL expects."""
    kwargs.setdefault("backend", "nccl")
    local = os.environ.get("LOCAL_RANK")
    if kwargs["backend"] == "nccl" and local is not None:
        torch.cuda.set_device(int(local))
    tdist.init_process_group(**kwargs)


def _head(data: TrialSet, n: int) -> TrialSet:
    """The first ``n`` rows of every field (drops the padding rows)."""
    return data.replace(**{f.name: getattr(data, f.name)[:n] for f in dataclasses.fields(data)})


def fit_sharded(
    trials: Sequence[dict],
    n_factors: int,
    mesh: Optional[Mesh] = None,
    verbose: bool = False,
    block: int = 1,
    callbacks: Sequence[Callable] = (),
    device=None,
    **kwargs,
) -> FitResult:
    """Fit vLGP with the segments split over the data axis of ``mesh`` and
    the channels over its model axis (default
    :func:`~vlgp_tpu_torch.parallel.mesh.make_mesh`: every rank of the world
    group on the data axis, or a world of one when no process group is
    initialised).  Any channel count works with any model size: the
    channels are padded with exactly inert ones (``pad_channels``) and
    trimmed from the result.

    Every rank calls it with the same arguments.  Extra keyword arguments
    go to :class:`Config` or to the parameters, as in ``fit``.  ``device``
    defaults to the mesh's: ``cuda:<LOCAL_RANK>``, else the current CUDA
    device, raising without CUDA (pass ``device="cpu"`` with a ``gloo``
    group to run on the CPU).

    As ``vlgp_tpu``'s ``fit_sharded``: rank 0's prepared parameters (and
    factor-analysis start) are broadcast; the segments are cut with the
    config's seed on every rank, padded with masked rows to a multiple of
    the data-axis size and split into contiguous blocks; callbacks and ELBO
    tracking see the gathered real segments and channels, and the params
    with the padded channels trimmed, at every iteration boundary;
    with ``hyper_interval > 1`` a closing H-step runs on the gathered
    segments without the inverse carry (``fit`` passes it, so the two
    agree bit for bit through the EM loop, not after it); the final
    full-length inference is split over trials.  ``path=`` snapshots as
    in ``fit``, from rank 0 only.

    ``block=k`` (k > 1) runs k EM iterations per call of
    :func:`~vlgp_tpu_torch.parallel.spmd.sharded_em_scan`, with one host
    read of their stacked norms per block; the boundary work runs per
    block, and ``runtime["converged_at"]`` records the first converged
    iteration while ``runtime["it"]`` counts the whole block
    (``vlgp_tpu/parallel/driver.py:173-206``).  On the card, with an
    ``nccl`` group, the k steps are replays of a captured CUDA graph; a
    ``gloo`` group with CUDA tensors raises a ValueError naming nccl.
    """
    config_keys = {f.name for f in dataclasses.fields(Config)}
    config = default_config(**{k: v for k, v in kwargs.items() if k in config_keys})
    prep_kwargs = {k: v for k, v in kwargs.items() if k not in config_keys}
    if mesh is None:
        mesh = make_mesh(device=device)
    elif device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    if block > 1:
        check_capturable(config, mesh.dist(DIST), mesh.device)
    callbacks = list(callbacks)
    # whether the boundaries gather is decided from arguments that every
    # rank shares (the Saver lives on rank 0 only): a gather is a collective
    boundary_work = bool(callbacks) or _track_elbo(config) or config.path is not None
    saver = None
    if config.path is not None and mesh.rank == 0:
        from ..callback import Saver

        saver = Saver(config.path, config.saving_interval)
        callbacks.append(saver)

    data, params, fm = _prepare(trials, n_factors, config, mesh.device, **prep_kwargs)
    # rank 0's start on every rank: factor analysis draws on the device
    params, mu, fm = replicate((params, data.mu, fm), mesh)
    data = data.replace(mu=mu)
    initial_params = params
    n_data, n_model = mesh.shape
    ydim = data.ydim
    data, params = pad_channels(data, params, n_model)

    # prior factors and initial posterior weights on the full trials
    G_full = make_cholesky(data.nbin, params)
    data = update_w(data, params, config)
    data = update_v(data, params, G_full, config)

    segments = cut_trials(data, config.window, seed=config.seed)
    n_real = segments.ntrial
    seg_full = pad_segments(segments, n_data)
    seg = shard_data(seg_full, mesh)
    params_s = shard_data(params, mesh)  # this rank's channels
    omega_hi = max(float(params.omega.max()), config.omega_bound[1])
    seg_rank = min(params.rank, effective_rank(segments.nbin, omega_hi, params.dt))
    G_seg = make_cholesky(segments.nbin, params, rank=seg_rank)

    runtime = {"it": 0, "em_elapsed": []}

    def boundary(seg, params_s, G_seg):
        """Iteration-boundary work on the gathered real segments and
        channels, with the padded channels trimmed from the params
        (``vlgp_tpu/parallel/driver.py:120-133``): ELBO tracking, then the
        callbacks (RuntimeError swallowed, core.py:341-345)."""
        if not boundary_work:
            return
        real, params = trim_channels(_head(gather(seg, mesh, static=seg_full), n_real),
                                     gather(params_s, mesh), ydim)
        if _track_elbo(config):
            _elbo_record(runtime, real, params, G_seg)
        for cb in callbacks:
            try:
                cb(real, params, config)
            except RuntimeError:
                pass

    xinv = xinv_zeros(seg, G_seg)
    if block > 1:
        run = sharded_em_scan(mesh, config, seg, params_s, block)
        done = False
        while runtime["it"] < config.max_iter and not done:
            k = min(block, config.max_iter - runtime["it"])
            step = run if k == block else sharded_em_scan(mesh, config, seg, params_s, k)
            tic = time.perf_counter()
            seg, params_s, G_seg, xinv, norms_k = step(seg, params_s, G_seg, xinv,
                                                       runtime["it"])
            # one host read per block: the stacked norms
            rows = torch.stack([norms_k[key] for key in NORM_KEYS], 1).tolist()
            elapsed = time.perf_counter() - tic
            for row in rows:
                runtime["it"] += 1
                runtime["em_elapsed"].append(elapsed / k)
                if (config.convergence == "norms" and _converged(dict(zip(NORM_KEYS, row)),
                                                                  config.tol)
                        and runtime["it"] >= config.min_iter and not done):
                    runtime["converged_at"] = runtime["it"]
                    done = True
            boundary(seg, params_s, G_seg)
            if (config.convergence == "elbo" and not done and runtime["it"] >= config.min_iter
                    and _iter_converged(runtime, {}, config)):
                runtime["converged_at"] = runtime["it"]
                done = True
            if verbose and mesh.rank == 0:
                print(f"Iteration {runtime['it']}, EM {elapsed / k:.2f}s/it (block {k})")
    else:
        step = sharded_em_step(mesh, config, seg, params_s)
        for it in range(config.max_iter):
            runtime["it"] += 1
            tic = time.perf_counter()
            seg, params_s, G_seg, norms, xinv = step(seg, params_s, G_seg, xinv, it)
            norms = {k: float(v) for k, v in norms.items()}
            runtime["em_elapsed"].append(time.perf_counter() - tic)
            if verbose and mesh.rank == 0:
                print(f"Iteration {it + 1}, EM {runtime['em_elapsed'][-1]:.2f}s")
            boundary(seg, params_s, G_seg)
            if _iter_converged(runtime, norms, config) and it + 1 >= config.min_iter:
                runtime["converged_at"] = runtime["it"]
                break

    seg_all = gather(seg, mesh, static=seg_full)
    interval = int(config.hyper_interval)
    if (config.Hstep and interval > 1 and runtime["it"] > 0
            and (runtime["it"] - 1) % interval != 0):
        # closing H-step (vlgp_tpu/parallel/driver.py:226-241): the loop
        # ended on an iteration whose H-step was skipped.  Every rank runs
        # it on the gathered segments (padded rows are mask-inert), without
        # the per-rank inverse carry, and gets the same omega and sigma.
        params_s = hstep(seg_all, params_s, config, rank=G_seg.shape[-1])
        runtime["final_hstep"] = True

    # the trained posterior back into the full trials, refreshed factors,
    # and the final full-length inference split over trials and channels
    params = gather(params_s, mesh)
    data = scatter_segments(data, _head(seg_all, n_real))
    G_full = make_cholesky(data.nbin, params)
    data = update_w(data, params, config)
    data = update_v(data, params, G_full, config)
    data_full = pad_segments(data, n_data)
    data_s = shard_data(data_full, mesh)
    data_s = sharded_infer(mesh, config, data_s, params_s)(data_s, params_s, G_full)
    data = _head(gather(data_s, mesh, static=data_full), data.ntrial)
    data, params = trim_channels(data, params, ydim)

    if saver is not None:  # final snapshot regardless of the interval
        saver.save(data, params, config, force=True)

    return FitResult(
        data=data,
        params=params,
        config=config,
        factor_model=fm,
        G=G_full,
        runtime=runtime,
        initial_params=initial_params,
        _trials_in=trials,
    )
