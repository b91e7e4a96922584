"""Profiling and tracing hooks (counterpart of ``vlgp_tpu/utils/profiling.py``).

The reference times E/M/H phases with a wall-clock ``timer`` and echoes a
``runtime`` dict (``vlgp/evaluation.py:7-11``, ``vlgp/core.py:285-339``);
``vem`` keeps that dict.  Here: a phase timer that waits for the card,
device traces through ``torch.profiler``, and named trace regions.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

__all__ = ["phase_timer", "device_trace", "annotate"]


def _cuda_devices(tree, found: set) -> set:
    """The CUDA devices of every tensor in a tensor, a sequence, a dict or a
    dataclass of those."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, found)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, found)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _cuda_devices(getattr(tree, f.name), found)
    return found


@contextlib.contextmanager
def phase_timer(log: dict, key: str, sync=None):
    """Time a phase and append the elapsed seconds to ``log[key]``.  When
    ``sync`` (tensors, or containers of them) holds CUDA tensors, the timer
    ends with ``torch.cuda.synchronize`` on their devices, so it measures
    the work and not its enqueueing."""
    tic = time.perf_counter()
    try:
        yield
    finally:
        for device in _cuda_devices(sync, set()):
            torch.cuda.synchronize(device)
        log.setdefault(key, []).append(time.perf_counter() - tic)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a ``torch.profiler`` trace (host ops, and the card's kernels
    when CUDA is available) and write it to ``logdir`` as a Chrome trace,
    viewable in TensorBoard's profiler plugin or Perfetto."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir))):
        yield


def annotate(name: str):
    """Named region that shows up in ``torch.profiler`` traces."""
    return torch.profiler.record_function(name)
