"""The general traffic generator: a traffic mix is a data file,
``traffic/<mix>.json``, that names its ``kind`` and parameters; the loop of
each kind is ``Loop`` in ``kinds/<kind>.py``, found by that name.  A kind's
items run back to back for the window (``harness.measure``)."""
from __future__ import annotations

import numpy as np
import torch

import harness


def z(t):
    """(N, T, Z) -> latents first."""
    return t.permute(2, 0, 1)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_loop(run):
    """The loop of the run's traffic: class ``Loop`` of ``kinds/<kind>.py``."""
    path = run.bench.dir / "kinds" / f"{run.traffic['kind']}.py"
    if not path.is_file():
        raise ValueError(f"unknown traffic kind {run.traffic['kind']!r}: no {path}")
    return harness.load_module(path).Loop(run)


class BaseLoop:
    """What every kind's loop shares: the run, its device and program, and
    the item whose output is checked, drawn from the seed among the first
    ``check_among``.  A kind's ``Loop`` adds ``setup()``, ``item(i)``,
    ``summary()``, ``release()``, ``failed()`` and ``check()``."""

    def __init__(self, run):
        self.run = run
        self.device = run.device
        self.V = run.program
        rng = np.random.default_rng(run.args.seed)
        self.check_index = int(rng.integers(run.traffic.get("check_among", 1)))

    def _build_s(self) -> float:
        from vlgp_tpu_torch.ops import _build
        return float(_build.BUILD_SECONDS)
