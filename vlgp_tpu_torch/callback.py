"""Training callbacks (counterpart of ``vlgp_tpu/callback.py``).

Pass ``Saver(path)`` (or its ``save``) into ``fit(callbacks=[...])``, or
give ``fit`` a ``path``, which wires one in.
"""
from __future__ import annotations

import time

from .utils.io import save_params

__all__ = ["Saver", "show"]


class Saver:
    """Periodically snapshot parameters during VEM (reference
    callback.py:10-23): at most once every ``saving_interval`` seconds
    (default ``config.saving_interval``), or at once with ``force=True``."""

    def __init__(self, path, saving_interval: float | None = None):
        self.path = path
        self.saving_interval = saving_interval
        self.last_saving_time = time.perf_counter()

    def save(self, data, params, config, force: bool = False):
        now = time.perf_counter()
        interval = self.saving_interval
        if interval is None:
            interval = getattr(config, "saving_interval", 1800.0)
        if force or now - self.last_saving_time >= interval:
            save_params(params, self.path)
            self.last_saving_time = time.perf_counter()

    __call__ = save


def show(data, params, config):
    """Placeholder progress callback (callback.py:26-27)."""
