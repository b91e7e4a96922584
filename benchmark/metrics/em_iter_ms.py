"""Milliseconds an EM iteration: every runtime["em_elapsed"] of the window's
fits over their iterations."""
from metric_lib import kind


def read(run):
    if kind(run) != "fit":
        return None
    iters = sum(r["iters"] for r in run.items)
    return 1e3 * sum(r["em"] for r in run.items) / iters if iters else None
