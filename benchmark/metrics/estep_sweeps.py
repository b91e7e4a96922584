"""E-step sweeps a fit, from the EM loop's device counters
(runtime["counts"]["estep_sweeps"])."""
from metric_lib import kind, mean


def read(run):
    if kind(run) != "fit":
        return None
    return mean(r["counts"].get("estep_sweeps", 0) for r in run.items)
