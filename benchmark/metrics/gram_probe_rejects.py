"""Probe rejects of the Gram inverse's route a fit (runtime["counts"]
["gram_probe_reject"], device counters): each costs a cold start."""
from metric_lib import kind, mean


def read(run):
    if kind(run) != "fit":
        return None
    return mean(r["counts"].get("gram_probe_reject", 0) for r in run.items)
