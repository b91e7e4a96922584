"""Member rounds a leave-one-neuron-out pass (control.TRIPS["lono_rounds"]):
each is one projection, one step and one inverse for a chunk's members."""
from metric_lib import kind, mean


def read(run):
    if kind(run) != "lono":
        return None
    return mean(r["rounds"] for r in run.items)
