"""Mean seconds a fit spends outside its EM loop and capture (packing, the
initializer, the factors and weights on whole trials, the segments, the
write-back and the final inference): host clock around the fit less
runtime["em_elapsed"] and runtime["capture_s"]."""
from metric_lib import kind, mean


def read(run):
    if kind(run) != "fit":
        return None
    return mean(r["wall"] - r["em"] - r["capture"] for r in run.items)
