"""A leave-one-neuron-out pass's share of the card's FP32 peak: the least
FLOPs of each chunk's first variance (the inverse with v) and of each member
round (projection, step and the inverse with v) at the chunk's shape, over
the passes' host-clock seconds at 67 TFLOP/s."""
from metric_lib import kind


def read(run):
    if kind(run) != "lono" or not run.items:
        return None
    tr = run.work("shapes").fit_shapes(run.config)["trial"]
    B = int(run.traffic["batch"])
    Z, S, T, Y, R = tr["Z"], tr["S"], tr["T"], tr["Y"], tr["R"]
    inv_v = run.work("ns_gram").least(Z, B * S, T, R, want_v=True)[0]
    rnd = (run.work("estep_project").least(Z, S, T, Y, B)[0]
           + run.work("estep_step").least(Z, S, T, Y, R, B)[0] + inv_v)
    fma = sum(len(r["chunks"]) * inv_v + r["rounds"] * rnd for r in run.items)
    secs = sum(r["wall"] for r in run.items)
    return 100.0 * 2.0 * fma / (secs * run.peaks["flops_fp32"]) if secs > 0 else None
