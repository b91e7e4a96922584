"""hstep_search's share of its roofline in the traced fits: each call's
least work (work/hstep_search.py: Z latents times the search's evaluations
at the segments' T) over the kernels' device time.  Bound: operations."""
from metric_lib import kind, least_s, matching, share


def read(run):
    if kind(run) != "fit" or run.trace is None:
        return None
    W = run.work("hstep_search")
    s = run.config["settings"]
    seg = run.work("shapes").fit_shapes(run.config)["seg"]
    n, secs = matching(run.trace["ops"], "hstep_search")
    evals = W.evaluations(s["hyper_grid"], s["hyper_iters"])
    return share(n * least_s(run, W.least(seg["Z"], seg["T"], evals)), secs)
