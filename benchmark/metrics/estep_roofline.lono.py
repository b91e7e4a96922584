"""The E-step kernels' share of their roofline in the traced passes: every
call carries a chunk's members (batch) on the whole trials
(work/estep_*.py)."""
from metric_lib import kind, least_s, matching, share


def read(run):
    if kind(run) != "lono" or run.trace is None:
        return None
    ops = run.trace["ops"]
    P, S_ = run.work("estep_project"), run.work("estep_step")
    tr = run.work("shapes").fit_shapes(run.config)["trial"]
    B = int(run.traffic["batch"])
    n_step, _ = matching(ops, "estep_step")
    n_proj, _ = matching(ops, "estep_project")
    _, secs = matching(ops, "estep_project", "estep_step")
    least = (n_step * least_s(run, S_.least(tr["Z"], tr["S"], tr["T"], tr["Y"], tr["R"], B))
             + n_proj * least_s(run, P.least(tr["Z"], tr["S"], tr["T"], tr["Y"], B)))
    return share(least, secs)
