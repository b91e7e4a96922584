"""The E-step kernels' share of their roofline in the traced fits: the
least time of every estep_project and estep_step call (work/estep_*.py)
over their device time.  A cluster-path step is a call at the whole trials'
shape and so is one projection for each; the rest run at the segments'."""
from metric_lib import kind, least_s, matching, share


def read(run):
    if kind(run) != "fit" or run.trace is None:
        return None
    ops = run.trace["ops"]
    P, S_ = run.work("estep_project"), run.work("estep_step")
    sh = run.work("shapes").fit_shapes(run.config)
    seg, tr = sh["seg"], sh["trial"]
    n_cl, _ = matching(ops, "estep_step_cluster")
    n_step, _ = matching(ops, "estep_step")
    n_proj, _ = matching(ops, "estep_project")
    _, secs = matching(ops, "estep_project", "estep_step")
    at_seg = seg["T"] < 100
    n_cl_tr = n_cl if at_seg else n_step
    least = (n_cl_tr * (least_s(run, S_.least(tr["Z"], tr["S"], tr["T"], tr["Y"], tr["R"]))
                        + least_s(run, P.least(tr["Z"], tr["S"], tr["T"], tr["Y"])))
             + (n_step - n_cl_tr) * least_s(run, S_.least(seg["Z"], seg["S"], seg["T"],
                                                          seg["Y"], seg["R"]))
             + max(n_proj - n_cl_tr, 0) * least_s(run, P.least(seg["Z"], seg["S"], seg["T"],
                                                               seg["Y"])))
    return share(least, secs)
