"""The EM loop's share of the card's FP32 peak: the least FLOPs of every
fit's sweeps (projection, step and the inverse with v), each E-step's first
inverse, the M-step's Newton iterations and the H-steps' two refinements
(the inverse, the statistic and the search), all at the segments' shape,
over the fits' runtime["em_elapsed"] at 67 TFLOP/s."""
from metric_lib import kind


def read(run):
    if kind(run) != "fit" or not run.items:
        return None
    w = {k: run.work(k) for k in ("ns_gram", "estep_project", "estep_step", "mstep_stats",
                                  "hstep_stat", "hstep_search")}
    s = run.config["settings"]
    g = run.work("shapes").fit_shapes(run.config)["seg"]
    Z, S, T, Y, R = g["Z"], g["S"], g["T"], g["Y"], g["R"]
    sweep = (w["estep_project"].least(Z, S, T, Y)[0] + w["estep_step"].least(Z, S, T, Y, R)[0]
             + w["ns_gram"].least(Z, S, T, R, want_v=True)[0])
    first = w["ns_gram"].least(Z, S, T, R)[0]
    newton = w["mstep_stats"].least(Z, S * T, Y)[0]
    evals = w["hstep_search"].evaluations(s["hyper_grid"], s["hyper_iters"])
    refine = (w["ns_gram"].least(Z, S, T, R)[0] + w["hstep_stat"].least(Z, S, T, R)[0]
              + w["hstep_search"].least(Z, T, evals)[0])
    fma, secs = 0, 0.0
    for r in run.items:
        c = r["counts"]
        fma += (c.get("estep_sweeps", 0) * sweep + r["iters"] * first
                + c.get("mstep_iters", 0) * newton + r["hsteps"] * 2 * refine)
        secs += r["em"]
    return 100.0 * 2.0 * fma / (secs * run.peaks["flops_fp32"]) if secs > 0 else None
