"""ns_gram's share of its roofline in the traced passes: every call runs at
a chunk's shape (Z, batch x trials, T, R) on the pairs design; it writes v
where its v GEMM ran (work/ns_gram.py).  Bound: operations."""
from metric_lib import kind, least_s, matching, share


def read(run):
    if kind(run) != "lono" or run.trace is None:
        return None
    ops = run.trace["ops"]
    W = run.work("ns_gram")
    tr = run.work("shapes").fit_shapes(run.config)["trial"]
    S = int(run.traffic["batch"]) * tr["S"]
    n_pairs, _ = matching(ops, "ns_gram_solve_kernel")
    n_v, _ = matching(ops, "ns_gram_v_kernel", "pairs_gemm_kernel<1")
    _, secs = matching(ops, "ns_gram", "pairs_gemm")
    least = (n_v * least_s(run, W.least(tr["Z"], S, tr["T"], tr["R"], want_v=True))
             + max(n_pairs - n_v, 0) * least_s(run, W.least(tr["Z"], S, tr["T"], tr["R"])))
    return share(least, secs)
