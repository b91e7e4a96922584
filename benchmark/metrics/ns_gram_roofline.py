"""ns_gram's share of its roofline in the traced fits: the calls' least
time (work/ns_gram.py) over the device time of every ns_gram kernel.  Calls
are counted by kernel name: a per-matrix kernel is a call at the segments'
shape, a pairs solve a call at the whole trials' shape; a pairs call writes
v where its v GEMM ran.  Bound: operations."""
from metric_lib import kind, least_s, matching, share


def read(run):
    if kind(run) != "fit" or run.trace is None:
        return None
    ops = run.trace["ops"]
    W = run.work("ns_gram")
    sh = run.work("shapes").fit_shapes(run.config)
    seg, tr = sh["seg"], sh["trial"]
    n_pm, _ = matching(ops, "ns_gram_kernel", "ns_gram_stream_kernel")
    n_pairs, _ = matching(ops, "ns_gram_solve_kernel")
    n_v, _ = matching(ops, "ns_gram_v_kernel", "pairs_gemm_kernel<1")
    _, secs = matching(ops, "ns_gram", "pairs_gemm")
    least = (n_pm * least_s(run, W.least(seg["Z"], seg["S"], seg["T"], seg["R"]))
             + n_v * least_s(run, W.least(tr["Z"], tr["S"], tr["T"], tr["R"], want_v=True))
             + max(n_pairs - n_v, 0) * least_s(run, W.least(tr["Z"], tr["S"], tr["T"], tr["R"])))
    return share(least, secs)
