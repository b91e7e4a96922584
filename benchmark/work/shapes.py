"""The shapes a configuration's calls run at, worked out from the
configuration by the reference's own rules: the segments (count, window and
the segment factor's rank) and the whole trials."""
import numpy as np

from reference import vlgp as ref


def fit_shapes(config):
    d, f, s = config["data"], config["fit"], config["settings"]
    N, T, Y, Z = d["trials"], d["bins"], d["neurons"], f["n_factors"]
    window = s["window"]
    if window:
        idx, _ = ref.cut(np.full(N, T), window, s["seed"])
        hi = max(f["omega"], s["omega_bound"][1])
        seg = dict(Z=Z, S=len(idx), T=window, Y=Y,
                   R=min(f["rank"], ref.effective_rank(window, hi, f["dt"])))
    else:
        seg = dict(Z=Z, S=N, T=T, Y=Y, R=min(f["rank"], T))
    return dict(seg=seg, trial=dict(Z=Z, S=N, T=T, Y=Y, R=min(f["rank"], T)))
