"""The comparison that decides a run's ``correct``.

A fit is judged stage by stage, each stage against ``reference/vlgp.py`` in
float64 on the same device:

  * ``it0``: the reference builds the EM's start itself from the run's
    inputs (packing, the weights and variances on whole trials under the
    first prior factor, the segments, the segment factor) and runs the first
    EM iteration (E-step, M-step, H-step); the program's state after its
    first iteration is compared with it.
  * ``it1``: from the program's state after its first iteration, the
    reference runs the second (E-step and M-step; the cadence skips the
    H-step) and is compared with the program's state after its second;
    ``m1`` is that M-step alone, from the program's own second E-step.
  * ``h0`` and ``hf``: the first H-step, from the program's state after its
    first E-step and M-step, and the closing H-step, from its last state.
    Judged by omega and by the amplitude at the program's own omega
    (``hstep_amplitude``).
  * ``final``: under the result's omega and sigma, the write-back of the
    last state's segments, the whole-trial factor, weights and variances and
    the final inference (compared with the result's posterior).

Every E-step of the reference runs under its own exit rule.  The program's
float32 exit test can stop one sweep before or after the float64 one, so the
program's posterior is compared with the reference's after the sweep at the
reference's exit and after the sweeps either side of it, and the nearest
counts; one that stops two sweeps early reads the gap of that sweep.

A leave-one-neuron-out pass is judged by every neuron's score against the
reference's, each member under its own exit and the same one-sweep
allowance.  Each number is a relative gap, max |program - reference| over
max |reference|, of the leaves named; the limits are in ``limits/<cell>.json``.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from reference import vlgp as ref

F32 = torch.float32


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 products on or off inside the block (off is PyTorch's default for
    float32 matmuls, and the reference's)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def gap(x, r) -> float:
    """max |x - r| / max |r| in float64."""
    x, r = torch.as_tensor(x).double(), torch.as_tensor(r).double().to(torch.as_tensor(x).device)
    den = float(r.abs().max())
    return float((x - r).abs().max()) / den if den > 0 else float((x - r).abs().max())


def settings(config: dict) -> dict:
    """The reference's settings: the configuration's fit settings beside its
    prior's gp_noise and dt.  Raises on a setting the reference does not
    implement."""
    s = dict(config["settings"])
    s.update(gp_noise=config["fit"]["gp_noise"], dt=config["fit"]["dt"])
    want = dict(method="VB", constrain_loading="fro", constrain_latent="none", use_hessian=True,
                hyper_refines=2, hyper_window=0.0, hyper_polish=False, Hstep=True)
    for k, v in want.items():
        if s[k] != v:
            raise ValueError(f"the reference implements {k}={v!r}, the configuration states "
                             f"{s[k]!r}")
    if config["fit"]["lik"] != "poisson":
        raise ValueError("the reference implements Poisson channels")
    return s


# ---------------------------------------------------------------------------
# program objects -> plain tensors (read only to be judged or followed)
# ---------------------------------------------------------------------------


def plain_state(d, p) -> dict:
    """A program TrialSet and Params as plain tensors, latents first."""
    z = lambda t: t.permute(2, 0, 1)  # noqa: E731
    return dict(mu=z(d.mu), w=z(d.w), v=z(d.v), dmu=z(d.dmu), mask=d.mask,
                a=p.a, b=p.b, noise=p.noise, sigma=p.sigma, omega=p.omega, da=p.da, db=p.db)


def _as(st: dict, dtype) -> dict:
    return {k: (v.to(dtype) if torch.is_tensor(v) and v.is_floating_point() else v)
            for k, v in st.items()}


# ---------------------------------------------------------------------------
# a fit's stages
# ---------------------------------------------------------------------------


class FitReference:
    """The reference's view of one dataset under one configuration, on
    ``device``: the whole trials, the segments and the settings."""

    def __init__(self, dataset: dict, config: dict, device, dtype):
        self.s = settings(config)
        self.dtype = dtype
        self.pdtype = getattr(torch, self.s["dtype"])  # the program's stated precision
        f = config["fit"]
        trials = dataset["trials"]
        y = torch.as_tensor(np.stack([t["y"] for t in trials]), device=device, dtype=dtype)
        N, T, Y = y.shape
        self.T, self.Y, self.Z = T, Y, f["n_factors"]
        self.y_full = y
        self.x_full = torch.ones((N, T, 1, Y), dtype=dtype, device=device)
        self.mask_full = torch.ones((N, T), dtype=dtype, device=device)
        self.mu0_full = torch.as_tensor(np.stack([t["mu"] for t in trials]), device=device,
                                        dtype=dtype).permute(2, 0, 1)
        self.poisson = torch.ones(Y, dtype=torch.bool, device=device)
        window = self.s["window"]
        self.idx, self.start = ref.cut(np.full(N, T), window, self.s["seed"])
        self.window = window or T
        seg = lambda t: ref.gather(t, self.idx, self.start, self.window) if window else t  # noqa
        self.y, self.x, self.mask = seg(self.y_full), seg(self.x_full), seg(self.mask_full)
        self.a0 = torch.as_tensor(dataset["a"], device=device).to(self.pdtype)
        self.b0 = torch.full((1, Y), f["b"], dtype=self.pdtype, device=device)
        self.omega0 = torch.full((self.Z,), f["omega"], dtype=self.pdtype, device=device)
        hi = max(float(self.omega0.max()), self.s["omega_bound"][1])
        self.seg_rank = min(f["rank"], ref.effective_rank(self.window, hi, f["dt"]))
        self.rank = f["rank"]

    def factor(self, T, omega, sigma, rank):
        return ref.factor(T, omega, sigma, rank, self.s["dt"], self.pdtype, self.dtype)

    def start_state(self) -> dict:
        """The EM's initial segment state from the inputs alone."""
        dt = self.dtype
        Y, Z = self.Y, self.Z
        p = dict(a=self.a0.to(dt), b=self.b0.to(dt), noise=torch.ones(Y, dtype=dt,
                                                                        device=self.y.device),
                 sigma=torch.ones(Z, dtype=dt, device=self.y.device), omega=self.omega0)
        G = self.factor(self.T, p["omega"], p["sigma"], self.rank)
        xb = torch.einsum("stxy,xy->sty", self.x_full, p["b"])
        zeros = torch.zeros_like(self.mu0_full)
        w = ref.weights(self.mu0_full, zeros, p["a"], xb, self.poisson, p["noise"],
                        self.mask_full[None])
        v = ref.marginal_v(G, ref.inv_gram(G, w)) * self.mask_full[None]
        seg = lambda t: (ref.gather(t.permute(1, 2, 0), self.idx, self.start, self.window)  # noqa
                         .permute(2, 0, 1)) if self.s["window"] else t
        st = dict(mu=seg(self.mu0_full), w=seg(w), v=seg(v), dmu=torch.zeros_like(seg(w)),
                  mask=self.mask, da=torch.zeros_like(p["a"]), db=torch.zeros_like(p["b"]))
        st.update(p)
        return st

    def _estep(self, args, state, niter, judged):
        """The E-step under its own exit; with ``judged`` (the judged side's
        posterior mean) the state kept is the one nearest it among the
        states after the sweep at the exit and the sweeps either side."""
        if judged is None:
            return ref.estep(*args, state, self.s, niter)[0]
        trail = []
        _, k = ref.estep(*args, state, self.s, niter, extra=1, each=trail.append)
        return trail[nearest(judged, [t[0] for t in trail], int(k[0]), niter)]

    def iteration(self, st: dict, it: int, judged=None) -> dict:
        """One EM iteration of the segments from state ``st``."""
        s, dt = self.s, self.dtype
        st = _as(st, dt)
        G = self.factor(self.window, st["omega"], st["sigma"], self.seg_rank)
        mu, a = ref.constrain_fro(st["mu"], st["a"], s["eps"])
        xb = torch.einsum("stxy,xy->sty", self.x, st["b"])
        mu, w, v, dmu = self._estep((self.y, xb, self.mask, a, self.poisson, st["noise"], G),
                                    (mu, st["w"], st["v"], st["dmu"]), s["Eniter"], judged)
        a, b, noise, da, db = ref.mstep(self.y, self.x, self.mask, mu, v, a, st["b"],
                                        st["noise"], st["da"], st["db"], s)
        omega, sigma = st["omega"], st["sigma"]
        if it % max(1, s["hyper_interval"]) == 0:
            omega, sigma = ref.hstep(mu, w, self.mask, omega, sigma, s, self.seg_rank,
                                     self.pdtype)
        return dict(mu=mu, w=w, v=v, dmu=dmu, mask=self.mask, a=a, b=b, noise=noise,
                    sigma=sigma, omega=omega, da=da, db=db)

    def hstep(self, st: dict, omega=None, sigma=None):
        """The H-step from state ``st`` (at ``omega`` and ``sigma`` where
        given, else the state's): (omega, sigma, statistic, segments)."""
        st = _as(st, self.dtype)
        omega = st["omega"] if omega is None else omega
        sigma = st["sigma"] if sigma is None else sigma.to(self.dtype)
        return ref.hstep(st["mu"], st["w"], self.mask, omega, sigma, self.s, self.seg_rank,
                         self.pdtype, stat=True)

    def final(self, st: dict, omega, sigma, judged=None):
        """The write-back of the last state's segments, then the whole-trial
        factor under (omega, sigma), weights, variances and inference."""
        s, dt = self.s, self.dtype
        st = _as(st, dt)
        if s["window"]:
            back = lambda t: ref.scatter(self.mu0_full.permute(1, 2, 0) * 0,  # noqa: E731
                                         t.permute(1, 2, 0), self.idx, self.start
                                         ).permute(2, 0, 1)
            mu, v = back(st["mu"]), back(st["v"])
        else:
            mu, v = st["mu"], st["v"]
        G = self.factor(self.T, omega, sigma.to(dt), self.rank)
        xb = torch.einsum("stxy,xy->sty", self.x_full, st["b"])
        mask = self.mask_full
        w = ref.weights(mu, v, st["a"], xb, self.poisson, st["noise"], mask[None])
        v = ref.marginal_v(G, ref.inv_gram(G, w)) * mask[None]
        mu, _, v, dmu = self._estep((self.y_full, xb, mask, st["a"], self.poisson, st["noise"],
                                     G), (mu, w, v, torch.zeros_like(mu)), s["max_iter"], judged)
        return mu, v, dmu


def nearest(judged, trail: list, k: int, niter: int) -> int:
    """Index into ``trail`` (the states or values after sweeps 1, 2, ...) of
    the one nearest ``judged`` among those after sweeps k - 1, k and k + 1
    that the exit rule allows (at least 2 sweeps, at most ``niter``)."""
    lo, hi = min(2, niter), min(k + 1, niter, len(trail))
    cand = [j for j in range(max(k - 1, lo), hi + 1)] or [len(trail)]
    return min(cand, key=lambda j: gap(judged, trail[j - 1])) - 1


def hstep_amplitude(omega, sigma, truth: dict) -> float:
    """max over latents of |sigma^2 / s(omega) - 1|: the program's amplitude
    against the profile optimum s that the reference's last statistic gives
    at the program's own omega.  A tie in the search's grid moves omega by
    tens of percent (its first refinement's pick sets the statistic of the
    second, and the Aitken step multiplies the difference); at a given omega
    the amplitude moves far less."""
    C, nseg, eps, dt = truth["C"], truth["nseg"], truth["gp_noise"], truth["dt"]
    x = torch.log(omega.to(C.device).to(C.dtype))
    _, s = ref.gp_elbo(x, C, nseg, C.shape[-1], None, eps, dt, True)
    return float(torch.max((sigma.to(C.device).to(C.dtype) ** 2 / s - 1).abs()))


LEAVES = ("mu", "v", "a", "b", "omega", "sigma")


def leaf_gaps(prefix: str, judged: dict, truth: dict) -> dict:
    """{prefix.leaf: gap} for each leaf both hold; an H-step's truth adds
    ``prefix.amp`` (``hstep_amplitude``)."""
    out = {f"{prefix}.{k}": gap(judged[k], truth[k]) for k in LEAVES
           if k in judged and k in truth}
    if "C" in truth:
        out[f"{prefix}.amp"] = hstep_amplitude(judged["omega"], judged["sigma"], truth)
    return out


def _stages(R: FitReference, snaps: dict, final: dict, judged=None) -> dict:
    """The reference's outputs of every stage, from the inputs or from the
    program's states in ``snaps``; with ``judged`` (the judged side's
    outputs) each E-step keeps the sweep nearest the judged side's."""
    s = R.s
    out = {}

    def mu(stage):
        return judged[stage]["mu"] if judged is not None else None

    def hstep(*a, **kw):
        om, sg, C, nseg = R.hstep(*a, **kw)
        return dict(omega=om, sigma=sg, C=C, nseg=nseg, gp_noise=s["gp_noise"], dt=s["dt"])

    out["it0"] = R.iteration(R.start_state(), 0, mu("it0"))
    out["it1"] = R.iteration(snaps[0], 1, mu("it1"))
    st0 = _as(snaps[0], R.dtype)
    st1 = _as(snaps[1], R.dtype)
    _, a0 = ref.constrain_fro(st0["mu"], st0["a"], s["eps"])
    a, b, _, _, _ = ref.mstep(R.y, R.x, R.mask, st1["mu"], st1["v"], a0, st0["b"], st0["noise"],
                              st0["da"], st0["db"], s)
    out["m1"] = dict(a=a, b=b)
    # the first H-step runs at the start's omega and unit amplitude
    out["h0"] = hstep(snaps[0], R.omega0.to(R.dtype), torch.ones_like(st0["sigma"]))
    out["hf"] = hstep(snaps["last"])
    mu_, v, dmu = R.final(snaps["last"], final["omega"], final["sigma"], mu("final"))
    out["final"] = dict(mu=mu_, v=v, dmu=dmu)
    return out


def program_outputs(snaps: dict, final: dict) -> dict:
    """The program's outputs of the same stages."""
    return {"it0": snaps[0], "it1": {k: snaps[1][k] for k in ("mu", "v", "a", "b", "dmu")},
            "m1": {k: snaps[1][k] for k in ("a", "b")},
            "h0": {k: snaps[0][k] for k in ("omega", "sigma")},
            "hf": {k: final[k] for k in ("omega", "sigma")},
            "final": {k: final[k] for k in ("mu", "v", "dmu")}}


def fit_numbers(dataset, config, snaps: dict, final: dict, device) -> dict:
    """Every stage's leaf gaps of the program: ``snaps`` {0, 1, "last"} of
    plain states, ``final`` the result's mu and v (latents first) and omega
    and sigma."""
    R = FitReference(dataset, config, device, torch.float64)
    judged = program_outputs(snaps, final)
    with precision(False):
        truth = _stages(R, snaps, final, judged)
    nums = {}
    for stage, t in truth.items():
        nums.update(leaf_gaps(stage, judged[stage], t))
    return nums


def fit_control_numbers(dataset, config, snaps: dict, final: dict, device) -> dict:
    """The same numbers for the control: the reference itself in the
    program's place, in float32 with TF32 products, judged against the
    float64 reference from the same states.  Its final inference runs under
    its own closing omega and sigma, on both sides."""
    lo = FitReference(dataset, config, device, F32)
    hi = FitReference(dataset, config, device, torch.float64)
    with precision(True):
        cf = dict(zip(("omega", "sigma"), lo.hstep(snaps["last"])[:2]))
        ctl = _stages(lo, snaps, cf)
    with precision(False):
        truth = _stages(hi, snaps, cf, ctl)
    nums = {}
    for stage, t in truth.items():
        nums.update(leaf_gaps(stage, ctl[stage], t))
    return nums


# ---------------------------------------------------------------------------
# leave-one-neuron-out
# ---------------------------------------------------------------------------


def lono_model(dataset: dict, config: dict) -> dict:
    """The model a pass scores, stated by the benchmark: the generating
    loading, the configuration's bias and omega, unit amplitude."""
    f = config["fit"]
    Y = dataset["a"].shape[1]
    return dict(a=dataset["a"], b=np.full((1, Y), f["b"], np.float32),
                omega=np.full(f["n_factors"], f["omega"], np.float32),
                sigma=np.ones(f["n_factors"], np.float32))


def lono_reference(dataset, config, device, dtype, tf32: bool = False, extra: int = 0):
    """Every neuron's scores after each sweep and its sweeps at its exit
    (``reference.lono_scores``) by the reference in ``dtype``."""
    s = settings(config)
    m = lono_model(dataset, config)
    trials = dataset["trials"]
    y = torch.as_tensor(np.stack([t["y"] for t in trials]), device=device, dtype=dtype)
    N, T, Y = y.shape
    a = torch.as_tensor(m["a"], device=device).to(dtype)
    b = torch.as_tensor(m["b"], device=device).to(dtype)
    xb = b[0].expand(N, T, Y)
    mask = torch.ones((N, T), dtype=dtype, device=device)
    omega = torch.as_tensor(m["omega"], device=device)  # float32, as the program holds it
    sigma = torch.as_tensor(m["sigma"], device=device)
    with precision(tf32):
        G = ref.factor(T, omega, sigma, config["fit"]["rank"], s["dt"], F32, dtype)
        return ref.lono_scores(y, xb, mask, a, torch.ones(Y, dtype=torch.bool, device=device),
                               torch.ones(Y, dtype=dtype, device=device), G, list(range(Y)), s,
                               s["max_iter"], extra=extra)


def at_exit(trails: dict, ran: dict) -> dict:
    """{neuron: score after the sweep at its exit}."""
    return {n: trails[n][ran[n]] for n in trails}


def lono_gap(scores: dict, trails: dict, ran: dict, niter: int) -> float:
    """max_n |score - reference| / mean_n |reference|, the reference's score
    of neuron n taken after the sweep at its exit or either side of it,
    whichever is nearest (``nearest``)."""
    keys = sorted(trails)
    d, r = [], []
    for n in keys:
        after = trails[n][1:]  # after sweeps 1, 2, ...
        j = nearest(scores[n], after, ran[n], niter) if after else -1
        ref_n = after[j] if after else trails[n][0]
        d.append(scores[n] - ref_n)
        r.append(trails[n][ran[n]])
    return float(np.abs(np.array(d)).max() / np.abs(np.array(r)).mean())
