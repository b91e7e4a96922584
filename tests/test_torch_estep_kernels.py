"""The plain versions of the E-step's per-sweep kernels
(``vlgp_tpu_torch/ops/estep.py``) against the composition of
``vlgp_tpu.models.vlgp``'s ``_eta``, ``_rates``, ``_residual``,
``_woodbury_delta`` and ``_weights`` in float64, the CPU dispatch, the
sweep's calls, and the CUDA wrappers' refusals.  The kernels themselves run
on the card only (``chip_smoke.py``, 6e); these tests hold the arithmetic
that they are compared with there.

Tolerance: each output within 1e-12 of the largest |entry| of ``vlgp_tpu``'s
(the phase parity's float64 level): both packages compute the same
products, and only the order of the einsums' sums differs.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlgp_tpu.models import vlgp as jv
from vlgp_tpu_torch.models import vlgp as tv
from vlgp_tpu_torch.ops import estep as oe
from vlgp_tpu_torch.ops import spd as tspd

from _torch_parity import pin_state

torch.set_num_threads(1)

TOL = 1e-12

# name: (S, T, Y, Z, R, X, channels, ragged mask, dmu_bound)
CASES = {
    "poisson": (6, 9, 7, 3, 4, 1, "poisson", False, 5.0),
    "mixed_padded": (6, 9, 8, 3, 4, 1, "mixed", False, 5.0),
    "ragged": (7, 11, 6, 2, 5, 1, "poisson", True, 5.0),
    "y99": (4, 5, 99, 2, 3, 1, "mixed", True, 5.0),
    "z1": (5, 8, 6, 1, 3, 1, "poisson", False, 5.0),
    "t1": (5, 1, 6, 3, 1, 1, "mixed", False, 5.0),
    "x2": (6, 9, 7, 3, 4, 2, "mixed", True, 5.0),
    "clipped": (6, 9, 7, 3, 4, 1, "poisson", False, 0.05),
}


def _inputs(S, T, Y, Z, R, X, channels, ragged, dmu_bound, seed=0):
    """float64 numpy inputs of one sweep: y, x (S, T, X, Y: the bias and
    X - 1 lags of y), mask, a, b, noise, poisson, G (Z, T, R), mu, v, w (Z,
    S, T) and X the Woodbury inverses (Z, S, R, R) at the masked w.  With
    ``mixed`` channels the second half is Gaussian, the last channel
    padded (zero loading, regression, data and noise) and channel 0 a
    Poisson channel whose unused noise is NaN."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(Z, T, R)) * 0.6
    mu = rng.normal(size=(Z, S, T)) * 0.5
    v = rng.uniform(0.01, 0.1, size=(Z, S, T))
    w = rng.uniform(0.1, 3.0, size=(Z, S, T))
    a = rng.normal(size=(Z, Y)) * 0.4
    b = np.concatenate([np.full((1, Y), -0.5), rng.normal(size=(X - 1, Y)) * 0.05])
    eta = np.einsum("zst,zy->sty", mu, a) + b[0]
    y = rng.poisson(np.exp(eta)).astype(np.float64)
    poisson = np.ones(Y, dtype=bool)
    noise = np.ones(Y)
    if channels == "mixed":
        gauss = np.arange(Y) >= Y // 2
        poisson[gauss] = False
        noise[gauss] = rng.uniform(0.5, 2.0, size=int(gauss.sum()))
        y[..., gauss] = eta[..., gauss] + rng.normal(size=(S, T, int(gauss.sum())))
        a[:, -1] = 0.0
        b[:, -1] = 0.0
        y[..., -1] = 0.0
        noise[-1] = 0.0
        noise[0] = np.nan
    x = np.ones((S, T, X, Y))
    for q in range(1, X):
        x[:, q:, q] = y[:, :-q]
        x[:, :q, q] = 0.0
    mask = np.ones((S, T))
    if ragged:
        ends = rng.integers(1, T + 1, size=S)
        mask = (np.arange(T)[None] < ends[:, None]).astype(np.float64)
        mask[0] = 0.0
    wm = w * mask[None]
    Xinv = np.linalg.inv(np.eye(R) + np.einsum("ztr,zst,ztq->zsrq", G, wm, G))
    return dict(y=y, x=x, mask=mask, a=a, b=b, noise=noise, poisson=poisson, G=G, mu=mu, v=v,
                w=wm, X=Xinv, dmu_bound=dmu_bound)


def _jax_sweep(d):
    """s, then (mu + delta, delta, w) of one sweep as vlgp_tpu/models/vlgp.py:
    estep's sweep forms them (:202-214), from s as vlgp_tpu's stage a gives it."""
    j = {k: jnp.asarray(v) for k, v in d.items() if k != "dmu_bound"}
    params = types.SimpleNamespace(poisson=j["poisson"], noise=j["noise"])
    xb = jv._xb(j["x"], j["b"])
    a, mask = j["a"], j["mask"]
    maskz = mask[None]
    eta = jv._eta(j["mu"], a, xb)
    r = jv._rates(eta, j["v"], a)
    residual = jv._residual(j["y"], eta, r, params) * mask[..., None]
    s = jnp.einsum("sty,zy->zst", residual, a)
    delta = jv._woodbury_delta(j["G"], s, j["mu"], j["w"] * maskz, j["X"])
    delta = jnp.clip(delta, -d["dmu_bound"], d["dmu_bound"]) * maskz
    mu = j["mu"] + delta
    eta = jv._eta(mu, a, xb)
    r = jv._rates(eta, j["v"], a)
    U = jnp.where(params.poisson, r, 1.0 / jv._safe_noise(params.noise))
    w = jv._weights(U, a, jv.Dist()) * maskz
    return s, (mu, delta, w)


def _port_args(d):
    t = {k: torch.tensor(v) for k, v in d.items() if k != "dmu_bound"}
    xb = tv._xb(t["x"], t["b"])
    project = (t["y"], xb, t["mask"], t["a"], t["mu"], t["v"], t["poisson"], t["noise"])
    return t, xb, project


def _assert_within(name, got, ref):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    assert np.isfinite(ref).all(), name
    gap = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)
    assert gap <= TOL, f"{name}: {gap:.2e} of its largest |entry| from vlgp_tpu's"


@pytest.mark.parametrize("case", list(CASES))
def test_estep_project_plain_matches_jax(case):
    """_estep_project_plain's s against vlgp_tpu's _eta, _rates, _residual
    and the s einsum, within TOL; the wrapper on CPU tensors is the plain
    version bit for bit and launches nothing."""
    d = _inputs(*CASES[case])
    ref, _ = _jax_sweep(d)
    _, _, project = _port_args(d)
    got = oe._estep_project_plain(*project)
    _assert_within("s", got, ref)
    before = dict(tspd.KERNEL_LAUNCHES)
    assert torch.equal(oe.estep_project(*project), got)
    assert dict(tspd.KERNEL_LAUNCHES) == before


@pytest.mark.parametrize("case", list(CASES))
def test_estep_step_plain_matches_jax(case):
    """_estep_step_plain's mu + delta, delta and w against vlgp_tpu's
    _woodbury_delta, clip, update, _eta, _rates and _weights, within TOL,
    from the same s; the wrapper on CPU tensors is the plain version bit for
    bit.  A masked bin's delta and w are exactly 0."""
    d = _inputs(*CASES[case])
    s, ref = _jax_sweep(d)
    t, xb, _ = _port_args(d)
    args = (t["G"], torch.tensor(np.asarray(s)), t["mu"], t["w"], t["X"], t["mask"], t["a"], xb,
            t["v"], t["poisson"], t["noise"], d["dmu_bound"])
    got = oe._estep_step_plain(*args)
    for name, g, r in zip(("mu", "delta", "w"), got, ref):
        _assert_within(name, g, r)
    for g, h in zip(got, oe.estep_step(*args)):
        assert torch.equal(g, h)
    off = t["mask"][None].expand_as(got[1]) == 0
    assert bool((got[1][off] == 0).all()) and bool((got[2][off] == 0).all())
    if d["dmu_bound"] < 1.0:  # the clip is exercised
        assert float(got[1].abs().max()) == d["dmu_bound"]


def test_estep_sweep_calls_each_wrapper_once_a_sweep(monkeypatch):
    """models/vlgp.estep's sweep goes through estep_project and estep_step,
    once each a sweep, and nothing else of stages a-c: a fixed count of
    sweeps (estep_tol 0) on the pin workload, the same bits as without the
    counting wrappers."""
    _, (seg, params, G, cfg) = pin_state(estep_tol=0.0)
    ref = tv.estep(seg, params, G, cfg, niter=3)
    calls = {"estep_project": 0, "estep_step": 0}

    def counted(name):
        fn = getattr(tv, name)

        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call

    for name in calls:
        monkeypatch.setattr(tv, name, counted(name))
    got = tv.estep(seg, params, G, cfg, niter=3)
    assert calls == {"estep_project": 3, "estep_step": 3}
    for name in ("mu", "w", "v", "dmu"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    """The launch paths raise on shapes that do not fit, on Z or R above the
    cap and on an empty axis before they look at the device; then on
    float16 and on CPU tensors (the dispatchers give those to the plain
    versions).  The public wrappers check shapes on the CPU too, and take
    no other device than CUDA and the CPU."""
    d = _inputs(*CASES["mixed_padded"])
    t, xb, project = _port_args(d)
    step = (t["G"], t["mu"], t["mu"], t["w"], t["X"], t["mask"], t["a"], xb, t["v"],
            t["poisson"], t["noise"], 5.0)
    with pytest.raises(ValueError, match="shape"):
        oe._estep_project_cuda(*project[:4], project[4][:, 1:], *project[5:])
    with pytest.raises(ValueError, match="shape"):
        oe._estep_step_cuda(*step[:4], step[4][:, :, :-1], *step[5:])
    with pytest.raises(ValueError, match="shape"):
        oe.estep_project(*project[:7], project[7][:-1])
    with pytest.raises(ValueError, match="shape"):
        oe.estep_step(step[0], step[1][:, 1:], *step[2:])
    big = torch.zeros((oe.Z_MAX + 1, 2, 3))
    with pytest.raises(ValueError, match="Z <= 128"):
        oe._estep_project_cuda(torch.zeros(2, 3, 4), torch.zeros(2, 3, 4), torch.ones(2, 3),
                               torch.zeros(oe.Z_MAX + 1, 4), big, big,
                               torch.ones(4, dtype=torch.bool), torch.ones(4))
    G = torch.zeros((2, 3, oe.R_MAX + 1))
    zst = torch.zeros((2, 2, 3))
    with pytest.raises(ValueError, match="R <= 128"):
        oe._estep_step_cuda(G, zst, zst, zst, torch.zeros((2, 2, oe.R_MAX + 1, oe.R_MAX + 1)),
                            torch.ones(2, 3), torch.zeros(2, 4), torch.zeros(2, 3, 4), zst,
                            torch.ones(4, dtype=torch.bool), torch.ones(4), 5.0)
    empty = torch.zeros((3, 0, 9))
    with pytest.raises(ValueError, match="empty"):
        oe._estep_project_cuda(torch.zeros(0, 9, 8), torch.zeros(0, 9, 8), torch.ones(0, 9),
                               t["a"], empty, empty, t["poisson"], t["noise"])
    with pytest.raises(TypeError, match="float32 or float64"):
        oe._estep_project_cuda(*[p.half() if p.is_floating_point() else p for p in project])
    with pytest.raises(TypeError, match="float32 or float64"):
        oe._estep_step_cuda(*[p.half() if torch.is_tensor(p) and p.is_floating_point() else p
                              for p in step])
    with pytest.raises(ValueError, match="CUDA"):
        oe._estep_project_cuda(*project)
    with pytest.raises(ValueError, match="CUDA"):
        oe._estep_step_cuda(*step)
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        oe.estep_project(*[p.to("meta") for p in project])
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        oe.estep_step(*[p.to("meta") if torch.is_tensor(p) else p for p in step])


# the shapes the card runs the kernels at (chip_smoke.py 6e): the
# flagship's segments, the final inference's whole trials and the edge
# shapes (S, T, Y, Z, R)
PLAN_SHAPES = {
    "flagship": (2000, 50, 100, 5, 40), "final_T1000": (100, 1000, 100, 5, 50),
    "t1": (37, 1, 37, 1, 1), "t1_z8": (37, 1, 37, 8, 1), "t13": (37, 13, 37, 1, 1),
    "t13_r13": (37, 13, 37, 8, 13), "t13_z5": (37, 13, 37, 5, 1), "t64_r17": (37, 64, 37, 1, 17),
    "t64_r64": (37, 64, 37, 8, 64), "t64_z5": (37, 64, 37, 5, 17),
    "t200_r128": (11, 200, 37, 5, 128), "y99": (53, 50, 99, 5, 40), "z12": (29, 50, 100, 12, 40),
    "z40": (5, 130, 30, 40, 128), "z128": (3, 20, 300, 128, 10),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", list(PLAN_SHAPES))
def test_launch_plans_fit_cover_every_row_and_segment_once_and_refuse_nothing(shape, dtype):
    """The launch plan of both kernels at every shape the card sees: a shape
    the first design's wrapper took is taken (``_check_sizes`` unchanged, a
    plan on one of the two paths); each plan's shared memory fits the
    H100's 232,448 bytes a block; the blocks' walks cover every row (stage
    a) and every segment (stages b-c) exactly once; the streaming path's
    tiles and groups are the kernels' (rows a multiple of the consumer
    warps, segments of a block alternating between its groups).  The
    first design's plans fit and cover too, and the flagship streams."""
    S, T, Y, Z, R = PLAN_SHAPES[shape]
    oe._check_sizes("estep_step", S, T, Y, Z, R)
    pp, sp = oe.project_plan(S, T, Y, Z, dtype), oe.step_plan(S, T, Y, Z, R, dtype)
    for plan in (pp, sp) + tuple(oe.block_plans(S, T, Y, Z, R, dtype)):
        assert plan.path in ("stream", "cluster", "block")
        assert 0 < plan.smem <= oe.SMEM_MAX == 232_448
        assert 1 <= plan.grid and plan.threads % 32 == 0 and plan.threads <= 1024
    bp, bs = oe.block_plans(S, T, Y, Z, R, dtype)
    for plan in (pp, bp):
        seen = np.zeros(S * T, dtype=np.int64)
        for block in oe.project_walk(plan, S * T):
            for first, n, _ in block:
                assert n >= 1
                seen[first:first + n] += 1
        assert (seen == 1).all()
    for plan in (sp, bs):
        seen = np.zeros(S, dtype=np.int64)
        walk = oe.step_walk(plan, S)
        if plan.path == "cluster":  # a cluster's blocks share its segments
            assert all(walk[b] == walk[b - b % plan.units] for b in range(plan.grid))
            walk = walk[::plan.units]
        for block in walk:
            groups = [g for _, g in block]
            assert groups == [0 if plan.path == "cluster" else k % max(plan.units, 1)
                              for k in range(len(block))]
            for seg, _ in block:
                seen[seg] += 1
        assert (seen == 1).all()
    if pp.path == "stream":
        assert pp.units % 15 == 0 and pp.grid <= oe.SMS and 2 <= pp.stages <= 4
        assert pp.smem == oe._project_smem(pp.units, pp.stages, Y, Z, dtype.itemsize)
    if sp.path == "stream":
        assert sp.units in (1, 2) and sp.grid == min(S, oe.SMS) and 2 <= sp.stages <= 4
        assert sp.threads == 256 * sp.units + 32
    if shape == "flagship" and dtype == torch.float32:
        assert (pp.path, pp.units, pp.stages, sp.path, sp.units, sp.stages) == \
            ("stream", 60, 4, "stream", 2, 3)
    if shape == "final_T1000":  # G alone is 1 MB: a cluster of 16 blocks shares it in float32
        assert sp.path == ("cluster" if dtype == torch.float32 else "block")
