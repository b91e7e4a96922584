"""The plain versions of the M-step's and the H-step's kernels
(``vlgp_tpu_torch/ops/mstep.py``, ``ops/golden.py``) against ``vlgp_tpu``
in float64, and the CUDA wrappers' refusals.  The kernels themselves run on
the card only (``chip_smoke.py``, 6c); these tests hold the arithmetic
that the kernels are compared with on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlgp_tpu.models import gp as jgp
from vlgp_tpu.models import vlgp as jv
from vlgp_tpu_torch.ops import golden as og
from vlgp_tpu_torch.ops import mstep as om
from vlgp_tpu_torch.ops import spd as tspd

from _torch_parity import assert_close, pin_state, port_config, to_np

torch.set_num_threads(1)

_NAMES = ("s1", "s2", "C1", "C2", "grad_b", "E1", "E2", "E3", "nhess_b")


def _mstep_inputs(S=7, T=11, Y=5, Z=3, X=2, seed=0):
    """float64 inputs with a ragged mask: y (S, T, Y), x (S, T, X, Y) (the
    bias and a lag of y), mask (S, T), mu and v (S, T, Z), a (Z, Y), b (X, Y)."""
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=(S, T, Z)) * 0.5
    v = rng.uniform(0.01, 0.1, size=(S, T, Z))
    a = rng.normal(size=(Z, Y)) * 0.3
    b = np.concatenate([np.full((1, Y), -1.0), rng.normal(size=(X - 1, Y)) * 0.05])
    y = rng.poisson(np.exp(mu @ a - 1.0)).astype(np.float64)
    x = np.ones((S, T, X, Y))
    for q in range(1, X):
        x[:, q:, q] = y[:, :-q]
        x[:, :q, q] = 0.0
    ends = rng.integers(1, T + 1, size=S)
    mask = (np.arange(T)[None] < ends[:, None]).astype(np.float64)
    return y, x, mask, mu, v, a, b


def _jax_stats(y, x, mask, mu, v, a, b):
    """The statistics as vlgp_tpu/models/vlgp.py:374-413 forms them, with
    _masked_var's sums (:316-324) beside them."""
    y, x, mask, mu, v, a, b = map(jnp.asarray, (y, x, mask, mu, v, a, b))
    muz, vz = jv._zmajor(mu), jv._zmajor(v)
    m = mask[..., None]
    maskz = mask[None]
    mum, vm = muz * maskz, vz * maskz
    eta = jv._eta(muz, a, jv._xb(x, b))
    resid = y - eta
    r = jv._rates(eta, vz, a)
    rm = r * m
    return [jnp.sum(resid * m, axis=(0, 1)), jnp.sum(resid * resid * m, axis=(0, 1)),
            jnp.einsum("zst,sty->zy", mum, y - r), jnp.einsum("zst,sty->zy", vm, r),
            jnp.einsum("stxy,sty->xy", x, y * m - rm),
            jnp.einsum("sty,zst,kst->yzk", rm, muz, muz),
            jnp.einsum("sty,zst,kst->yzk", rm, vz, muz),
            jnp.einsum("sty,zst,kst->yzk", rm, vz, vz),
            jnp.einsum("stxy,sty,stqy->yxq", x, rm, x)]


def test_mstep_stats_plain_matches_jax():
    """_mstep_stats_plain against vlgp_tpu's einsums on Z3 S7 T11 Y5 X2
    with a ragged mask, float64 at 1e-12; the wrapper on CPU tensors is the
    plain version bit for bit, with and without the Hessian's terms."""
    args = _mstep_inputs()
    ref = _jax_stats(*args)
    targs = [torch.tensor(t) for t in args]
    got = om._mstep_stats_plain(*targs, True)
    assert len(got) == len(ref) == len(_NAMES)
    for name, g, r in zip(_NAMES, got, ref):
        assert_close(g, np.asarray(r), rtol=1e-12, atol=1e-12, err_msg=name)
    for hess in (True, False):
        via = om.mstep_stats(*targs, use_hessian=hess)
        plain = om._mstep_stats_plain(*targs, hess)
        assert len(via) == (9 if hess else 5)
        assert all(torch.equal(p, q) for p, q in zip(via, plain))


def test_flat_layout_round_trip():
    """The order in which mstep_update's CUDA route concatenates the summed
    statistics is the reduce kernel's layout: _flat_views of the
    concatenation gives back each statistic."""
    targs = [torch.tensor(t) for t in _mstep_inputs()]
    for hess in (True, False):
        plain = om._mstep_stats_plain(*targs, hess)
        flat = torch.cat([t.reshape(-1) for t in plain])
        views = om._flat_views(flat, 5, 3, 2, hess)
        assert [tuple(v.shape) for v in views] == [tuple(p.shape) for p in plain]
        assert all(torch.equal(v, p) for v, p in zip(views, plain))


def _one_iteration(use_hessian, active):
    """vlgp_tpu.mstep(Mniter=1) on the pin workload (v drawn, channel 4
    inert when ``active``) and the port's plain statistics and update on the
    same inputs: (reference as numpy, the port's outputs, port config, the
    port's params)."""
    (jseg, jp, _, jcfg), (tseg, tp, _, _) = pin_state()
    rng = np.random.default_rng(3)
    v = rng.uniform(0.01, 0.2, size=np.asarray(jseg.v).shape)
    jseg, tseg = jseg.replace(v=jnp.asarray(v)), tseg.replace(v=torch.tensor(v))
    act = np.arange(10) != 4 if active else None
    if active:
        jp = jp.replace(active=act)
    jcfg = jcfg.replace(Mniter=1, mstep_tol=0.0, use_hessian=use_hessian, learning_rate=1e-3)
    cfg = port_config(jcfg)
    ref = jv.mstep(jseg, jp, jcfg)
    stats = om._mstep_stats_plain(tseg.y, tseg.x, tseg.mask, tseg.mu, tseg.v, tp.a, tp.b,
                                  use_hessian)
    got = om._mstep_update_plain(stats, torch.sum(tseg.mask), tp.a, tp.b, tp.noise,
                                 None if act is None else torch.tensor(act), use_hessian,
                                 cfg.eps, cfg.learning_rate, cfg.da_bound, cfg.db_bound)
    return ref, got, tp


@pytest.mark.parametrize("use_hessian,active", [(True, True), (False, True), (False, False)])
def test_mstep_update_plain_matches_jax(use_hessian, active):
    """One Newton (or gradient) iteration from _mstep_stats_plain and
    _mstep_update_plain against vlgp_tpu.mstep with Mniter=1 on the pin
    workload, float64: a, b, noise, da and db, with channel 4 inert."""
    jref, got, tp = _one_iteration(use_hessian, active)
    ref = to_np(jref)
    for name, g in zip(("a", "b", "noise", "da", "db"), got):
        assert_close(g, ref[name], atol=1e-13, err_msg=name)
    if active:
        assert torch.equal(got[0][:, 4], tp.a[:, 4]) and not bool(got[3][:, 4].any())


@pytest.mark.parametrize("use_hessian,active", [(True, True), (False, True), (True, False)])
def test_mstep_update_plain_norms_match_jax(use_hessian, active):
    """The exit test's four squared norms that _mstep_update_plain returns
    (sum da^2, sum a_new^2, sum db^2, sum b_new^2) against vlgp_tpu's _gn2
    of the same iteration's outputs (vlgp_tpu/models/vlgp.py:483-484, one
    device), float64 at 1e-13, channel 4 inert."""
    jref, got, _ = _one_iteration(use_hessian, active)
    want = [jnp.sum(jref.da * jref.da), jnp.sum(jref.a * jref.a), jnp.sum(jref.db * jref.db),
            jnp.sum(jref.b * jref.b)]
    assert got[5].shape == (4,)
    assert_close(got[5], np.array([float(w) for w in want]), rtol=1e-13, atol=0.0)
    assert torch.equal(got[5], om.squared_norms(got[3], got[0], got[4], got[1]))


@pytest.mark.parametrize("use_hessian", [True, False])
def test_mstep_adaptive_trips_match_jax(use_hessian):
    """models.vlgp.mstep with mstep_tol > 0 (its exit test on mstep_update's
    norms) on the pin workload takes vlgp_tpu's number of Newton iterations:
    vlgp_tpu's fit of that many fixed iterations equals its adaptive one,
    and one fewer does not; a, b, noise, da and db at 1e-12, float64."""
    from vlgp_tpu_torch.models import vlgp as tv
    from vlgp_tpu_torch.ops import control

    (jseg, jp, _, jcfg), (tseg, tp, _, _) = pin_state()
    jcfg = jcfg.replace(Mniter=25, mstep_tol=5e-3, use_hessian=use_hessian, learning_rate=1e-3)
    ref = to_np(jv.mstep(jseg, jp, jcfg))
    before = control.TRIPS["mstep_iters"]
    got = tv.mstep(tseg, tp, port_config(jcfg))
    trips = control.TRIPS["mstep_iters"] - before
    assert 2 < trips < 25  # the exit test decided, not the floor of 2 or the cap
    for name in ("a", "b", "noise", "da", "db"):
        assert_close(getattr(got, name), ref[name], atol=1e-12, err_msg=name)
    fixed = to_np(jv.mstep(jseg, jp, jcfg.replace(Mniter=trips, mstep_tol=0.0)))
    fewer = to_np(jv.mstep(jseg, jp, jcfg.replace(Mniter=trips - 1, mstep_tol=0.0)))
    assert_close(fixed["a"], ref["a"], atol=1e-12)
    assert np.max(np.abs(fewer["a"] - ref["a"])) > 1e-9


def _search_problem(T=20, Z=3, seed=1):
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=(Z, 30, T))
    C = np.einsum("zst,zsu->ztu", mu, mu) + np.eye(T)
    C[2] = np.nan  # an all-NaN column of candidates: collapses onto lo
    lo, hi = np.log(np.full(Z, 5e-4)), np.log(np.full(Z, 5e-1))
    return C, 30.0, np.array([1.0, 0.7, 1.3]), 1e-4, 1.0, lo, hi


@pytest.mark.parametrize("polish,profile", [(False, True), (True, True), (True, False)])
def test_hstep_search_plain_matches_jax(polish, profile):
    """_hstep_search_plain against vlgp_tpu's _golden_min over
    gp_elbo_stats, float64: grid 13, 24 golden shrinks, with and without
    polish and the profiled sigma; latent 2's C is NaN, so every candidate
    fails and its x is lo.  The wrapper on CPU tensors is the plain version
    bit for bit."""
    C, nseg, sigsq, gp_noise, dt, lo, hi = _search_problem()
    T = C.shape[-1]

    def jf(x):
        out = jgp.gp_elbo_stats(x, jnp.asarray(C), nseg, T, jnp.asarray(sigsq)[:, None, None],
                                gp_noise, dt, profile_sigma=profile)
        return -(out[0] if profile else out)

    xj = jax.jit(lambda a, b: jgp._golden_min(jf, a, b, 24, polish=polish, grid=13,
                                              tiebreak=1e-4))(jnp.asarray(lo), jnp.asarray(hi))
    args = (torch.tensor(C), torch.tensor(nseg, dtype=torch.float64), torch.tensor(sigsq),
            gp_noise, dt, torch.tensor(lo), torch.tensor(hi), 24)
    xt = og._hstep_search_plain(*args, polish, 13, 1e-4, profile)
    assert_close(xt, np.asarray(xj))
    assert float(xt[2]) == lo[2]
    via = og.hstep_search(*args, polish=polish, grid=13, tiebreak=1e-4, profile_sigma=profile)
    assert torch.equal(via, xt)


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    """The launch paths of mstep_stats, mstep_update and hstep_search raise
    on CPU tensors (the dispatchers give those to the plain versions), on
    dtypes and shapes the kernels do not take, and launch nothing."""
    before = {k: tspd.KERNEL_LAUNCHES[k] for k in ("mstep_stats", "mstep_update",
                                                   "hstep_search")}
    targs = [torch.tensor(t) for t in _mstep_inputs()]
    with pytest.raises(ValueError, match="CUDA"):
        om._mstep_stats_cuda(*targs, True, True)
    with pytest.raises(TypeError, match="float32 or float64"):
        om._mstep_stats_cuda(*[t.half() for t in targs], True, True)
    with pytest.raises(ValueError, match="shape"):
        om.mstep_stats(*targs[:5], targs[5][:, :4], targs[6])
    big = _mstep_inputs(S=2, T=3, Y=2, Z=om.Z_MAX + 1, X=1)
    with pytest.raises(ValueError, match="Z <= 128"):
        om._mstep_stats_cuda(*[torch.tensor(t) for t in big], True, True)
    assert len(om.mstep_stats(*[torch.tensor(t) for t in big])) == 9  # the CPU takes any Z
    stats = om._mstep_stats_plain(*targs, True)
    y, x, mask, mu, v, a, b = targs
    noise = torch.ones(5, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        om._mstep_update_cuda(stats, torch.sum(mask), a, b, noise, None, True, 1e-8, 1.0, 5.0,
                              5.0)
    with pytest.raises(ValueError, match="Partials"):
        om.mstep_update(om.Partials(torch.zeros((2, 5, 40))), torch.sum(mask), a, b, noise)
    C, nseg, sigsq, gp_noise, dt, lo, hi = _search_problem()
    args = [torch.tensor(C), torch.tensor(nseg), torch.tensor(sigsq), gp_noise, dt,
            torch.tensor(lo), torch.tensor(hi), 4]
    with pytest.raises(ValueError, match="CUDA"):
        og._hstep_search_cuda(*args, False, 13, 1e-4, True)
    with pytest.raises(TypeError, match="float32 or float64"):
        og._hstep_search_cuda(args[0].half(), *args[1:], False, 13, 1e-4, True)
    with pytest.raises(ValueError, match="grid"):
        og.hstep_search(*args, grid=og.GRID_MAX + 1)
    with pytest.raises(ValueError, match=r"\(Z, T, T\)"):
        og.hstep_search(args[0][:, :, :5], *args[1:])
    after = {k: tspd.KERNEL_LAUNCHES[k] for k in before}
    assert after == before
