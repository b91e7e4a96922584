"""Port parity, float64, phase by phase: estep (fixed count and adaptive
exit), mstep, update_w, update_v, constrain_loading / constrain_latent,
em_norms and hstep, on identical inputs in both packages (rtol 1e-8:
both run the exact LAPACK route and differ only in the order of sums)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from vlgp_tpu.models import gp as jgp
from vlgp_tpu.models import vlgp as jv
from vlgp_tpu_torch.models import gp as tgp
from vlgp_tpu_torch.models import vlgp as tv

from _torch_parity import assert_close, pin_state, port_config, to_np

torch.set_num_threads(1)

_DATA_FIELDS = ("mu", "w", "v", "dmu")

# the JAX phases jitted (one compile each instead of op-by-op dispatch)
j_estep = jax.jit(jv.estep, static_argnames=("config", "niter", "dist", "return_xinv"))
j_hstep = jax.jit(jgp.hstep, static_argnames=("config", "dist", "rank"))


@pytest.fixture(scope="module")
def state():
    """The pin workload after one E-step in each package, so that w, v and
    mu are all non-trivial inputs for the later phases."""
    (jseg, jp, jG, jcfg), (tseg, tp, tG, tcfg) = pin_state()
    jseg, jx = j_estep(jseg, jp, jG, jcfg, niter=3, return_xinv=True)
    tseg, tx = tv.estep(tseg, tp, tG, tcfg, niter=3, return_xinv=True)
    for name in _DATA_FIELDS:
        assert_close(getattr(tseg, name), np.asarray(getattr(jseg, name)), err_msg=name)
    return (jseg, jp, jG, jcfg, jx), (tseg, tp, tG, tcfg, tx)


def _close_data(tdata, jdata):
    for name in _DATA_FIELDS:
        assert_close(getattr(tdata, name), np.asarray(getattr(jdata, name)), atol=1e-13,
                     err_msg=name)


def _close_params(tparams, jparams, names=("a", "b", "noise", "sigma", "omega", "da", "db")):
    ref = to_np(jparams)
    for name in names:
        assert_close(getattr(tparams, name), ref[name], atol=1e-13, err_msg=name)


@pytest.mark.parametrize("estep_tol,niter", [(0.0, 4), (3e-3, 25)])
def test_estep_matches(state, estep_tol, niter):
    """Fixed sweep count and the adaptive exit, warm-started from the
    carried inverse, returning the final inverse."""
    (jseg, jp, jG, jcfg, jx), (tseg, tp, tG, tcfg, tx) = state
    jcfg = jcfg.replace(estep_tol=estep_tol)
    tcfg = port_config(jcfg)
    jd, jX = j_estep(jseg, jp, jG, jcfg, niter=niter, xinv=jx, return_xinv=True)
    td, tX = tv.estep(tseg, tp, tG, tcfg, niter=niter, xinv=tx, return_xinv=True)
    _close_data(td, jd)
    assert_close(tX, np.asarray(jX), atol=1e-13)


def test_estep_map_method(state):
    (jseg, jp, jG, jcfg, _), (tseg, tp, tG, tcfg, _) = state
    jcfg = jcfg.replace(method="MAP", estep_tol=0.0)
    _close_data(tv.estep(tseg, tp, tG, port_config(jcfg), niter=3),
                j_estep(jseg, jp, jG, jcfg, niter=3))


@pytest.mark.parametrize("kw", [{}, {"mstep_tol": 0.0, "Mniter": 4},
                                {"use_hessian": False, "Mniter": 3}])
def test_mstep_matches(state, kw):
    (jseg, jp, jG, jcfg, _), (tseg, tp, tG, tcfg, _) = state
    jcfg = jcfg.replace(**kw)
    _close_params(tv.mstep(tseg, tp, port_config(jcfg)), jv.mstep(jseg, jp, jcfg))


def test_mstep_mixed_likelihood_and_active_mask(state):
    """Gaussian closed form next to Poisson Newton, and inert channels."""
    (jseg, jp, _, jcfg, _), (tseg, tp, _, tcfg, _) = state
    pois = np.arange(10) % 3 != 0
    act = np.arange(10) != 4
    jp = jp.replace(poisson=pois, active=act, likelihood_kind="mixed")
    tp = tp.replace(poisson=torch.tensor(pois), active=torch.tensor(act),
                    likelihood_kind="mixed")
    jcfg = jcfg.replace(Mniter=3, mstep_tol=0.0)
    _close_params(tv.mstep(tseg, tp, port_config(jcfg)), jv.mstep(jseg, jp, jcfg))


def test_update_w_and_update_v_match(state):
    (jseg, jp, jG, jcfg, _), (tseg, tp, tG, tcfg, _) = state
    _close_data(tv.update_w(tseg, tp, tcfg), jv.update_w(jseg, jp, jcfg))
    _close_data(tv.update_v(tseg, tp, tG, tcfg), jv.update_v(jseg, jp, jG, jcfg))


@pytest.mark.parametrize("loading,latent", [("fro", "none"), ("svd", "both"),
                                            ("1", "location"), (2, "scale")])
def test_constraints_and_norms_match(state, loading, latent):
    (jseg, jp, _, jcfg, _), (tseg, tp, _, tcfg, _) = state
    jcfg = jcfg.replace(constrain_loading=loading, constrain_latent=latent)
    tcfg = port_config(jcfg)
    jd, jpp = jv.constrain_loading(jseg, jp, jcfg)
    td, tpp = tv.constrain_loading(tseg, tp, tcfg)
    if loading == "svd":
        # singular vectors are defined up to sign: align the port's rows
        sign = torch.sign(torch.sum(tpp.a * torch.tensor(np.asarray(jpp.a)), dim=1))
        td, tpp = td.replace(mu=td.mu * sign), tpp.replace(a=tpp.a * sign[:, None])
    jd, jpp = jv.constrain_latent(jd, jpp, jcfg)
    td, tpp = tv.constrain_latent(td, tpp, tcfg)
    _close_data(td, jd)
    _close_params(tpp, jpp, names=("a", "b"))
    jn, tn = jv.em_norms(jd, jpp), tv.em_norms(td, tpp)
    assert set(tn) == set(jn)
    for k in jn:
        assert_close(tn[k], np.asarray(jn[k]), err_msg=k)


@pytest.mark.parametrize("kw", [{}, {"hyper_refines": 3, "hyper_learn_sigma": False,
                                     "hyper_window": 1.0}])
def test_hstep_matches(state, kw):
    """omega and sigma after the Aitken-extrapolated H-step, warm-started
    from the E-step's carried inverse.  (hyper_polish is checked on the
    standalone search below: its parabola vertex divides differences of
    nearly equal objective values, which turns 1e-15 noise into ~1e-6.)"""
    (jseg, jp, jG, jcfg, jx), (tseg, tp, tG, tcfg, tx) = state
    jcfg = jcfg.replace(**kw)
    rank = jG.shape[-1]
    jpp = j_hstep(jseg, jp, jcfg, rank=rank, xinv=jx)
    tpp = tgp.hstep(tseg, tp, port_config(jcfg), rank=rank, xinv=tx)
    _close_params(tpp, jpp, names=("omega", "sigma"))
    assert not np.allclose(np.asarray(jpp.omega), np.asarray(jp.omega))  # it moved


def test_gp_elbo_stats_and_golden_min_match():
    """The H-step objective and its bounded search, standalone, including
    a candidate whose Cholesky fails (NaN must lose, not poison)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    T, Z = 20, 2
    mu = rng.normal(size=(Z, 30, T))
    C = np.einsum("zst,zsu->ztu", mu, mu) + np.eye(T)
    lo, hi = np.log(np.full(Z, 5e-4)), np.log(np.full(Z, 5e-2))
    for profile in (False, True):
        def jf(x):
            out = jgp.gp_elbo_stats(x, jnp.asarray(C), 30.0, T, 1.0, 1e-4, 1.0,
                                    profile_sigma=profile)
            return -(out[0] if profile else out)

        def tf(x):
            out = tgp.gp_elbo_stats(x, torch.tensor(C), torch.tensor(30.0), T, 1.0, 1e-4,
                                    1.0, profile_sigma=profile)
            return -(out[0] if profile else out)

        xj = jax.jit(lambda a, b: jgp._golden_min(jf, a, b, 12, polish=True, grid=7))(
            jnp.asarray(lo), jnp.asarray(hi))
        xt = tgp._golden_min(tf, torch.tensor(lo), torch.tensor(hi), 12, polish=True, grid=7)
        assert_close(xt, np.asarray(xj))
    # gp_noise -1 makes every K indefinite: the Cholesky fails, f is NaN
    bad = tgp.gp_elbo_stats(torch.tensor(lo), torch.tensor(C), 30.0, T, 1.0, -1.0, 1.0)
    assert torch.isnan(bad).all()
    out = tgp._golden_min(lambda x: tgp.gp_elbo_stats(x, torch.tensor(C), 30.0, T, 1.0,
                                                      -1.0, 1.0),
                          torch.tensor(lo), torch.tensor(hi), 4, grid=5)
    assert torch.equal(out, torch.tensor(lo))  # all-NaN column: collapse to lo


def test_effective_config_is_plain_dataclass():
    """port_config carries every field (the tests' Config bridge)."""
    (_, _, _, jcfg), (_, _, _, tcfg) = pin_state()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
