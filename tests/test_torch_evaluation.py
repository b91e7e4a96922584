"""vlgp_tpu_torch.evaluation and vem's ELBO tracking against vlgp_tpu, in
float64 on the CPU: elbo_terms on equal and ragged trials with mixed
Poisson and Gaussian channels, loglik in both forms, and the ELBO series
and its convergence exit on the regression-pin workload."""
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vlgp_tpu
from vlgp_tpu import evaluation as jev
from vlgp_tpu.models.driver import vem as jax_vem
from vlgp_tpu_torch import evaluation as tev
from vlgp_tpu_torch.models.driver import vem

from _torch_parity import (RTOL64, assert_close, pin_state, pin_trials, port_data,
                           port_params, port_result)

torch.set_num_threads(1)

LIKS = ["poisson"] * 7 + ["gaussian"] * 3


def _state(lengths):
    """A posterior state in both packages: the pin trials at ``lengths``,
    mixed likelihoods, the trials' own mu, w and v from update_w/update_v,
    and the same prior factors G."""
    from vlgp_tpu.config import default_config, make_params
    from vlgp_tpu.data import pack_trials
    from vlgp_tpu.models.gp import make_cholesky
    from vlgp_tpu.models.vlgp import update_v, update_w

    trials, a, _ = pin_trials(ntrial=len(lengths))
    for t, L in zip(trials, lengths):
        t["y"], t["mu"] = t["y"][:L], t["mu"][:L]
    config = default_config(dtype="float64")
    params = make_params(10, 2, 1, LIKS, a=a, b=np.full((1, 10), -1.5),
                         noise=np.linspace(0.5, 2.0, 10), omega=np.full(2, 1e-2),
                         dtype=jnp.float64)
    data = pack_trials(trials, 2, 1, dtype=np.float64)
    G = make_cholesky(data.nbin, params)
    data = update_v(update_w(data, params, config), params, G, config)
    return (data, params, G), (port_data(data), port_params(params),
                               torch.tensor(np.asarray(G)))


@pytest.mark.parametrize("lengths", [(120, 120, 120), (120, 90, 120, 60)],
                         ids=["equal", "ragged"])
def test_elbo_terms_f64_matches_jax(lengths):
    """Every term at rtol 1e-8; the ragged state is scored per length bucket."""
    jstate, tstate = _state(lengths)
    jt = jev.elbo_terms(*jstate)
    tt = tev.elbo_terms(*tstate)
    assert set(tt) == set(jt)
    for k in jt:
        assert isinstance(tt[k], float)
        assert np.isclose(tt[k], jt[k], rtol=RTOL64, atol=0.0), (k, tt[k], jt[k])
    assert tt["gaussian_ll"] != 0.0 and tt["poisson_ll"] != 0.0


def test_loglik_both_forms_match_jax():
    """loglik of a FitResult and of a reference-style dict, and
    poisson_loglik on tensors, at rtol 1e-8."""
    (jdata, jparams, jG), _ = _state((120, 90, 120))
    jres = vlgp_tpu.FitResult(data=jdata, params=jparams, config=vlgp_tpu.Config(),
                              factor_model=None, G=jG, runtime={})
    tres = port_result(jres)
    assert np.isclose(tev.loglik(tres), jev.loglik(jres), rtol=RTOL64)

    trials = jres.trials
    for i, t in enumerate(trials):
        t["x"] = t["x"] if i else t["x"][:, :, 0]  # (length, xdim) form too
    jd = {"trials": trials, "params": jparams}
    td = {"trials": trials, "params": tres.params}
    assert np.isclose(tev.loglik(td), jev.loglik(jd), rtol=RTOL64)
    raw = {"a": np.asarray(jparams.a), "b": np.asarray(jparams.b)}
    assert np.isclose(tev.loglik({"trials": trials, "params": raw}), jev.loglik(jd),
                      rtol=RTOL64)

    rng = np.random.default_rng(0)
    y, eta = rng.poisson(1.0, size=(5, 7)).astype(float), rng.normal(size=(5, 7))
    assert np.isclose(float(tev.poisson_loglik(torch.tensor(y), torch.tensor(eta))),
                      float(jev.poisson_loglik(jnp.asarray(y), jnp.asarray(eta))),
                      rtol=RTOL64)


def test_timer_context():
    with tev.timer() as elapsed:
        time.sleep(0.01)
        inside = elapsed()
    after = elapsed()
    assert inside >= 0.01 and after >= inside
    assert elapsed() == after  # frozen once the block ends


def test_vem_track_elbo_series_matches_jax():
    """track_elbo records one ELBO and its terms per EM iteration, after the
    H-step; the series matches vlgp_tpu's at rtol 1e-8 (the two packages
    run the same float64 phases, differing in the order of their sums)."""
    (jseg, jparams, jG, jconfig), (seg, params, G, config) = pin_state(
        "float64", track_elbo=True, max_iter=4)
    *_, jrt = jax_vem(jseg, jparams, jG, jconfig)
    *_, rt = vem(seg, params, G, config)
    assert len(rt["elbo"]) == len(rt["elbo_terms"]) == rt["it"] == 4
    assert_close(np.asarray(rt["elbo"]), np.asarray(jrt["elbo"]), rtol=RTOL64)
    for jt, tt in zip(jrt["elbo_terms"], rt["elbo_terms"]):
        for k in jt:
            assert np.isclose(tt[k], jt[k], rtol=RTOL64), k
    assert rt["elbo"][-1] > rt["elbo"][0]  # EM climbs the bound


def test_vem_elbo_convergence_exit_matches_jax():
    """convergence="elbo" with tol 1e-4 stops before max_iter, at the same
    iteration as vlgp_tpu."""
    (jseg, jparams, jG, jconfig), (seg, params, G, config) = pin_state(
        "float64", convergence="elbo", tol=1e-4, max_iter=12)
    *_, jrt = jax_vem(jseg, jparams, jG, jconfig)
    *_, rt = vem(seg, params, G, config)
    assert rt["converged_at"] == jrt["converged_at"] < 12
    assert rt["it"] == rt["converged_at"] == len(rt["elbo"])
    e = rt["elbo"]
    assert abs(e[-1] - e[-2]) <= 1e-4 * abs(e[-1])
    assert abs(e[-2] - e[-3]) > 1e-4 * abs(e[-2])
