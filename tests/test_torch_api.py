"""vlgp_tpu_torch.transform against vlgp_tpu.transform: new trials under
fitted parameters, in float64 on the CPU, on the regression-pin workload
(4 trials x 120 bins x 10 neurons x 2 latents)."""
import functools

import numpy as np
import pytest
import torch

import vlgp_tpu
import vlgp_tpu_torch

from _torch_parity import (RTOL64, assert_close, factor_models, pin_state, pin_trials,
                           port_config, port_params, port_result)

torch.set_num_threads(1)


@pytest.mark.parametrize("given", ["params", "factor_model", "fit_result"])
def test_transform_f64_matches_jax(given):
    """Bare Params with the trials' own mu; a factor model filling the mu of
    every trial (one trial keeps its own); a FitResult supplying params,
    config and factor model.  Every posterior field at rtol 1e-8."""
    (_, jparams, _, jconfig), _ = pin_state("float64")
    params, config = port_params(jparams), port_config(jconfig)
    trials, _, _ = pin_trials(seed=11, ntrial=3, length=90)
    if given == "params":
        jout = vlgp_tpu.transform(trials, jparams, jconfig)
        tout = vlgp_tpu_torch.transform(trials, params, config, device="cpu")
    else:
        for t in trials[1:]:
            del t["mu"]
        jfm, tfm = factor_models()
        if given == "factor_model":
            jout = vlgp_tpu.transform(trials, jparams, jconfig, factor_model=jfm)
            tout = vlgp_tpu_torch.transform(trials, params, config, factor_model=tfm,
                                            device="cpu")
        else:
            jres = vlgp_tpu.FitResult(data=None, params=jparams, config=jconfig,
                                      factor_model=jfm, G=None, runtime={})
            tres = vlgp_tpu_torch.FitResult(data=None, params=params, config=config,
                                            factor_model=tfm, G=None, runtime={})
            jout = vlgp_tpu.transform(trials, jres)
            tout = vlgp_tpu_torch.transform(trials, tres, device="cpu")
    assert len(tout) == len(trials)
    for i, (jt, tt) in enumerate(zip(jout, tout)):
        assert tt["mu"].shape == (90, 2) and tt["mu"].dtype == np.float64
        for name in ("mu", "w", "v"):
            # rtol 1e-8, and 1e-8 of the field's largest entry near zero
            # crossings (the two packages sum in another order)
            scale = np.abs(np.asarray(jt[name])).max()
            assert_close(tt[name], jt[name], rtol=RTOL64, atol=RTOL64 * scale,
                         err_msg=f"trial {i} {name}")


def test_transform_without_device_needs_cuda(monkeypatch):
    """transform runs on the card unless the caller asks for the CPU: with no
    CUDA device it raises instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, (_, params, _, config) = pin_state("float64")
    trials, _, _ = pin_trials(ntrial=1, length=60)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vlgp_tpu_torch.transform(trials, params, config)


def _posterior_state():
    """A posterior state of the pin trials (f64) in both packages: a
    vlgp_tpu FitResult with w and v from update_w/update_v, and its port."""
    from vlgp_tpu.config import default_config
    from vlgp_tpu.data import pack_trials
    from vlgp_tpu.models.gp import make_cholesky
    from vlgp_tpu.models.vlgp import update_v, update_w

    (_, jparams, _, _), _ = pin_state("float64")
    jconfig = default_config(dtype="float64", seed=5)
    trials, _, _ = pin_trials(ntrial=2, length=80)
    data = pack_trials(trials, 2, 1, dtype=np.float64)
    G = make_cholesky(data.nbin, jparams)
    data = update_v(update_w(data, jparams, jconfig), jparams, G, jconfig)
    jres = vlgp_tpu.FitResult(data=data, params=jparams, config=jconfig, factor_model=None,
                              G=G, runtime={})
    return jres, port_result(jres)


def test_posterior_cov_f64_matches_jax():
    """models.gp.posterior_cov against vlgp_tpu's at rtol 1e-8, one latent
    at a time and batched over latents."""
    from vlgp_tpu.models.gp import posterior_cov as jax_posterior_cov
    from vlgp_tpu_torch.models.gp import posterior_cov

    jres, tres = _posterior_state()
    G, w = tres.G, tres.data.w[0].T  # (z, T, r), (z, T)
    batched = posterior_cov(w, G, 1e-6)
    for l in range(G.shape[0]):
        ref = jax_posterior_cov(jres.data.w[0, :, l], jres.G[l], 1e-6)
        scale = np.abs(np.asarray(ref)).max()
        assert_close(posterior_cov(w[l], G[l], 1e-6), ref, atol=RTOL64 * scale)
        assert_close(batched[l], ref, atol=RTOL64 * scale)


@pytest.mark.parametrize("method", ["lowrank", "dense"])
def test_sample_posterior_moments(method):
    """Both call forms: the sample mean lies within 5 standard errors of mu
    and the sample covariance within 5 standard errors of the dense
    posterior covariance, at every bin; a generator seeded from
    config.seed (FitResult) or 0 (trial dict) is the default."""
    from vlgp_tpu_torch.models.gp import posterior_cov

    _, tres = _posterior_state()
    n = 4000
    s = vlgp_tpu_torch.sample_posterior(tres, 1, n, method=method)
    assert s.shape == (n, 80, 2) and s.dtype == torch.float64
    gen = torch.Generator().manual_seed(tres.config.seed)
    assert torch.equal(s, vlgp_tpu_torch.sample_posterior(tres, 1, n, generator=gen,
                                                          method=method))
    S = posterior_cov(tres.data.w[1].T, tres.G, 0.0)  # (z, T, T)
    for l in range(2):
        x = s[:, :, l]
        sd = torch.sqrt(torch.diagonal(S[l]))
        assert (torch.abs(x.mean(0) - tres.data.mu[1, :, l]) <= 5 * sd / n ** 0.5).all()
        cov = torch.cov(x.T)
        se = torch.sqrt((sd[:, None] ** 2 * sd[None] ** 2 + S[l] ** 2) / n)
        assert (torch.abs(cov - S[l]) <= 5 * se + 1e-6).all()

    trials = tres.trials
    raw = vlgp_tpu_torch.sample_posterior(trials[0], tres.params, nsample=n, method=method)
    again = vlgp_tpu_torch.sample_posterior(trials[0], tres.params, n,
                                            generator=torch.Generator().manual_seed(0),
                                            method=method)
    assert raw.shape == (n, 80, 2) and torch.equal(raw, again)
    sd = torch.sqrt(torch.diagonal(posterior_cov(tres.data.w[0].T, tres.G, 0.0), dim1=1, dim2=2))
    assert (torch.abs(raw.mean(0) - tres.data.mu[0]) <= 5 * sd.T / n ** 0.5).all()
    with pytest.raises(TypeError):
        vlgp_tpu_torch.sample_posterior(tres, 0)


@functools.lru_cache(maxsize=None)
def _jax_map2vi():
    """vlgp_tpu.map2vi on the pin trials from a GPFA-style (C, d), with the
    noise and every trial's mu given: no factor-analysis draw happens."""
    trials, a, _ = pin_trials()
    return vlgp_tpu.map2vi(trials, a, np.full(10, np.exp(-1.5)), **_MAP2VI_KW)


_MAP2VI_KW = dict(noise=np.ones(10), max_iter=3, dtype="float64")


def _assert_fit_close(tres, jres):
    # the f64 fits agree at rtol 1e-6: both run the same phases, but the
    # H-step's golden-section search turns summation-order differences of
    # 1e-15 into omega differences of ~1e-9 that the next E-steps carry
    assert_close(tres.data.mu, jres.data.mu, rtol=1e-6, atol=1e-10)
    for name in ("a", "b", "omega", "sigma"):
        assert_close(getattr(tres.params, name), getattr(jres.params, name), rtol=1e-6,
                     err_msg=name)


def test_map2vi_f64_matches_jax():
    trials, a, _ = pin_trials()
    tres = vlgp_tpu_torch.map2vi(trials, a, np.full(10, np.exp(-1.5)), device="cpu",
                                 **_MAP2VI_KW)
    jres = _jax_map2vi()
    assert tres.runtime["it"] == jres.runtime["it"] == 3
    _assert_fit_close(tres, jres)


def test_resume_f64_matches_jax():
    """resume (infer -> M-step -> infer) from the same FitResult state."""
    jres = vlgp_tpu.resume(_jax_map2vi(), max_iter=4)
    tres = vlgp_tpu_torch.resume(port_result(_jax_map2vi()), max_iter=4)
    assert tres.config.max_iter == 4
    for name in ("mu", "w", "v"):
        ref = getattr(jres.data, name)
        assert_close(getattr(tres.data, name), ref, atol=RTOL64 * np.abs(ref).max(),
                     err_msg=name)
    for name in ("a", "b", "noise"):
        assert_close(getattr(tres.params, name), getattr(jres.params, name), err_msg=name)


def _entry_points():
    from vlgp_tpu_torch import model_selection, simulation
    from vlgp_tpu_torch.models import gpfa

    trials, a, _ = pin_trials(ntrial=1, length=60)
    x, b = np.zeros((60, 2)), np.zeros((1, 10))
    return {
        "map2vi": lambda: vlgp_tpu_torch.map2vi(trials, a, np.ones(10)),
        "fastfit": lambda: vlgp_tpu_torch.fastfit(trials, 2, 1.0, 1.0, 5.0),
        "gpfa.fit": lambda: gpfa.fit(trials, 2, dt=1.0, var=1.0, scale=5.0),
        "gpfa.prepare": lambda: gpfa.prepare(trials, 2, dt=1.0, var=1.0, scale=5.0),
        "gpfa.make_prior": lambda: gpfa.make_prior(50, 1.0, 1.0, 5.0),
        "gmap_speckled_cv": lambda: model_selection.gmap_speckled_cv(
            trials, [2], dt=1.0, var=1.0, scale=5.0, max_iter=2),
        "spike": lambda: simulation.spike(x, a, b, None),
        "lfp": lambda: simulation.lfp(x, a, b, np.eye(10), None),
        "lorenz": lambda: simulation.lorenz(10),
    }


@pytest.mark.parametrize("name", ["map2vi", "fastfit", "gpfa.fit", "gpfa.prepare",
                                  "gpfa.make_prior", "gmap_speckled_cv", "spike", "lfp",
                                  "lorenz"])
def test_new_entry_points_without_device_need_cuda(monkeypatch, name):
    """Each entry point that takes trials, arrays or sizes runs on the card
    unless the caller asks for the CPU: with no CUDA device it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()
