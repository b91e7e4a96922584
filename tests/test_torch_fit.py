"""The port's slice as a whole: vlgp_tpu_torch.fit against vlgp_tpu.fit on
the regression-pin workload (4 trials x 120 bins x 10 neurons x 2 latents),
and the pinned float64 EM trajectory through the port's make_em_step."""
import functools

import numpy as np
import pytest
import torch

import vlgp_tpu
import vlgp_tpu_torch
from vlgp_tpu_torch.models import vlgp as tv
from vlgp_tpu_torch.models.driver import make_em_step
from vlgp_tpu_torch.ops import spd as tspd

from _torch_parity import np_of, pin_state, pin_trials, r2_aligned
from test_regression_pin import PINNED, PINNED_CADENCE

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _jax_fit(dtype, max_iter):
    """vlgp_tpu.fit on the pin workload, computed once per module."""
    trials, a, _ = pin_trials()
    return vlgp_tpu.fit(trials, 2, **_fit_kw(a, dtype, max_iter))


def _fit_kw(a, dtype, max_iter):
    # a, b, noise and every trial's mu are given: no random draw happens
    return dict(a=a, b=np.full((1, 10), -1.5), noise=np.ones(10), max_iter=max_iter,
                dtype=dtype)


def _fit_both(dtype, max_iter=3):
    trials, a, zt = pin_trials()
    return (_jax_fit(dtype, max_iter),
            vlgp_tpu_torch.fit(trials, 2, device="cpu", **_fit_kw(a, dtype, max_iter)),
            zt, trials)


def test_fit_f64_matches_jax():
    jr, tr, _, trials = _fit_both("float64")
    assert tr.data.mu.dtype == torch.float64
    np.testing.assert_allclose(np_of(tr.data.mu), np.asarray(jr.data.mu), rtol=1e-6,
                               atol=1e-10)
    for name in ("a", "b", "omega", "sigma"):
        np.testing.assert_allclose(np_of(getattr(tr.params, name)),
                                   np.asarray(getattr(jr.params, name)), rtol=1e-6,
                                   err_msg=name)
    assert tr.runtime["it"] == jr.runtime["it"] == 3
    assert tr.runtime.get("final_hstep") == jr.runtime.get("final_hstep")
    # the result object: reference-style trial dicts, dict-style access
    out = tr["trials"]
    assert len(out) == len(trials) and out[0]["mu"].shape == (120, 2)
    assert tr["params"] is tr.params and tr["config"] is tr.config


def test_fit_window_none_f64_matches_jax():
    """window=None: whole trials (160 bins), no cutting, so the H-step
    searches omega on the full trial length.  The port against
    vlgp_tpu.fit in float64, a, b and noise given, 3 EM iterations."""
    trials, a, _ = pin_trials(length=160)
    kw = dict(_fit_kw(a, "float64", 3), window=None)
    jr = vlgp_tpu.fit(trials, 2, **kw)
    tr = vlgp_tpu_torch.fit(trials, 2, device="cpu", **kw)
    assert tr.runtime["it"] == jr.runtime["it"] == 3
    np.testing.assert_allclose(np_of(tr.data.mu), np.asarray(jr.data.mu), rtol=1e-8,
                               atol=1e-12)
    for name in ("a", "b", "omega", "sigma"):
        np.testing.assert_allclose(np_of(getattr(tr.params, name)),
                                   np.asarray(getattr(jr.params, name)), rtol=1e-8,
                                   err_msg=name)


def test_fit_f32_quality_matches_jax():
    """float32: the port runs its Newton-Schulz route (the kernels' plain
    versions on the CPU), JAX its exact route, so quality is compared:
    lstsq-aligned recovery R^2 within 0.01."""
    tspd.reset_counters()
    jr, tr, zt, _ = _fit_both("float32")
    assert tr.data.mu.dtype == torch.float32
    assert tspd.ROUTE_CALLS["gram"] > 0 and tspd.ROUTE_CALLS["packed"] > 0
    r2j = r2_aligned(np.asarray(jr.data.mu).reshape(-1, 2), zt)
    r2t = r2_aligned(np_of(tr.data.mu).reshape(-1, 2), zt)
    assert np.isfinite(np_of(tr.data.mu)).all()
    assert abs(r2t - r2j) < 0.01, (r2t, r2j)


def test_fit_f32_fused_sweep_quality(monkeypatch):
    """float32 with the fused E-step sweep (the sweep kernel's plain version
    on the CPU): every EM iteration's E-step and the final full-length
    inference (T = 120 is eligible here) go through ``sweep`` with no
    fallback, and recovery stays within 0.01 of the JAX fit."""
    monkeypatch.setattr(tv, "_SWEEP_FUSED", True)
    tspd.reset_counters()
    jr, tr, zt, _ = _fit_both("float32")
    assert tspd.ROUTE_CALLS["sweep"] == tr.runtime["it"] + 1
    assert tspd.FALLBACKS["sweep_core"] == 0
    r2j = r2_aligned(np.asarray(jr.data.mu).reshape(-1, 2), zt)
    r2t = r2_aligned(np_of(tr.data.mu).reshape(-1, 2), zt)
    assert abs(r2t - r2j) < 0.01, (r2t, r2j)


def test_fit_without_device_needs_cuda(monkeypatch):
    """fit runs on the card unless the caller asks for the CPU: with no CUDA
    device it raises instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trials, a, _ = pin_trials(ntrial=1, length=60)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vlgp_tpu_torch.fit(trials, 2, a=a)


@pytest.mark.parametrize("cadence", [False, True])
def test_em_trajectory_pinned(cadence):
    """PINNED / PINNED_CADENCE of tests/test_regression_pin.py, at its
    tolerances, through the port's make_em_step; a skipped H-step carries
    omega and sigma bit for bit."""
    _, (seg, params, G, config) = pin_state()
    em = make_em_step(config)
    pins = PINNED_CADENCE if cadence else PINNED
    prev = None
    for it in ((0, 1, 2) if cadence else (1, 2, 3)):
        seg, params, G, norms = em(seg, params, G, it=it if cadence else None)
        pin = pins[it]
        assert np.isclose(float(norms["mu"]), pin["mu"], rtol=1e-5), (it, norms)
        assert np.isclose(float(norms["a"]), pin["a"], rtol=1e-5), (it, norms)
        om, sg = np_of(params.omega), np_of(params.sigma)
        if cadence and it == 1:
            np.testing.assert_array_equal(om, prev[0])
            np.testing.assert_array_equal(sg, prev[1])
        if "omega" in pin:
            assert np.allclose(om, pin["omega"], rtol=1e-4), (it, om)
        if "sigma" in pin:
            assert np.allclose(sg, pin["sigma"], rtol=1e-5), (it, sg)
        prev = (om, sg)


def test_unported_modes_raise(tmp_path):
    """fused and block > 1 run (models.driver; on the CPU the eager step,
    so the fit equals the default one bit for bit), and path writes the
    parameter snapshot to <path>.npz."""
    from vlgp_tpu_torch.utils.io import load_params

    trials, a, _ = pin_trials(ntrial=1, length=60)
    ref = vlgp_tpu_torch.fit(trials, 2, a=a, device="cpu", max_iter=4)
    for kw in ({"fused": True}, {"block": 4}):
        got = vlgp_tpu_torch.fit(trials, 2, a=a, device="cpu", max_iter=4, **kw)
        assert torch.equal(got.params.a, ref.params.a) and torch.equal(got.data.mu, ref.data.mu)
    res = vlgp_tpu_torch.fit(trials, 2, a=a, device="cpu", max_iter=2,
                             path=str(tmp_path / "ckpt"))
    snap = load_params(tmp_path / "ckpt.npz", device="cpu")
    assert torch.equal(snap.a, res.params.a) and torch.equal(snap.omega, res.params.omega)


def test_fit_initializes_from_factor_analysis():
    """No a/b/noise given: the factor-analysis initializer draws its
    subsample from a seeded torch.Generator, deterministically."""
    trials, _, zt = pin_trials()
    for t in trials:
        del t["mu"]
    r1 = vlgp_tpu_torch.fit(trials, 2, max_iter=2, device="cpu", dtype="float64")
    r2 = vlgp_tpu_torch.fit(trials, 2, max_iter=2, device="cpu", dtype="float64")
    assert r1.factor_model is not None
    assert torch.equal(r1.data.mu, r2.data.mu)
    assert np.isfinite(np_of(r1.data.mu)).all()
    assert r2_aligned(np_of(r1.data.mu).reshape(-1, 2), zt) > 0.5


def test_subsample_draw_valid_rows_and_reproducible():
    """The factor-analysis subsample takes only rows where the mask is set,
    uniformly, and the same rows from the same seed."""
    from vlgp_tpu_torch.init import _subsample_rows

    mask = torch.zeros(120)
    mask[10:40] = 1.0
    mask[70:90] = 1.0

    def rows(seed, k=50000):
        return _subsample_rows(mask, k, torch.Generator().manual_seed(seed))

    idx = rows(0)
    assert bool((mask[idx] == 1.0).all())
    counts = torch.bincount(idx, minlength=120)[mask > 0]
    # 1000 expected per valid row, binomial sd ~31
    assert int(counts.min()) > 850 and int(counts.max()) < 1150
    assert torch.equal(idx, rows(0)) and not torch.equal(idx, rows(1))
