"""vlgp_tpu_torch.models.gpfa against vlgp_tpu.models.gpfa in float64 on
the CPU: every deterministic function from the same inputs at rtol 1e-8,
prepare's shapes, and the standalone fit's recovery on ragged trials (its
factor-analysis start draws from a torch generator, so quality is
compared, not bits)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vlgp_tpu.models import gpfa as jgpfa
from vlgp_tpu_torch.models import gpfa
from vlgp_tpu_torch.utils.convert import gpfa_from_numpy

from _torch_parity import RTOL64, assert_close, r2_aligned

torch.set_num_threads(1)


def _problem(seed=0, m=4, n=25, ydim=6, zdim=2):
    """GPFA inputs (y, C, d, R, K) as NumPy: SE latents seen through a
    loading with per-channel noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=float)
    K = np.exp(-0.5 * ((t[:, None] - t) / 5.0) ** 2) + 1e-6 * np.eye(n)
    z = np.einsum("tu,muz->mtz", np.linalg.cholesky(K), rng.normal(size=(m, n, zdim)))
    C = rng.normal(size=(zdim, ydim))
    y = np.einsum("mtz,zy->mty", z, C) + 0.3 + rng.normal(size=(m, n, ydim)) * 0.3
    R = np.abs(rng.normal(size=ydim)) + 0.3
    return y, C * 0.5, rng.normal(size=ydim) * 0.1, R, K


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.tensor(a) for a in arrays]


def _close(port, ref, err_msg=""):
    # rtol 1e-8, with an atol of 1e-8 of the field's largest entry for
    # entries near zero (the packages sum in another order)
    ref = np.asarray(ref)
    assert_close(port, ref, rtol=RTOL64, atol=RTOL64 * np.abs(ref).max(), err_msg=err_msg)


def test_estep_and_infer_match_jax():
    y, C, d, R, K = _problem()
    j, t = _both(y, C, d, R, K)
    _close(gpfa._latent_space_estep(*t), jgpfa._latent_space_estep(*j))
    _close(gpfa.infer(*t), jgpfa.infer(*j))


def test_leastsq_matches_jax():
    rng = np.random.default_rng(1)
    Z, Y = rng.normal(size=(200, 3)), rng.normal(size=(200, 6))
    for p, r, name in zip(gpfa.leastsq(torch.tensor(Y), torch.tensor(Z)),
                          jgpfa.leastsq(jnp.asarray(Y), jnp.asarray(Z)), ("C", "d", "var")):
        _close(p, r, name)


@pytest.mark.parametrize("R_form", ["diag", "dense"])
def test_em_step_and_em_match_jax(R_form):
    """One em_step, and em over 6 iterations from the same C0, d0, R0 (the
    (ydim,) diagonal or a (ydim, ydim) matrix), through convert.gpfa_from_numpy."""
    y, C, d, R, K = _problem(seed=2)
    j, t = _both(y, C, d, R, K)
    for p, r, name in zip(gpfa.em_step(*t), jgpfa.em_step(*j), ("z", "C", "d", "R")):
        _close(p, r, name)
    R0 = np.diag(R) if R_form == "dense" else R
    C0, d0, R0t, Kt = gpfa_from_numpy(C, d, R0, K)
    out = gpfa.em(torch.tensor(y), C0, d0, R0t, Kt, max_iter=6)
    ref = jgpfa.em(jnp.asarray(y), j[1], j[2], jnp.asarray(R0), j[4], max_iter=6)
    for p, r, name in zip(out, ref, ("z", "C", "d", "R")):
        _close(p, r, name)


def test_make_prior_and_loglik_match_jax():
    """vlgp_tpu's sekernel computes in float32 whatever its input (its
    ``jnp.result_type(x, jnp.float32)``), so make_prior is compared in
    float32, at 2 float32 ulps of its largest entry, and the port's float64
    loglik against vlgp_tpu's (float32 prior) at rtol 1e-6 on a
    well-conditioned prior (scale 0.7 bins), where the float32 rounding of
    K moves the K^-1 quadratic by ~1e-7 relative."""
    ref = jgpfa.make_prior(30, 0.5, 1.3, 4.0)
    K = gpfa.make_prior(30, 0.5, 1.3, 4.0, device="cpu")
    assert K.dtype == torch.float32 and ref.dtype == jnp.float32
    assert_close(K, ref, rtol=0.0, atol=2 * 2.0 ** -23 * 1.3)
    y, C, d, R, _ = _problem(seed=3, m=2, n=10, ydim=4)
    z = np.random.default_rng(3).normal(size=(2, 10, 2))
    j, t = _both(y, z, C, d, R)
    ll = gpfa.loglik(*t, 1.0, 0.7, 1.0)
    assert ll.dtype == torch.float64
    assert np.isclose(float(ll), float(jgpfa.loglik(*j, 1.0, 0.7, 1.0)), rtol=1e-6)


def test_prepare_shapes():
    """prepare returns the reference's (y, C, d, R, K) tuple on the segment
    grid, on the requested device and in the config's dtype."""
    rng = np.random.default_rng(5)
    trials = [{"y": rng.poisson(1.0, size=(70, 8)).astype(float)} for _ in range(3)]
    y, C, d, R, K = gpfa.prepare(trials, 2, dt=1.0, var=1.0, scale=5.0, window=35,
                                 device="cpu", dtype="float64")
    assert y.ndim == 3 and y.shape[1:] == (35, 8)
    assert C.shape == (2, 8) and d.shape == (8,) and R.shape == (8,) and K.shape == (35, 35)
    assert all(t.dtype == torch.float64 and t.device.type == "cpu" for t in (y, C, d, R, K))
    # vlgp_tpu's prior is float32 (see test_make_prior_and_loglik_match_jax)
    assert_close(K, jgpfa.make_prior(35, 1.0, 1.0, 5.0), rtol=0.0, atol=2 * 2.0 ** -23)


def test_fit_recovers_latents_ragged():
    """The standalone fit on linear-Gaussian data with SE latents and
    unequal trial lengths: the full-length posterior written back into the
    trials recovers the latents (R^2 > 0.8, the JAX package's floor in
    tests/test_gpfa.py)."""
    rng = np.random.default_rng(6)
    zdim, ydim, scale = 2, 15, 8.0
    C_true, d_true = rng.normal(size=(zdim, ydim)), rng.normal(size=ydim) * 0.3
    trials, z_all = [], []
    for L in (100, 100, 80, 100, 60):
        t = np.arange(L, dtype=float)
        K = np.exp(-0.5 * ((t[:, None] - t) / scale) ** 2) + 1e-6 * np.eye(L)
        z = np.linalg.cholesky(K) @ rng.normal(size=(L, zdim))
        trials.append({"y": z @ C_true + d_true + rng.normal(size=(L, ydim)) * 0.2})
        z_all.append(z)
    res = gpfa.fit(trials, zdim, dt=1.0, var=1.0, scale=scale, max_iter=30, window=50,
                   device="cpu", dtype="float64")
    assert res.runtime["it"] == len(res.runtime["em_elapsed"]) == 30
    mu = np.concatenate([t["mu"] for t in res.trials])
    zt = np.concatenate(z_all)
    assert mu.shape == zt.shape
    assert r2_aligned(mu, zt) > 0.8
    assert res["params"]["C"].shape == (zdim, ydim) and len(res["trials"]) == len(trials)
    assert np.all(res.trials[4]["mu"].shape == (60, zdim))
