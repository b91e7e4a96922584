"""vlgp_tpu_torch.simulation against vlgp_tpu.simulation on the CPU:
lorenz step for step in float64; spike and lfp at lag 0 give vlgp_tpu's
rate / mean exactly and observations of the right law (the draws come
from a torch generator); at lag > 0 the history is checked against the
observations it records."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vlgp_tpu import simulation as jsim
from vlgp_tpu_torch import simulation as tsim

from _torch_parity import RTOL64, assert_close

torch.set_num_threads(1)


@pytest.mark.parametrize("normalized", [False, True])
def test_lorenz_matches_jax(normalized):
    """The Euler trajectory from the default and a given start, step for
    step at rtol 1e-8 (the same float64 operations in the same order)."""
    for x0 in (None, (1.0, -2.0, 20.0)):
        ref = np.asarray(jsim.lorenz(400, x0=x0, normalized=normalized))
        xs = tsim.lorenz(400, x0=x0, normalized=normalized, device="cpu")
        assert xs.shape == (400, 3) and xs.dtype == torch.float64
        assert_close(xs, ref, rtol=RTOL64, atol=RTOL64 * np.abs(ref).max())


def _inputs(lag, ntrial=40, ntime=60, zdim=2, ydim=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(ntrial, ntime, zdim)) * 0.5
    a = rng.normal(size=(zdim, ydim)) * 0.3
    b = np.zeros((1 + lag, ydim))
    b[0] = -1.0
    if lag:
        b[1:] = -0.5  # refractory history
    return x, a, b


def test_spike_lag0_rate_matches_jax_and_draws_follow_it():
    """rate = trunc_exp(z @ a + b0) exactly as vlgp_tpu's; y in {0, 1} with
    P(y = 1) = 1 - exp(-rate) (a Poisson count clipped at 1), within 5
    standard errors over the 2400 draws of each channel."""
    x, a, b = _inputs(0)
    jy, jh, jrate = jsim.spike(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b),
                               jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    y, h, rate = tsim.spike(torch.tensor(x), a, b, gen)
    assert y.shape == rate.shape == (40, 60, 6) and h.shape == (6, 40, 60, 1)
    assert_close(rate, np.asarray(jrate), rtol=RTOL64)
    assert_close(h, np.asarray(jh), rtol=0.0)
    assert set(torch.unique(y).tolist()) <= {0.0, 1.0}
    p = 1 - torch.exp(-rate)
    n = y.shape[0] * y.shape[1]
    se = torch.sqrt((p * (1 - p)).sum((0, 1))) / n
    assert (torch.abs(y.mean((0, 1)) - p.mean((0, 1))) <= 5 * se).all()


def test_lfp_lag0_mean_matches_jax_and_noise_has_covariance_K():
    x, a, b = _inputs(0, ntrial=60)
    rng = np.random.default_rng(1)
    M = rng.normal(size=(6, 6)) * 0.2
    K = M @ M.T + 0.1 * np.eye(6)
    _, jh, jmean = jsim.lfp(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), jnp.asarray(K),
                            jax.random.PRNGKey(1))
    y, h, mean = tsim.lfp(torch.tensor(x), a, b, K, torch.Generator().manual_seed(1))
    assert y.shape == mean.shape == (60, 60, 6) and h.shape == (6, 60, 60, 1)
    assert_close(mean, np.asarray(jmean), rtol=RTOL64)
    assert_close(h, np.asarray(jh), rtol=0.0)
    resid = (y - mean).reshape(-1, 6)
    n = resid.shape[0]
    cov = resid.T @ resid / n
    Kt = torch.tensor(K)
    se = torch.sqrt((torch.diagonal(Kt)[:, None] * torch.diagonal(Kt)[None] + Kt ** 2) / n)
    assert (torch.abs(cov - Kt) <= 5 * se).all()
    assert (torch.abs(resid.mean(0)) <= 5 * torch.sqrt(torch.diagonal(Kt) / n)).all()


@pytest.mark.parametrize("kind", ["spike", "lfp"])
def test_history_is_consistent(kind):
    """At lag 2: column 0 of the history is the constant 1, column k the
    observations k bins back (zero before the trial starts), and the rate /
    mean is the link of z @ a + history * b."""
    lag = 2
    x, a, b = _inputs(lag, ntrial=5)
    gen = torch.Generator().manual_seed(2)
    if kind == "spike":
        y, h, m = tsim.spike(torch.tensor(x), a, b, gen)
        link = lambda e: torch.exp(torch.clamp(e, max=10.0))  # noqa: E731
    else:
        y, h, m = tsim.lfp(torch.tensor(x), a, b, 0.1 * np.eye(6), gen)
        link = lambda e: e  # noqa: E731
    assert h.shape == (6, 5, 60, 1 + lag)
    hh = h.permute(1, 2, 0, 3)  # (trial, time, channel, 1 + lag)
    assert torch.equal(hh[..., 0], torch.ones_like(y))
    for k in (1, 2):
        assert torch.equal(hh[:, k:, :, k], y[:, :-k])
        assert torch.equal(hh[:, :k, :, k], torch.zeros_like(y[:, :k]))
    eta = torch.tensor(x) @ torch.tensor(a) + torch.einsum("mtcj,jc->mtc", hh, torch.tensor(b))
    assert_close(m, link(eta).numpy(), rtol=1e-12)
    # 2-D latents are one trial
    y1, h1, _ = tsim.spike(torch.tensor(x[0]), a, b, gen)
    assert y1.shape == (1, 60, 6) and h1.shape == (6, 1, 60, 1 + lag)
