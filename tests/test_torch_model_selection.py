"""vlgp_tpu_torch.model_selection against vlgp_tpu.model_selection in
float64 on the CPU: speckled_cv under the mask JAX draws, leave-one-neuron-
out on the same FitResult state (Poisson and Gaussian channels), and the
CV sweep over factor counts (its draws come from a torch generator, so it
is checked by its errors, not bits)."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

import vlgp_tpu
from vlgp_tpu import model_selection as jms
from vlgp_tpu_torch import model_selection as tms

from _torch_parity import RTOL64, pin_trials, port_result

torch.set_num_threads(1)


def test_speckled_cv_under_jax_mask_matches_jax():
    """The port's masked core, fed the mask vlgp_tpu draws from its key,
    gives vlgp_tpu's training and test errors at rtol 1e-7 (the E-step
    inverts K, whose 1e-6 jitter sets a condition number of ~1e7 here, so
    the packages' summation orders part at ~1e-8 over 5 EM iterations); the
    public function draws its own mask from a torch generator."""
    rng = np.random.default_rng(1)
    m, n, ydim, zdim = 8, 40, 6, 2
    t = np.arange(n, dtype=float)
    K = np.exp(-0.5 * ((t[:, None] - t) / 6.0) ** 2) + 1e-6 * np.eye(n)
    z = np.einsum("tu,muz->mtz", np.linalg.cholesky(K), rng.normal(size=(m, n, zdim)))
    y = np.einsum("mtz,zy->mty", z, rng.normal(size=(zdim, ydim))) + rng.normal(
        size=(m, n, ydim)) * 0.3
    C0 = rng.normal(size=(zdim, ydim)) * 0.1
    key = jax.random.PRNGKey(0)
    args = (y, C0, np.zeros(ydim), np.ones(ydim), K)
    ref = jms.speckled_cv(*(jnp.asarray(a) for a in args), 0.2, 5, key)
    mask = np.asarray(jax.random.uniform(key, y.shape) < 0.2)
    targs = [torch.tensor(a) for a in args]
    out = tms._speckled_cv_masked(*targs, torch.tensor(mask), 5)
    assert np.allclose(out, ref, rtol=1e-7, atol=0.0), (out, ref)
    assert ref[1] > ref[0]  # held-out entries are predicted worse

    gen = torch.Generator().manual_seed(0)
    tr, te = tms.speckled_cv(*targs, 0.2, 5, gen)
    assert np.isfinite(tr) and np.isfinite(te) and te > tr
    assert tms.elementwise_error(torch.tensor([1.0, 2.0]), torch.tensor([0.0, 4.0])).tolist() \
        == [1.0, 4.0]


def test_leave_one_neuron_out_matches_jax():
    """Scores of Poisson (0, 3) and Gaussian (8) channels, and of every
    channel, on the same posterior state, at rtol 1e-8."""
    from vlgp_tpu.config import default_config, make_params
    from vlgp_tpu.data import pack_trials
    from vlgp_tpu.models.gp import make_cholesky
    from vlgp_tpu.models.vlgp import update_v, update_w

    trials, a, _ = pin_trials(ntrial=3, length=90)
    trials[2]["y"], trials[2]["mu"] = trials[2]["y"][:70], trials[2]["mu"][:70]
    config = default_config(dtype="float64", max_iter=6)
    params = make_params(10, 2, 1, ["poisson"] * 8 + ["gaussian"] * 2, a=a,
                         b=np.full((1, 10), -1.5), noise=np.full(10, 0.8),
                         omega=np.full(2, 1e-2), dtype=jnp.float64)
    data = pack_trials(trials, 2, 1, dtype=np.float64)
    G = make_cholesky(data.nbin, params)
    data = update_v(update_w(data, params, config), params, G, config)
    jres = vlgp_tpu.FitResult(data=data, params=params, config=config, factor_model=None,
                              G=G, runtime={})
    tres = port_result(jres)
    for neurons in ([0, 3, 8], None):
        ref = jms.leave_one_neuron_out(jres, neurons=neurons, batch=3)
        out = tms.leave_one_neuron_out(tres, neurons=neurons, batch=3)
        assert list(out) == list(ref)
        for k in ref:
            assert np.isclose(out[k], ref[k], rtol=RTOL64, atol=0.0), (k, out[k], ref[k])
    assert tms.leave_one_neuron_out(tres, neurons=[]) == {}


def test_gmap_speckled_cv_runs_sweep():
    """The CV sweep over factor counts gives finite errors, and more factors
    fit the training partition at least as well (the JAX package's check)."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(2, 12)) * 0.6
    z = np.column_stack((np.sin(np.linspace(0, 6, 100)), np.cos(np.linspace(0, 6, 100))))
    trials = [{"y": rng.poisson(np.exp(z @ a - 1.5)).astype(float)} for _ in range(6)]
    tr, te = tms.gmap_speckled_cv(trials, [1, 2], test_ratio=0.15, dt=1.0, var=1.0,
                                  scale=10.0, max_iter=15, seed=0, device="cpu")
    assert len(tr) == len(te) == 2
    assert all(np.isfinite(tr)) and all(np.isfinite(te))
    assert tr[1] <= tr[0] * 1.02
