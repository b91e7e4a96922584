"""Port parity: SE prior factors (pivoted ichol, Nystrom with its ichol
fallback), make_cholesky, effective_rank and trunc_exp."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vlgp_tpu.models import gp as jgp
from vlgp_tpu.ops import ichol as jichol
from vlgp_tpu.ops.math import trunc_exp as j_trunc_exp
from vlgp_tpu_torch.models import gp as tgp
from vlgp_tpu_torch.ops import ichol as tichol
from vlgp_tpu_torch.ops.math import trunc_exp as t_trunc_exp

from _torch_parity import RTOL64, assert_close, port_params

torch.set_num_threads(1)


def assert_factor_close(got, ref, rtol=RTOL64, atol=1e-12, err_msg=""):
    """Low-rank factors agree as kernels, K ~= G G', at ``rtol``.

    Past the kernel's numerical rank the remaining pivoted diagonal is
    rounding noise (~1e-10 in float64), so which noise-level pivot comes
    next depends on the order of sums in each package, and the columns it
    makes differ entry by entry; G G', the only form in which the model
    uses the factor, does not.  (Where the rank is far below the kernel's
    numerical rank, e.g. omega 5e-2 over 200 bins at rank 50, distant
    diagonals tie at 1.0 and the last bit picks the pivot: both packages
    then give different factors, each as far from K as the other, so the
    cases below stay where the factor is determined.)"""
    got = np.asarray(got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got @ np.swapaxes(got, -1, -2), ref @ np.swapaxes(ref, -1, -2),
                               rtol=rtol, atol=atol, err_msg=err_msg)


@pytest.mark.parametrize("n,rank,om", [(60, 20, (1e-3, 1e-2, 5e-2)),
                                       (30, 30, (1e-3, 1e-2, 5e-2)),
                                       (200, 50, (5e-4, 1e-3, 1e-2))])
def test_ichol_gauss_batch_f64(n, rank, om):
    """(30, 30) and omega 1e-3 run past the kernel's numerical rank."""
    om = np.array(om)
    ref = np.asarray(jichol.ichol_gauss_batch(n, jnp.asarray(om), rank, 1.0))
    got = tichol.ichol_gauss_batch(n, torch.tensor(om), rank, 1.0)
    assert got.shape == ref.shape
    assert_factor_close(got, ref)
    single = tichol.ichol_gauss(n, torch.tensor(om[1]), rank)
    assert_factor_close(single, ref[1])


def test_nystrom_f64_and_f32():
    om = np.array([6e-4, 3e-3, 5e-2])
    ref = np.asarray(jichol.nystrom_gauss_batch(50, jnp.asarray(om), 40, 1.0))
    assert_close(tichol.nystrom_gauss_batch(50, torch.tensor(om), 40, 1.0), ref, atol=1e-12)
    om32 = om.astype(np.float32)
    ref32 = np.asarray(jichol.nystrom_gauss_batch(50, jnp.asarray(om32), 40, 1.0))
    got32 = tichol.nystrom_gauss_batch(50, torch.tensor(om32), 40, 1.0)
    assert got32.dtype == torch.float32
    assert_close(got32, ref32, rtol=0, atol=2e-3)


def test_nystrom_falls_back_to_ichol_per_latent():
    """A failed landmark Cholesky (jitter 0, near-constant kernel) must
    take the exact ichol factor for that latent only
    (vlgp_tpu/ops/ichol.py:143-158)."""
    om = np.array([1e-6, 1e-2])
    ref = np.asarray(jichol.nystrom_gauss_batch(50, jnp.asarray(om), 40, 1.0, 0.0))
    got = tichol.nystrom_gauss_batch(50, torch.tensor(om), 40, 1.0, 0.0)
    ichol = np.asarray(jichol.ichol_gauss_batch(50, jnp.asarray(om), 40, 1.0))
    np.testing.assert_array_equal(ref[0], ichol[0])  # the JAX side fell back
    assert_factor_close(got[0], ichol[0])
    assert_factor_close(got, ref)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_make_cholesky_matches(dtype):
    from vlgp_tpu.config import make_params

    params = make_params(5, 3, 1, "poisson", omega=np.array([7e-4, 2e-3, 6e-3]),
                         sigma=np.array([1.0, 0.7, 1.3]), dtype=jnp.dtype(dtype))
    tp = port_params(params)
    rtol, atol = (RTOL64, 1e-12) if dtype == "float64" else (0, 2e-3)
    # full-length (ichol) and segment (Nystrom in float32) factors
    for T, rank in ((300, 50), (50, 40)):
        ref = np.asarray(jgp.make_cholesky(T, params, rank=rank))
        got = tgp.make_cholesky(T, tp, rank=rank)
        assert got.dtype == getattr(torch, dtype)
        assert_factor_close(got, ref, rtol=rtol, atol=atol, err_msg=f"T={T}")


@pytest.mark.parametrize("T,omega_hi", [(50, 5e-2), (50, 1e-2), (50, 1e-3), (20, 5e-1)])
def test_effective_rank_matches(T, omega_hi):
    assert tgp.effective_rank(T, omega_hi, 1.0) == jgp.effective_rank(T, omega_hi, 1.0)


def test_se_kernels_match():
    assert_close(tgp.se_kernel_grid(40, 3e-3, 1.7, 1e-4, 0.5, dtype=torch.float64),
                 np.asarray(jgp.se_kernel_grid(40, 3e-3, 1.7, 1e-4, 0.5, dtype=jnp.float64)))
    x = np.linspace(0.0, 3.0, 25)
    assert_close(tgp.sekernel(torch.tensor(x), 0.8, 0.4),
                 np.asarray(jgp.sekernel(jnp.asarray(x), 0.8, 0.4)))


def test_trunc_exp_matches():
    x = np.linspace(-30, 30, 101)
    assert_close(t_trunc_exp(torch.tensor(x)), np.asarray(j_trunc_exp(jnp.asarray(x))))
