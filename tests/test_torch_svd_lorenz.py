"""The loading's SVD (``ops/linalg.svd_loading``) and the Lorenz trajectory
(``simulation.lorenz``) on the CPU, where both run their plain versions;
their CUDA kernels (``csrc/svd_loading.cu``, ``csrc/lorenz.cu``) are held
against these plain versions by ``chip_smoke.py`` on the card.

svd_loading against ``jnp.linalg.svd`` in float64: the same rows up to
sign at rtol 1e-10 (both are LAPACK SVDs of the same well-conditioned
matrix), in descending singular value, each row's largest entry positive.
The svd-constrained fit's fused and block drivers repeat its eager fit bit
for bit.  lorenz's loop equals, bit for bit, the kernel's operations
replayed in NumPy scalars of the same dtype: the order the kernel is
written to, each operation rounded on its own.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vlgp_tpu_torch
from vlgp_tpu_torch import simulation as tsim
from vlgp_tpu_torch.ops import spd
from vlgp_tpu_torch.ops.linalg import Z_MAX, svd_loading

from _torch_parity import pin_trials

torch.set_num_threads(1)


def _loading(Z, Y, seed=0):
    return np.random.default_rng(seed).normal(size=(Z, Y))


def _orthonormal(vh, tol):
    eye = torch.eye(vh.shape[0], dtype=vh.dtype)
    return float((vh @ vh.T - eye).abs().max()) <= tol


def _largest_entry_positive(vh):
    idx = vh.abs().argmax(dim=1)
    return bool((vh[torch.arange(vh.shape[0]), idx] > 0).all())


@pytest.mark.parametrize("Z,Y", [(5, 100), (3, 7)])
def test_svd_loading_matches_jax_up_to_sign(Z, Y):
    a = _loading(Z, Y)
    ref = np.asarray(jnp.linalg.svd(jnp.asarray(a), full_matrices=False)[2])
    before = dict(spd.KERNEL_LAUNCHES)
    vh = svd_loading(torch.tensor(a))
    assert dict(spd.KERNEL_LAUNCHES) == before  # the CPU runs no kernel
    assert vh.shape == (Z, Y) and vh.dtype == torch.float64
    sign = np.sign(np.sum(vh.numpy() * ref, axis=1))
    np.testing.assert_allclose(vh.numpy() * sign[:, None], ref, rtol=1e-10, atol=1e-12)
    assert _largest_entry_positive(vh) and _orthonormal(vh, 1e-12)
    # descending singular values: the rows' images under a
    s = torch.linalg.norm(torch.tensor(a) @ vh.T, dim=0)
    assert bool((s[:-1] >= s[1:]).all())
    # constrain_loading's invariant: (mu @ us) @ vh == mu @ a, us = a vh'
    mu = torch.tensor(np.random.default_rng(1).normal(size=(4, Z)))
    at = torch.tensor(a)
    torch.testing.assert_close((mu @ (at @ vh.T)) @ vh, mu @ at, rtol=1e-12, atol=1e-12)


def test_svd_loading_edge_cases():
    """A zero row of a still gives finite orthonormal rows spanning a's
    rows; a NaN gives NaN; more than Z_MAX rows raise, naming the limit."""
    a = torch.tensor(_loading(5, 100))
    a[2] = 0.0
    vh = svd_loading(a)
    assert torch.isfinite(vh).all() and _orthonormal(vh, 1e-12)
    torch.testing.assert_close(a @ vh.T @ vh, a, rtol=1e-12, atol=1e-12)
    assert _largest_entry_positive(vh)
    f32 = svd_loading(a.float())
    assert f32.dtype == torch.float32 and _orthonormal(f32.double(), 1e-5)
    a[1, 3] = float("nan")
    assert torch.isnan(svd_loading(a)).all()
    with pytest.raises(ValueError, match=f"Z_MAX = {Z_MAX}"):
        svd_loading(torch.zeros((Z_MAX + 1, 200)))


def _kw(a, **extra):
    return dict(a=a, b=np.full((1, 10), -1.5), noise=np.ones(10), dtype="float64",
                constrain_loading="svd", max_iter=4, **extra)


def test_svd_fit_drivers_repeat_the_eager_fit():
    """fit(fused=True) and fit(block=2) with the svd loading constraint on
    the CPU: the eager step, so every field equal bit for bit."""
    trials, a, _ = pin_trials(ntrial=2, length=60)
    ref = vlgp_tpu_torch.fit(trials, 2, device="cpu", **_kw(a))
    for kw in (dict(fused=True), dict(block=2)):
        got = vlgp_tpu_torch.fit(trials, 2, device="cpu", **_kw(a, **kw))
        for f in ("a", "b", "omega", "sigma"):
            assert torch.equal(getattr(got.params, f), getattr(ref.params, f)), (kw, f)
        assert torch.equal(got.data.mu, ref.data.mu), kw


def _lorenz_rn(n, T, x0=(0.0, 1.0, 1.05), dt=0.01, s=10.0, r=28.0, b=2.667):
    """csrc/lorenz.cu's steps in NumPy scalars of type T, one rounding per
    operation, the constants rounded to T first."""
    dt, s, r, b = T(dt), T(s), T(r), T(b)
    x, y, z = (T(v) for v in x0)
    out = np.empty((n, 3), T)
    out[0] = x, y, z
    for i in range(1, n):
        dx = s * (y - x)
        dy = (r * x - y) - x * z
        dz = x * y - b * z
        x, y, z = x + dt * dx, y + dt * dy, z + dt * dz
        out[i] = x, y, z
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lorenz_loop_is_the_kernels_arithmetic(dtype):
    """The CPU loop launches no kernel, keeps the dtype, and equals the
    kernel's operations bit for bit, from the default and a given start;
    n = 1 is the start alone."""
    T = np.float32 if dtype == torch.float32 else np.float64
    before = spd.KERNEL_LAUNCHES["lorenz"]
    for x0 in (None, (1.0, -2.0, 20.0)):
        xs = tsim.lorenz(2000, x0=x0, dtype=dtype, device="cpu")
        assert xs.dtype == dtype and xs.shape == (2000, 3)
        ref = _lorenz_rn(2000, T, **({} if x0 is None else {"x0": x0}))
        assert np.array_equal(xs.numpy(), ref)
    one = tsim.lorenz(1, x0=(1.0, -2.0, 20.0), dtype=dtype, device="cpu")
    assert one.shape == (1, 3) and one.tolist() == [[1.0, -2.0, 20.0]]
    assert spd.KERNEL_LAUNCHES["lorenz"] == before
