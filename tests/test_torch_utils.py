"""Port parity: the helper modules (utils/misc.py, utils/design.py,
ops/math.py, ops/ichol.ichol, utils/profiling.py) against vlgp_tpu in
float64 on the CPU, at rtol 1e-8 unless a case states otherwise."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vlgp_tpu.ops import ichol as jichol
from vlgp_tpu.ops import math as jmath
from vlgp_tpu.utils import design as jdesign
from vlgp_tpu.utils import misc as jmisc
from vlgp_tpu_torch.ops import ichol as tichol
from vlgp_tpu_torch.ops import math as tmath
from vlgp_tpu_torch.utils import design as tdesign
from vlgp_tpu_torch.utils import misc as tmisc
from vlgp_tpu_torch.utils import profiling as tprof

from _torch_parity import RTOL64, np_of

torch.set_num_threads(1)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _both(x):
    """The same float64 array for each package."""
    return jnp.asarray(x), torch.tensor(x)


def _pairs(ref, got):
    """Flatten a result (an array, or a tuple of arrays) of each package."""
    if isinstance(ref, tuple):
        assert isinstance(got, tuple) and len(got) == len(ref)
        return list(zip(ref, got))
    return [(ref, got)]


def _loading(seed, p=12, k=3):
    """A loading with a clear simple structure: each row loads mostly on one
    factor, so the rotations have one well-separated optimum."""
    rng = _rng(seed)
    x = rng.normal(size=(p, k)) * 0.2
    x[np.arange(p), np.arange(p) % k] += 1.5
    return x @ np.linalg.qr(rng.normal(size=(k, k)))[0]


_X = _rng(1).normal(size=(40, 3))
_Y = _rng(2).normal(size=(40, 2))
_SPIKES = np.sort(_rng(3).uniform(0.0, 10.0, size=200))

# name -> (jax call, port call, input arrays); every case in float64
_CASES = {
    "smooth_1d": (lambda x: jmisc.smooth_1d(x, 3.0), lambda x: tmisc.smooth_1d(x, 3.0),
                  (_rng(4).normal(size=80),)),
    "smooth_1d_kernel_longer": (lambda x: jmisc.smooth_1d(x, 5.0),
                                lambda x: tmisc.smooth_1d(x, 5.0), (_rng(5).normal(size=16),)),
    "smooth_1d_even": (lambda x: jmisc.smooth_1d(x, 2.0), lambda x: tmisc.smooth_1d(x, 2.0),
                       (_rng(6).normal(size=31),)),
    "smooth": (lambda x: jmisc.smooth(x, 4.0), lambda x: tmisc.smooth(x, 4.0), (_X,)),
    "transform_timescale": (lambda t: jmisc.transform_timescale(t, 0.02),
                            lambda t: tmisc.transform_timescale(t, 0.02),
                            (np.array([0.05, 0.1, 0.4]),)),
    "rotate": (jmisc.rotate, tmisc.rotate, (_X, _Y)),
    "rectify": (jmath.rectify, tmath.rectify, (_X,)),
    "log1exp": (jmath.log1exp, tmath.log1exp, (np.linspace(-40.0, 40.0, 81),)),
    "sqexpcov": (lambda w: jmath.sqexpcov(20, w, 1.5, 0.5, dtype=jnp.float64),
                 lambda w: tmath.sqexpcov(20, w, 1.5, 0.5, dtype=torch.float64),
                 (np.array(0.03),)),
    "subspace": (jmath.subspace, tmath.subspace, (_X, _X @ _rng(8).normal(size=(3, 2))
                                                  + 0.1 * _Y)),
    "subspace_rad": (lambda a, b: jmath.subspace(a, b, deg=False),
                     lambda a, b: tmath.subspace(a, b, deg=False), (_Y, _X)),
    "add_diag_scalar": (lambda m: jmath.add_diag(m, 0.5), lambda m: tmath.add_diag(m, 0.5),
                        (_rng(9).normal(size=(2, 4, 4)),)),
    "add_diag_vector": (jmath.add_diag, tmath.add_diag,
                        (_rng(10).normal(size=(2, 4, 4)), _rng(11).normal(size=4))),
    "lexp": (lambda x: jmath.lexp(x, 0.5), lambda x: tmath.lexp(x, 0.5),
             (np.linspace(-3.0, 3.0, 25),)),
    "clip_symmetric": (lambda a: jmath.clip(a, 0.7), lambda a: tmath.clip(a, 0.7), (_X,)),
    "clip_box": (lambda a: jmath.clip(a, -0.2, 1.1), lambda a: tmath.clip(a, -0.2, 1.1), (_X,)),
    "lagmat": (lambda x: jdesign.lagmat(x, 3), lambda x: tdesign.lagmat(x, 3), (_X,)),
    "lagmat_1d": (lambda x: jdesign.lagmat(x, 2), lambda x: tdesign.lagmat(x, 2), (_X[:, 0],)),
    "lagmat_0": (lambda x: jdesign.lagmat(x, 0), lambda x: tdesign.lagmat(x, 0), (_X,)),
    "add_constant": (jdesign.add_constant, tdesign.add_constant, (_X,)),
    "history": (lambda y: jdesign.history(y, 2), lambda y: tdesign.history(y, 2), (_Y,)),
    "makeregressor": (lambda y: jdesign.makeregressor(y, 3),
                      lambda y: tdesign.makeregressor(y, 3), (_Y[:10],)),
    "auto": (lambda a, b: jdesign.auto([a, b], 2), lambda a, b: tdesign.auto([a, b], 2),
             (_Y[:15], _Y[15:])),
    "regmat": (lambda a, b, c, d: jdesign.regmat([a, b], [c, d], 1),
               lambda a, b, c, d: tdesign.regmat([a, b], [c, d], 1),
               (_Y[:15], _Y[15:], _X[:15, :2], _X[15:, :2])),
}


@pytest.mark.parametrize("name", sorted(_CASES))
def test_helper_matches_jax(name):
    jfn, tfn, args = _CASES[name]
    ref = jfn(*(jnp.asarray(a) for a in args))
    got = tfn(*(torch.tensor(a) for a in args))
    for r, g in _pairs(ref, got):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float64, name
        np.testing.assert_allclose(np_of(g), np.asarray(r), rtol=RTOL64, atol=1e-14,
                                   err_msg=name)


def test_orth_matches_jax_up_to_row_signs():
    """orth's rows are an SVD's right singular vectors, each determined up
    to its sign, which LAPACK builds may choose differently: each row of
    a_orth (and the matching column of x_orth) is flipped to JAX's sign,
    then held at rtol 1e-8; x_orth @ a_orth = x @ a holds without it."""
    a = _rng(7).normal(size=(3, 8))
    jx, ja = jmath.orth(jnp.asarray(_X), jnp.asarray(a))
    tx, ta = tmath.orth(torch.tensor(_X), torch.tensor(a))
    sign = np.sign(np.sum(np_of(ta) * np.asarray(ja), axis=1))
    np.testing.assert_allclose(np_of(ta) * sign[:, None], np.asarray(ja), rtol=RTOL64,
                               atol=1e-14)
    np.testing.assert_allclose(np_of(tx) * sign[None, :], np.asarray(jx), rtol=RTOL64,
                               atol=1e-14)
    np.testing.assert_allclose(np_of(tx @ ta), _X @ a, rtol=1e-12, atol=1e-12)


# The rotations iterate to a stopping rule, not to a fixed point: both
# packages take the same steps in float64, and each step's SVD and products
# differ between them by rounding (~1e-15), which the contraction keeps at
# that level.  varimax stops on a relative criterion change below tol =
# 1e-5 and orthomax below rtol = 1e-8, so if rounding moved the stop by
# one step, the results would differ by the size of the last step, at most
# ~sqrt(tol): 1e-8 is asked where both stop on the same step (asserted
# through the identical rotations T).
@pytest.mark.parametrize("name,seed", [("varimax", 0), ("varimax", 1), ("orthomax", 0),
                                       ("orthomax_quartimax", 1), ("promax", 2),
                                       ("varimax_raw", 3)])
def test_rotation_matches_jax(name, seed):
    x = _loading(seed)
    jx, tx = _both(x)
    if name == "varimax":
        ref, got = jmisc.varimax(jx), tmisc.varimax(tx)
    elif name == "varimax_raw":
        ref, got = jmisc.varimax(jx, normalize=False), tmisc.varimax(tx, normalize=False)
    elif name == "orthomax":
        ref, got = jmisc.orthomax(jx), tmisc.orthomax(tx)
    elif name == "orthomax_quartimax":
        ref, got = jmisc.orthomax(jx, gamma=0.0), tmisc.orthomax(tx, gamma=0.0)
    else:
        ref, got = jmisc.promax(jx), tmisc.promax(tx)
    for r, g in _pairs(ref, got):
        np.testing.assert_allclose(np_of(g), np.asarray(r), rtol=RTOL64, atol=1e-12,
                                   err_msg=name)


def test_rotation_degenerate_and_one_factor():
    """One factor: no rotation.  A degenerate orthomax start (x already at a
    zero-gradient point) restarts from a drawn rotation: the two packages
    draw differently (a PRNG key against a torch.Generator), so the result is
    held to what it must be, an orthogonal T with x @ T."""
    x1 = _X[:, :1]
    for rotation in (tmisc.varimax, tmisc.promax):
        z, T = rotation(torch.tensor(x1))
        assert torch.equal(z, torch.tensor(x1)) and T.shape == (1, 1)
    x = np.zeros((6, 2))
    x[:3, 0] = 1.0
    x[3:, 1] = 1.0  # a perfect simple structure: the first step is the identity
    B, T = tmisc.orthomax(torch.tensor(x), generator=3)
    np.testing.assert_allclose(np_of(T.T @ T), np.eye(2), atol=1e-12)
    np.testing.assert_allclose(np_of(B), x @ np_of(T), atol=1e-12)
    B2, T2 = tmisc.orthomax(torch.tensor(x), generator=tmisc.ensure_generator(3))
    assert torch.equal(T, T2)


def test_misc_host_helpers_match_jax(caplog):
    """count, trial_slices and log_calls are host code in both packages;
    ensure_generator is ensure_key's counterpart."""
    for args in ((_SPIKES, 0.5), (_SPIKES, 0.25, 1.0, 9.0), (np.array([]), 0.1),
                 (np.array([2.0]), 1.0)):
        np.testing.assert_array_equal(tmisc.count(*args), jmisc.count(*args))
    assert tmisc.trial_slices([3, 0, 5]) == jmisc.trial_slices([3, 0, 5])

    @tmisc.log_calls
    def f(a, b=2):
        return a + b

    with caplog.at_level("INFO", logger="vlgp_tpu_torch"):
        assert f(1, b=3) == 4
    assert "f is called" in caplog.text and f.__name__ == "f"
    g = torch.Generator()
    assert tmisc.ensure_generator(g) is g
    a = torch.rand(4, generator=tmisc.ensure_generator(5))
    assert torch.equal(a, torch.rand(4, generator=torch.Generator().manual_seed(5)))


def _spd(n, seed, rank=None):
    """A PSD matrix whose pivots are well separated: distinct diagonal
    scales, so no two candidate pivots tie at any step."""
    rng = _rng(seed)
    k = n if rank is None else rank
    F = rng.normal(size=(n, k)) * np.linspace(2.0, 0.5, n)[:, None]
    return F @ F.T + (1e-3 * np.diag(np.linspace(1.0, 2.0, n)) if rank is None else 0.0)


@pytest.mark.parametrize("n,rank,seed,psd_rank", [(12, None, 0, None), (12, 6, 1, None),
                                                  (10, 10, 2, 4), (15, 20, 3, None)])
def test_ichol_matches_jax(n, rank, seed, psd_rank):
    """The general pivoted ichol, on matrices whose factor is unique at the
    requested rank (no pivot ties; ROADMAP Queue 3's known divergence is
    where pivots tie).  psd_rank 4 runs past the matrix's rank, where the
    exhausted pivots give zero columns; rank 20 > n stops at n."""
    A = _spd(n, seed, psd_rank)
    ref = np.asarray(jichol.ichol(jnp.asarray(A), rank))
    got = tichol.ichol(torch.tensor(A), rank)
    assert got.shape == ref.shape
    if psd_rank is None:
        np.testing.assert_allclose(np_of(got), ref, rtol=RTOL64, atol=1e-12)
    else:  # past the rank the pivoted diagonal is rounding noise: compare G G'
        np.testing.assert_allclose(np_of(got @ got.T), ref @ ref.T, rtol=RTOL64, atol=1e-10)
    if rank is None or rank >= n:
        np.testing.assert_allclose(np_of(got @ got.T), A, rtol=1e-8, atol=1e-10)


def test_profiling_phase_timer_and_device_trace(tmp_path):
    """phase_timer appends one elapsed time per phase (CPU tensors need no
    sync); device_trace writes a torch.profiler Chrome trace to logdir."""
    log = {}
    for _ in range(2):
        with tprof.phase_timer(log, "e", sync={"x": torch.ones(3), "y": [torch.zeros(1)]}):
            torch.ones(8).sum()
    assert len(log["e"]) == 2 and all(t >= 0 for t in log["e"])
    with tprof.device_trace(str(tmp_path)):
        with tprof.annotate("vlgp:test"):
            torch.ones(16).cumsum(0)
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(traces) == 1
    assert "vlgp:test" in (tmp_path / traces[0]).read_text()
