"""ns_gram's long-T design ("pairs", csrc/ns_inverse.cu:ns_gram_pairs)
through its plain mirror ``_ns_gram_pairs_plain``, and the (T, R) rule that
picks between the two hand-written designs.

The mirror forms the Gram over the pairs p = (i <= j) of the upper
triangle and v from Xp (X_ii, and X_ij + X_ji off the diagonal), as the
kernels do.  In float64 it equals ``_ns_gram_plain`` to rounding; in
float32 it is held, like the per-matrix plain version in
tests/test_torch_spd.py, to ``vlgp_tpu``'s Pallas kernel in interpret mode
within 2e-3 of max|X| (bf16x3 products there, float32 here), with both
residuals under 1e-2.
"""
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vlgp_tpu.ops import spd as jspd
from vlgp_tpu_torch.ops import spd as tspd

from _torch_parity import np_of

torch.set_num_threads(1)

TOL = 1e-2
AGREE = 2e-3
MODES = ("cold+v", "warm+v", "probe+v")


def _problem(Z, S, T, R, seed, dtype):
    """G, w with lambda_max(A) ~ 1e1, a drifted w for the warm mode, and the
    float64 inverse of the undrifted system as the carry."""
    rng = np.random.default_rng(seed)
    G = (rng.normal(size=(Z, T, R)) * 0.3).astype(dtype)
    w = rng.uniform(size=(Z, S, T))
    A = np.einsum("ztr,zst,ztq->zsrq", G.astype(np.float64), w, G.astype(np.float64))
    w = (w * 10.0 / np.linalg.eigvalsh(A).max()).astype(dtype)
    w_warm = (w * (1 + 0.02 * rng.uniform(size=w.shape))).astype(dtype)
    A = np.einsum("ztr,zst,ztq->zsrq", G.astype(np.float64), w.astype(np.float64),
                  G.astype(np.float64))
    x0 = np.linalg.inv(A + np.eye(R)).astype(dtype)
    return G, w, w_warm, x0


def _args(mode, w, w_warm, x0):
    """(w, keyword arguments) of one ns_gram call in `mode`."""
    if mode == "cold+v":
        return w, dict(iters=16, want_v=True)
    if mode == "warm+v":
        return w_warm, dict(iters=4, x0=x0, want_v=True)
    return w, dict(iters=0, x0=x0, resid_only=True, want_v=True)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(2, 5, 70, 17), (1, 3, 9, 1), (2, 4, 33, 8)])
def test_pairs_plain_equals_plain_f64(shape, mode):
    """The pair form is an exact rewrite: X, every residual and v equal the
    per-matrix plain version's to float64 rounding."""
    G, w, w_warm, x0 = _problem(*shape, seed=sum(shape), dtype=np.float64)
    ww, kw = _args(mode, w, w_warm, x0)
    if "x0" in kw:
        kw["x0"] = torch.tensor(kw["x0"])
    a = tspd._ns_gram_plain(torch.tensor(G), torch.tensor(ww), **kw)
    b = tspd._ns_gram_pairs_plain(torch.tensor(G), torch.tensor(ww), **kw)
    assert (a[0] is None) == (b[0] is None) == (mode == "probe+v")
    for x, y in zip(a, b):
        if x is not None:
            assert x.dtype == y.dtype == torch.float64
            np.testing.assert_allclose(np_of(y), np_of(x), rtol=0, atol=1e-12)


@pytest.mark.parametrize("mode", MODES)
def test_pairs_plain_matches_pallas(mode):
    """float32 against ``_ns_gram_pallas(..., interpret=True)`` at Z2, S one
    past the long-T design's 128-row GEMM tile plus 3 (a ragged last tile,
    and a ragged TPU block), T70 and R17."""
    G, w, w_warm, x0 = _problem(2, 128 + 3, 70, 17, seed=23, dtype=np.float32)
    ww, kw = _args(mode, w, w_warm, x0)
    jkw = {k: jnp.asarray(v) if k == "x0" else v for k, v in kw.items()}
    tkw = {k: torch.tensor(v) if k == "x0" else v for k, v in kw.items()}
    Xj, rj, vj = jspd._ns_gram_pallas(jnp.asarray(G), jnp.asarray(ww), interpret=True, **jkw)
    Xt, rt, vt = tspd._ns_gram_pairs_plain(torch.tensor(G), torch.tensor(ww), **tkw)
    scale = np.abs(x0).max()
    assert float(rt.amax()) < TOL and float(rj) < TOL
    err = np.abs(np_of(vt) - np.asarray(vj)).max()
    assert err <= AGREE * scale, (err, scale)
    if mode == "probe+v":
        assert Xt is None and Xj is None
        assert abs(float(rt.amax()) - float(rj)) < AGREE
    else:
        err = np.abs(np_of(Xt) - np.asarray(Xj)).max()
        assert err <= AGREE * scale, (err, scale)


def test_design_rule_takes_t_and_r_only():
    """The design is a function of (T, R): never of S, so a segment's bits
    do not depend on the segments beside it.  The segments (T50 R40) take
    the per-matrix design, full-length trials (T1000 R50) the pairs
    design, and the switch is at _PAIRS_MIN_T."""
    assert list(inspect.signature(tspd._ns_gram_design).parameters) == ["T", "R"]
    assert tspd._ns_gram_design(50, 40) == "per_matrix"
    assert tspd._ns_gram_design(1000, 50) == "pairs"
    T_star = tspd._PAIRS_MIN_T
    assert 50 < T_star <= 1000
    assert tspd._ns_gram_design(T_star - 1, 50) == "per_matrix"
    assert tspd._ns_gram_design(T_star, 50) == "pairs"


def test_cpu_dispatch_never_reaches_a_kernel():
    """On CPU tensors ns_gram runs the per-matrix plain version at any T;
    the pairs mirror is called only by the tests and chip_smoke.py."""
    tspd.reset_counters()
    G, w, _, _ = _problem(1, 3, 1000, 5, seed=4, dtype=np.float32)
    assert tspd._ns_gram_design(1000, 5) == "pairs"
    X, r, v = tspd.ns_gram(torch.tensor(G), torch.tensor(w), iters=16, want_v=True)
    Xp, rp, vp = tspd._ns_gram_plain(torch.tensor(G), torch.tensor(w), iters=16, want_v=True)
    assert torch.equal(X, Xp) and torch.equal(v, vp) and torch.equal(r, rp.amax())
    assert set(tspd.KERNEL_LAUNCHES.values()) == {0}
