"""Port parity for ops/spd: the exact route in float64, and the float32
semantics of the ns_gram / ns_packed (probe_skip included) / spd_inverse
kernels' plain versions against the JAX package's Pallas kernels in
interpret mode.

The TPU kernels multiply in bf16x3 and the port in float32, so float32
results are held to the residual contract max|(I+A)X - I| < 1e-2 on both
sides and agree within 2e-3 of max|X|, not bit for bit.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vlgp_tpu.ops import spd as jspd
from vlgp_tpu_torch.ops import spd as tspd

from _torch_parity import assert_close, np_of

torch.set_num_threads(1)

TOL = 1e-2
AGREE = 2e-3


@pytest.fixture(autouse=True)
def _fresh_counters():
    tspd.reset_counters()
    yield


def _psd(batch, R, scale=1.0, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    G = rng.normal(size=batch + (R, R // 2)).astype(dtype)
    return np.einsum("...rk,...qk->...rq", G, G) * scale


def _gram_problem(Z=2, S=5, T=12, R=8, seed=11, scale=1.0):
    """The inputs of tests/test_spd.py:_gram_problem."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(Z, T, R)).astype(np.float32) * 0.5
    w = (rng.uniform(size=(Z, S, T)) * scale).astype(np.float32)
    A = np.einsum("ztr,zst,ztq->zsrq", G, w, G)
    X_ref = np.linalg.inv(A + np.eye(R, dtype=np.float32))
    return G, w, X_ref


def _resid(A, X):
    A, X = np.asarray(A, np.float64), np.asarray(X, np.float64)
    eye = np.eye(A.shape[-1])
    return np.abs((A + eye) @ X - eye).max()


def _agree(port, ref, scale):
    err = np.abs(np_of(port) - np.asarray(ref)).max()
    assert err <= AGREE * scale, (err, scale)


def _gram_A(G, w):
    return np.einsum("ztr,zst,ztq->zsrq", G.astype(np.float64), w.astype(np.float64),
                     G.astype(np.float64))


@pytest.fixture(scope="module")
def jax_cold():
    """The Pallas kernel's cold route (interpret mode) on the default
    problem: (G, w, X_ref, X, v)."""
    G, w, X_ref = _gram_problem()
    Xj, vj = jspd.inv_one_plus_gram(jnp.asarray(G), jnp.asarray(w), iters=16,
                                    force="interpret", want_v=True)
    return G, w, X_ref, np.asarray(Xj), np.asarray(vj)


# ---------------------------------------------------------------- float64 --


def test_exact_route_f64():
    A = _psd((3, 4), 12, 0.5, seed=1, dtype=np.float64)
    ref = np.asarray(jspd.inv_one_plus_psd(jnp.asarray(A)))
    got = tspd.inv_one_plus_psd(torch.tensor(A))
    assert_close(got, ref)
    assert tspd.ROUTE_CALLS == {"gram": 0, "packed": 0, "sweep": 0}

    G, w, _ = _gram_problem(seed=12)
    G, w = G.astype(np.float64), w.astype(np.float64)
    Xj, vj = jspd.inv_one_plus_gram(jnp.asarray(G), jnp.asarray(w), want_v=True)
    Xt, vt = tspd.inv_one_plus_gram(torch.tensor(G), torch.tensor(w), want_v=True)
    assert_close(Xt, np.asarray(Xj))
    assert_close(vt, np.asarray(vj))
    # warm starts do not change the exact route
    Xw = tspd.inv_one_plus_gram(torch.tensor(G), torch.tensor(w), warm=Xt * 0)
    assert_close(Xw, np.asarray(Xj))
    assert tspd.ROUTE_CALLS == {"gram": 0, "packed": 0, "sweep": 0}


def test_large_rank_f32_takes_exact_route():
    """R > 128 is past the kernels' shared-memory limit: exact route."""
    G, w, X_ref = _gram_problem(Z=1, S=2, T=140, R=130, seed=3, scale=0.1)
    X = tspd.inv_one_plus_gram(torch.tensor(G), torch.tensor(w))
    assert tspd.ROUTE_CALLS == {"gram": 0, "packed": 0, "sweep": 0}
    assert np.abs(np_of(X) - X_ref).max() < 1e-4


# ------------------------------------------- float32: ns_gram semantics --


def test_gram_cold_matches_pallas(jax_cold):
    G, w, X_ref, Xj, vj = jax_cold
    Xt, vt = tspd.inv_one_plus_gram(torch.tensor(G), torch.tensor(w), iters=16, want_v=True)
    assert Xt.dtype == torch.float32 and tspd.ROUTE_CALLS["gram"] == 1
    A = _gram_A(G, w)
    assert _resid(A, Xt) < TOL and _resid(A, Xj) < TOL
    scale = np.abs(X_ref).max()
    _agree(Xt, Xj, scale)
    _agree(vt, vj, scale)
    assert sum(tspd.FALLBACKS.values()) == 0


def test_gram_warm_refine_matches_pallas():
    """probe=False always refines (the H-step's first refinement)."""
    G, w, X_ref = _gram_problem(seed=16)
    w2 = w * 1.5  # the carried inverse is from a different system
    Xj, vj = jspd.inv_one_plus_gram(jnp.asarray(G), jnp.asarray(w2), iters=16,
                                    force="interpret", warm=jnp.asarray(X_ref),
                                    warm_iters=8, probe=False, want_v=True)
    Xt, vt = tspd.inv_one_plus_gram(torch.tensor(G), torch.tensor(w2), iters=16,
                                    warm=torch.tensor(X_ref), warm_iters=8,
                                    probe=False, want_v=True)
    A = _gram_A(G, w2)
    assert _resid(A, Xt) < TOL and _resid(A, np.asarray(Xj)) < TOL
    _agree(Xt, Xj, np.abs(X_ref).max())
    _agree(vt, vj, np.abs(X_ref).max())
    assert sum(tspd.FALLBACKS.values()) == 0
    # with the probe on, the drifted carry is rejected, then refined
    tspd.inv_one_plus_gram(torch.tensor(G), torch.tensor(w2), iters=16,
                           warm=torch.tensor(X_ref), warm_iters=8)
    assert tspd.FALLBACKS["gram_probe_reject"] == 1
    assert tspd.FALLBACKS["gram_refine_fail"] == 0


def test_gram_probe_accepts_carry_as_is():
    """An exact carried inverse passes the probe unchanged, with v from it
    (the Pallas side of this is tests/test_spd.py:181; the kernel-level
    probe is compared with Pallas in the tail-shape test below)."""
    G, w, X_ref = _gram_problem(seed=13)
    warm = torch.tensor(X_ref)
    Xt, vt = tspd.inv_one_plus_gram(torch.tensor(G), torch.tensor(w), iters=16,
                                    warm=warm, warm_iters=4, want_v=True)
    assert Xt is warm
    v_ref = np.einsum("ztr,zsrq,ztq->zst", G, X_ref, G)
    _agree(vt, v_ref, np.abs(X_ref).max())
    assert sum(tspd.FALLBACKS.values()) == 0


@pytest.mark.parametrize("bad", [50.0, np.nan])
def test_gram_bad_warm_start_reaches_cold_route(jax_cold, bad):
    """Garbage and NaN carries fail the probe and the refinement; the cold
    route answers, so the result matches the Pallas cold route (the
    Pallas side's own garbage case is tests/test_spd.py:195)."""
    G, w, X_ref, Xj, vj = jax_cold
    garbage = np.full_like(X_ref, bad)
    Xt, vt = tspd.inv_one_plus_gram(torch.tensor(G), torch.tensor(w), iters=16,
                                    warm=torch.tensor(garbage), warm_iters=2, want_v=True)
    assert torch.isfinite(Xt).all() and torch.isfinite(vt).all()
    A = _gram_A(G, w)
    assert _resid(A, Xt) < TOL
    _agree(Xt, Xj, np.abs(X_ref).max())
    _agree(vt, vj, np.abs(X_ref).max())
    assert tspd.FALLBACKS["gram_probe_reject"] == 1
    assert tspd.FALLBACKS["gram_refine_fail"] == 1


def test_gram_kernel_modes_and_tail_shape():
    """Kernel-level outputs at the tail shape of tests/test_spd.py:209
    (S one past a TPU block plus 3): cold with v, probe, and a NaN x0
    whose residual must stay NaN."""
    R = 8
    _, _, per_block, _ = jspd._packed_geometry(1, R, tiles=16)
    G, w, X_ref = _gram_problem(Z=1, S=per_block + 3, T=10, R=R, seed=15)
    Xj, rj, vj = jspd._ns_gram_pallas(jnp.asarray(G), jnp.asarray(w), iters=16,
                                      want_v=True, interpret=True)
    Xt, rt, vt = tspd.ns_gram(torch.tensor(G), torch.tensor(w), iters=16, want_v=True)
    assert float(rt) < TOL and float(rj) < TOL
    _agree(Xt, Xj, np.abs(X_ref).max())
    _agree(vt, vj, np.abs(X_ref).max())

    x0 = Xt.contiguous()
    _, r0j, v0j = jspd._ns_gram_pallas(jnp.asarray(G), jnp.asarray(w), iters=0,
                                       x0=jnp.asarray(np_of(x0)), resid_only=True,
                                       want_v=True, interpret=True)
    X0t, r0t, v0t = tspd.ns_gram(torch.tensor(G), torch.tensor(w), iters=0, x0=x0,
                                 resid_only=True, want_v=True)
    assert X0t is None and float(r0t) < TOL and float(r0j) < TOL
    _agree(v0t, v0j, np.abs(X_ref).max())

    _, rnan, _ = tspd.ns_gram(torch.tensor(G), torch.tensor(w), iters=3,
                              x0=torch.full_like(x0, float("nan")))
    assert torch.isnan(rnan)


# ----------------------------------------- float32: ns_packed semantics --


def test_packed_kernel_modes_match_pallas():
    R = 40
    A = _psd((7,), R, 0.3, seed=9)
    X_ref = np.linalg.inv(A + np.eye(R, dtype=np.float32))
    scale = np.abs(X_ref).max()
    Xj, rj = jspd._ns_packed_pallas(jnp.asarray(A), iters=16, interpret=True)
    Xt, rt = tspd.ns_packed(torch.tensor(A), iters=16)
    assert float(rt) < TOL and float(rj) < TOL
    _agree(Xt, Xj, scale)

    A2 = (A * 1.05).astype(np.float32)
    Xj, rj = jspd._ns_packed_pallas(jnp.asarray(A2), iters=4, x0=jnp.asarray(X_ref),
                                    interpret=True)
    Xt, rt = tspd.ns_packed(torch.tensor(A2), iters=4, x0=torch.tensor(X_ref))
    assert float(rt) < TOL and float(rj) < TOL
    _agree(Xt, Xj, scale)

    _, rj = jspd._ns_packed_pallas(jnp.asarray(A2), iters=0, x0=jnp.asarray(X_ref),
                                   resid_only=True, interpret=True)
    Xt, rt = tspd.ns_packed(torch.tensor(A2), iters=0, x0=torch.tensor(X_ref),
                            resid_only=True)
    assert Xt is None
    assert abs(float(rt) - float(rj)) < AGREE


def test_psd_route_warm_probe_and_fallbacks():
    """inv_one_plus_psd on float32: probe accept, probe reject + refine,
    garbage carry -> cold, against exact inverses."""
    R = 16
    A = torch.tensor(_psd((2, 3), R, 0.5, seed=2))
    X_ref = np.linalg.inv(np_of(A).astype(np.float64) + np.eye(R))
    X = tspd.inv_one_plus_psd(A, iters=16)
    assert X.shape == A.shape and tspd.ROUTE_CALLS["packed"] == 1
    assert np.abs(np_of(X) - X_ref).max() < 1e-4
    assert torch.equal(tspd.inv_one_plus_psd(A, warm=X), X)  # probe accepts
    X2 = tspd.inv_one_plus_psd(A * 1.02, warm=X, warm_iters=4)
    assert np.abs(np_of(X2) - np.linalg.inv(np_of(A * 1.02).astype(np.float64)
                                            + np.eye(R))).max() < 1e-4
    Xg = tspd.inv_one_plus_psd(A, warm=torch.full_like(A, 100.0), warm_iters=3)
    assert np.abs(np_of(Xg) - X_ref).max() < 1e-4
    assert tspd.FALLBACKS["packed_probe_reject"] == 2
    assert tspd.FALLBACKS["packed_refine_fail"] == 1


def test_cold_escalates_then_exact_net():
    """lambda_max ~4e4: 16 cold iterations miss the tolerance and one
    escalation recovers (tests/test_spd.py:55); with 2 iterations the
    escalation misses too and the exact Cholesky answers."""
    A = torch.tensor(_psd((3,), 16, 1e3, seed=7))
    X_ref = np.linalg.inv(np_of(A).astype(np.float64) + np.eye(16))
    X = tspd.inv_one_plus_psd(A, iters=16)
    assert tspd.FALLBACKS["packed_escalate"] == 1 and tspd.FALLBACKS["packed_exact"] == 0
    assert np.abs(np_of(X) - X_ref).max() < 5e-3
    X = tspd.inv_one_plus_psd(A, iters=2)
    assert tspd.FALLBACKS["packed_escalate"] == 2 and tspd.FALLBACKS["packed_exact"] == 1
    assert np.abs(np_of(X) - X_ref).max() < 5e-3

    G, w, X_ref = _gram_problem(seed=17, scale=1e3)
    X = tspd.inv_one_plus_gram(torch.tensor(G), torch.tensor(w), iters=1)
    assert tspd.FALLBACKS["gram_escalate"] == 1 and tspd.FALLBACKS["gram_exact"] == 1
    assert _resid(_gram_A(G, w), X) < TOL


def test_cuda_wrappers_refuse_what_the_kernel_does_not_take():
    """The kernel wrappers raise on CPU tensors (CPU tensors take the
    plain version in ns_gram / ns_packed) and on shapes past R = 128."""
    G, w, _ = _gram_problem()
    with pytest.raises(ValueError, match="CUDA"):
        tspd._ns_gram_cuda(torch.tensor(G), torch.tensor(w))
    # both designs of ns_gram, whichever the (T, R) rule would pick
    for design in ("per_matrix", "pairs"):
        with pytest.raises(ValueError, match="CUDA"):
            tspd._ns_gram_cuda(torch.tensor(G), torch.tensor(w), want_v=True, design=design)
    with pytest.raises(ValueError, match="unknown ns_gram design"):
        tspd._ns_gram_cuda(torch.tensor(G), torch.tensor(w), design="plain")
    with pytest.raises(ValueError, match="CUDA"):
        tspd._ns_packed_cuda(torch.tensor(_psd((2,), 8)))
    with pytest.raises(ValueError, match="R <= 128"):
        tspd._ns_packed_cuda(torch.zeros((1, 130, 130)))
    with pytest.raises(ValueError, match="resid_only"):
        tspd._ns_gram_cuda(torch.tensor(G), torch.tensor(w), resid_only=True)
    A = torch.tensor(_psd((2,), 8))
    with pytest.raises(ValueError, match="probe_skip"):
        tspd._ns_packed_cuda(A, x0=None, probe_skip=True)
    with pytest.raises(ValueError, match="CUDA"):
        tspd._ns_packed_cuda(A, x0=A, probe_skip=True)
    with pytest.raises(ValueError, match="CUDA"):
        tspd._spd_inverse_cuda(A + torch.eye(8))
    with pytest.raises(ValueError, match="R <= 128"):
        tspd._spd_inverse_cuda(torch.zeros((1, 130, 130)))
    assert set(tspd.KERNEL_LAUNCHES.values()) == {0}


# ------------------------------------ float32: probe_skip (fused probe) --


def _probe_skip_case(R, B, seed, scale, drift):
    """Carries as in tests/test_spd.py:102-140: the exact inverse for every
    group, ``drift`` (a function of the carry) applied to the second."""
    A = _psd((B,), R, scale, seed=seed)
    X_exact = np.linalg.inv(A + np.eye(R, dtype=np.float32)).astype(np.float32)
    x0 = X_exact.copy()
    per = tspd._probe_skip_groups(R)
    x0[per:] = drift(x0[per:])
    return A, X_exact, x0, per


@pytest.mark.parametrize("case", ["mixed", "all_converged", "nan_carry"])
def test_probe_skip_matches_pallas(case):
    """The converged group returns x0 bit for bit; the drifted group is
    refined to within 1e-5 of max|X| of the float64 inverse (the Pallas
    kernel's bf16x3 products land 5e-5 from it, so the two packages are held
    to each other at AGREE); a NaN carry routes its group to the refine,
    whose residual stays NaN."""
    if case == "all_converged":
        A, X_exact, x0, per = _probe_skip_case(16, 6, 10, 0.5, lambda x: x)
        iters = 8
    else:
        drift = (lambda x: x * 0.5) if case == "mixed" else \
            (lambda x: np.where(np.arange(len(x))[:, None, None] == 1, np.nan, x))
        A, X_exact, x0, per = _probe_skip_case(40, 2 * 36, 9, 0.3, drift)
        iters = 10
    assert per == jspd._packed_geometry(len(A), A.shape[-1], tiles=12)[2]
    Xj, rj = jspd._ns_packed_pallas(jnp.asarray(A), iters=iters, x0=jnp.asarray(x0),
                                    probe_skip=True, interpret=True)
    Xt, rt = tspd.ns_packed(torch.tensor(A), iters=iters, x0=torch.tensor(x0),
                            probe_skip=True)
    Xj, Xt = np.asarray(Xj), np_of(Xt)
    np.testing.assert_array_equal(Xt[:per], x0[:per])
    np.testing.assert_array_equal(Xj[:per], x0[:per])
    if case == "nan_carry":
        assert np.isnan(float(rt)) and np.isnan(float(rj))
        return
    assert float(rt) < TOL and float(rj) < TOL
    if case == "mixed":
        X64 = np.linalg.inv(A.astype(np.float64) + np.eye(A.shape[-1]))
        err = np.abs(Xt[per:] - X64[per:]).max()
        assert err <= 1e-5 * np.abs(X_exact).max(), err
        _agree(Xt[per:], Xj[per:], np.abs(X_exact).max())
    assert tspd.KERNEL_LAUNCHES["probe_skip"] == 0


def test_psd_route_with_fused_probe(monkeypatch):
    """inv_one_plus_psd's warm branch under VLGP_FUSED_PROBE: an accepted
    carry comes back as is, a drifted one is refined, and garbage fails the
    refine and lands on the cold route."""
    monkeypatch.setattr(tspd, "_FUSED_PROBE", True)
    R = 16
    A = torch.tensor(_psd((2, 3), R, 0.5, seed=2))
    X = tspd.inv_one_plus_psd(A, iters=16)
    assert torch.equal(tspd.inv_one_plus_psd(A, warm=X), X)
    A2 = A * 1.02
    X2 = tspd.inv_one_plus_psd(A2, warm=X, warm_iters=4)
    ref2 = np.linalg.inv(np_of(A2).astype(np.float64) + np.eye(R))
    assert np.abs(np_of(X2) - ref2).max() < 1e-4
    Xg = tspd.inv_one_plus_psd(A, warm=torch.full_like(A, 100.0), warm_iters=3)
    assert torch.allclose(Xg, X, atol=1e-5)
    assert tspd.FALLBACKS["packed_refine_fail"] == 1
    assert tspd.FALLBACKS["packed_probe_reject"] == 0


# ------------------------------------------- float32: spd_inverse / solve --


def _spd(B, R, seed):
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(B, R, R)).astype(np.float32)
    return (np.einsum("brk,bqk->brq", G, G) / R + np.eye(R, dtype=np.float32)).astype(np.float32)


@pytest.mark.parametrize("R", [1, 3, 16, 33, 40, 64, 65, 128])
def test_spd_inverse_matches_pallas(R):
    """Every route against the Pallas kernel in interpret mode, across the
    CUDA kernel's team boundaries (32, 64 and 65); the kernel route above
    the automatic R <= 64 needs force="pallas"."""
    A = _spd(5, R, seed=20 + R)
    ref = np.asarray(jspd.spd_inverse(jnp.asarray(A), force="interpret"))
    scale = np.abs(ref).max()
    for force in (None, "xla", "interpret", "pallas"):
        got = tspd.spd_inverse(torch.tensor(A), force=force)
        assert got.shape == A.shape and got.dtype == torch.float32
        err = np.abs(np_of(got) - ref).max()
        assert err <= 1e-4 * scale, (force, err, scale)
    # the batch shape is kept and the kernel route never launches on the CPU
    got = tspd.spd_inverse(torch.tensor(A.reshape(5, 1, R, R)))
    assert got.shape == (5, 1, R, R)
    assert tspd.KERNEL_LAUNCHES["spd_inverse"] == 0


@pytest.mark.parametrize("R", [16, 65])
def test_spd_inverse_nan_stays_in_its_matrix(R):
    """One NaN entry in the middle matrix of three gives NaN only in that
    matrix's output, in the port's plain version and in the Pallas kernel
    (interpret mode); the other two match as before."""
    A = _spd(3, R, seed=40 + R)
    A[1, R // 2, R // 3] = A[1, R // 3, R // 2] = np.nan
    ref = np.asarray(jspd.spd_inverse(jnp.asarray(A), force="interpret"))
    assert np.isnan(ref[1]).any() and np.isfinite(ref[[0, 2]]).all()
    scale = np.abs(ref[[0, 2]]).max()
    for force in ("interpret", "pallas"):
        got = np_of(tspd.spd_inverse(torch.tensor(A), force=force))
        assert np.isnan(got[1]).any(), force
        assert np.isfinite(got[[0, 2]]).all(), force
        assert np.abs(got[[0, 2]] - ref[[0, 2]]).max() <= 1e-4 * scale, force


def test_spd_inverse_plain_follows_the_kernel():
    """The plain version is the kernel's algorithm, not torch.linalg: a
    negative pivot d is clamped at 1e-30, so the factor's diagonal is
    d / sqrt(1e-30) and the "inverse" entry 1e-30 (finite), where the
    exact route's Cholesky fails."""
    A = np.diag(np.array([2.0, -1.0, 3.0], np.float32))[None]
    out = np_of(tspd.spd_inverse(torch.tensor(A), force="interpret"))
    ref = np.asarray(jspd.spd_inverse(jnp.asarray(A), force="interpret"))
    np.testing.assert_allclose(out[0, 0, 0], 0.5, rtol=1e-6)
    assert np.isfinite(out).all() and 0 < out[0, 1, 1] < 1e-29
    np.testing.assert_allclose(out, ref, rtol=1e-5)
    assert torch.isnan(tspd.spd_inverse(torch.tensor(A), force="xla")).all()


def test_spd_solve_matches_jax():
    A = _spd(3, 12, seed=5)
    b = np.random.default_rng(6).normal(size=(3, 12)).astype(np.float32)
    ref = np.asarray(jspd.spd_solve(jnp.asarray(A), jnp.asarray(b)))
    got = tspd.spd_solve(torch.tensor(A), torch.tensor(b))
    assert np.abs(np_of(got) - ref).max() <= 1e-4 * np.abs(ref).max()


def test_build_hash_covers_every_source_and_header(tmp_path, monkeypatch):
    """An edit to any kernel source or to the shared header renames every
    library, so a stale build is never loaded."""
    from vlgp_tpu_torch.ops import _build

    for src in _build.CSRC.glob("*.cu*"):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    digests = {_build._digest()}
    assert {f"{n}.cu" for n in _build.SOURCES} <= {p.name for p in tmp_path.iterdir()}
    for name in sorted(p.name for p in tmp_path.iterdir()):
        with open(tmp_path / name, "a") as f:
            f.write("\n// edited\n")
        digests.add(_build._digest())
    assert len(digests) == 1 + len(list(tmp_path.iterdir()))
