"""The plain version of the H-step's statistic kernel
(``vlgp_tpu_torch/ops/hstat.py``) against ``vlgp_tpu``'s einsums in float64,
the CPU dispatch, the NaN semantics the kernel copies, and the CUDA
wrapper's refusals.  The kernel itself runs on the card only
(``chip_smoke.py``, 6d); these tests hold the arithmetic that it is
compared with there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlgp_tpu_torch.ops import hstat as oh
from vlgp_tpu_torch.ops import spd as tspd

from _torch_parity import assert_close

torch.set_num_threads(1)

_NAMES = ("sum_QP", "sum_X", "sum_QA")


def _stat_inputs(Z=2, S=7, T=13, R=5, eps=1e-3, seed=0):
    """float64 G (Z, T, R), w~ (Z, S, T), X (Z, S, R, R) and valid (S,):
    segment 2 fully masked (valid 0), segment 4 ragged (where S > 4); X the Woodbury
    inverses (I + G' diag(w~) G)^-1 with a small asymmetric perturbation,
    as Newton-Schulz leaves them."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(Z, T, R)) * 0.7
    w = rng.uniform(0.1, 3.0, size=(Z, S, T))
    mask = np.ones((S, T))
    if S > 4:
        mask[2] = 0.0
        mask[4, T // 2:] = 0.0
    wm = w * mask[None]
    wt2 = wm / (1.0 + eps * wm)
    A = np.einsum("ztr,zst,ztq->zsrq", G, wt2, G)
    X = np.linalg.inv(np.eye(R) + A) + 1e-9 * rng.normal(size=(Z, S, R, R))
    valid = mask.max(axis=1)
    return G, wt2, X, valid


def _jax_stat(G, wt2, X, valid):
    """The three sums as vlgp_tpu/models/gp.py:435-450 forms them."""
    G, wt2, X, valid = map(jnp.asarray, (G, wt2, X, valid))
    P = wt2[..., None] * G[:, None]
    Q = jnp.einsum("zstr,zsrq->zstq", P, X)
    return [jnp.einsum("s,zstr,zsur->ztu", valid, Q, P),
            jnp.einsum("s,zsrq->zrq", valid, X),
            jnp.einsum("s,zstr->ztr", valid, P - Q)]


def test_hstep_stat_plain_matches_jax():
    """_hstep_stat_plain against vlgp_tpu's einsums on Z2 S7 T13 R5 with a
    fully masked and a ragged segment, float64 at 1e-12; the wrapper on CPU
    tensors is the plain version bit for bit."""
    args = _stat_inputs()
    ref = _jax_stat(*args)
    targs = [torch.tensor(t) for t in args]
    got = oh._hstep_stat_plain(*targs)
    for name, g, r in zip(_NAMES, got, ref):
        assert g.shape == r.shape, name
        assert_close(g, np.asarray(r), rtol=1e-12, atol=1e-12, err_msg=name)
    via = oh.hstep_stat(*targs)
    assert all(torch.equal(p, q) for p, q in zip(via, got))


@pytest.mark.parametrize("Z,S,T,R", [(1, 1, 1, 1), (2, 7, 13, 13), (1, 5, 50, 40), (1, 3, 64, 64)])
def test_hstep_stat_plain_matches_jax_at_kernel_edges(Z, S, T, R):
    """The plain version against vlgp_tpu's einsums at the T <= 64 kernel's
    edge shapes on the card (T = 1, 13, 50 and 64; R = 1, T, 40), float64
    at 1e-12, with a fully masked and a ragged segment where S > 4."""
    args = _stat_inputs(Z=Z, S=S, T=T, R=R)
    ref = _jax_stat(*args)
    for name, g, r in zip(_NAMES, oh.hstep_stat(*[torch.tensor(t) for t in args]), ref):
        assert g.shape == r.shape, name
        assert_close(g, np.asarray(r), rtol=1e-12, atol=1e-12, err_msg=name)


def test_hstep_stat_nan_stays_in_its_latent():
    """A NaN w~ in a segment with valid 0 poisons its latent's sums (valid
    multiplies, 0 * NaN), as the kernel must too; the other latent stays
    finite.  One latent, one segment, one edge shape (T = R = 1)."""
    G, wt2, X, valid = (torch.tensor(t) for t in _stat_inputs())
    wt2 = wt2.clone()
    wt2[1, 2] = float("nan")  # segment 2 has valid 0
    qp, sx, qa = oh.hstep_stat(G, wt2, X, valid)
    assert bool(torch.isnan(qp[1]).all()) and bool(torch.isnan(qa[1]).all())
    assert bool(torch.isfinite(sx[1]).all())  # X carries no NaN here
    assert all(bool(torch.isfinite(t[0]).all()) for t in (qp, sx, qa))
    one = [torch.tensor(t) for t in _stat_inputs(Z=1, S=1, T=1, R=1)]
    ref = _jax_stat(*[t.numpy() for t in one])
    for name, g, r in zip(_NAMES, oh.hstep_stat(*one), ref):
        assert_close(g, np.asarray(r), rtol=1e-12, atol=1e-12, err_msg=name)


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    """The launch path raises on CPU tensors (the dispatcher gives those to
    the plain version), on float16 and on shapes that do not fit, and
    launches nothing."""
    before = tspd.KERNEL_LAUNCHES["hstep_stat"]
    targs = [torch.tensor(t) for t in _stat_inputs()]
    with pytest.raises(ValueError, match="CUDA"):
        oh._hstep_stat_cuda(*targs)
    with pytest.raises(TypeError, match="float32 or float64"):
        oh._hstep_stat_cuda(*[t.half() for t in targs])
    with pytest.raises(ValueError, match="shape"):
        oh.hstep_stat(targs[0], targs[1][:, :, :4], *targs[2:])
    with pytest.raises(ValueError, match="shape"):
        oh.hstep_stat(*targs[:3], targs[3][:5])
    assert tspd.KERNEL_LAUNCHES["hstep_stat"] == before
