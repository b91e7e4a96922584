"""The schedule of the clustered ``hstep_search`` kernel (``csrc/hstep.cu``)
against ``_golden_min``, on the CPU.

The kernel runs a search on a cluster of nb blocks per latent in rounds:
the grid's candidates side by side, then c, d and every point the next
shrinks can reach, then trees of the points of the next m shrinks, the
blocks exchanging their objectives after each round and walking the
search with them.  The kernel runs on the card only; ``_cluster_golden_min``
below is that schedule in torch, one batched call of the objective per
round, and every test holds it bit for bit against the chain that
``ops/golden._golden_min`` runs, which is what the kernel's result must
equal at every nb (``chip_smoke.py`` 6c checks that on the card).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlgp_tpu.models import gp as jgp
from vlgp_tpu_torch.ops import golden as og

from _torch_parity import assert_close

torch.set_num_threads(1)

PHI = 0.6180339887498949


def _ilog2(x: int) -> int:
    return x.bit_length() - 1


def _rounds(nb, grid, iters, polish):
    """csrc/hstep.cu:rounds, the rounds of one search on nb blocks."""
    r = -(-grid // nb) if grid >= 3 else 0
    if nb == 1:
        r, rem = r + 2, iters
    else:
        r, rem = r + 1, iters - min(_ilog2(nb) - 1, iters)
    depth = _ilog2(nb + 1)
    return r + -(-rem // depth) + int(polish)


def _shrink(lo, hi, c, d, left):
    """One shrink of _golden_min's loop with its comparison given."""
    lo_n = torch.where(left, lo, c)
    hi_n = torch.where(left, d, hi)
    c_n = torch.where(left, hi_n - PHI * (hi_n - lo_n), d)
    d_n = torch.where(left, c, lo_n + PHI * (hi_n - lo_n))
    return lo_n, hi_n, c_n, d_n, torch.where(left, c_n, d_n)


def _take(fc, fd, left, f_new):
    return torch.where(left, f_new, fd), torch.where(left, fc, f_new)


def _path(state, lefts):
    """The point that the shrinks with comparisons ``lefts`` reach from
    ``state`` (lo, hi, c, d)."""
    lo, hi, c, d = state
    for left in lefts:
        lo, hi, c, d, x = _shrink(lo, hi, c, d, left)
    return x


def _bits(k: int, n: int, like):
    """The n bits of k below its leading one, most significant first, as
    comparisons (1: fc < fd)."""
    return [torch.full_like(like, bool((k >> (n - 1 - i)) & 1), dtype=torch.bool)
            for i in range(n)]


def _cluster_golden_min(f, lo, hi, iters, nb, polish=False, grid=0, tiebreak=1e-4):
    """The kernel's schedule on nb blocks: returns (x, points evaluated in
    each round).  A round evaluates at most nb points in one call of f."""
    rounds = []

    def evaluate(points):
        assert 1 <= len(points) <= nb
        rounds.append(len(points))
        return f(torch.stack(points))

    if grid >= 3:
        frac = torch.arange(grid, dtype=lo.dtype) / (grid - 1)
        cand = lo[None] + frac[:, None] * (hi - lo)[None]
        fcand = torch.cat([evaluate(list(cand[i:i + nb])) for i in range(0, grid, nb)])
        bad = torch.isnan(fcand)
        fcand = torch.where(bad, torch.inf, fcand)
        fmin = fcand.amin(dim=0)
        near = fcand <= fmin + tiebreak * fmin.abs()
        best = torch.argmax(near.to(torch.int8), dim=0)
        lo_idx = torch.clamp(best - 1, min=0)
        lo_idx = torch.where(bad.gather(0, lo_idx[None])[0], best, lo_idx)
        hi_idx = torch.clamp(best + 1, max=grid - 1)
        hi_idx = torch.where(bad.gather(0, hi_idx[None])[0], best, hi_idx)
        allbad = bad.all(dim=0)
        lo_b = cand.gather(0, lo_idx[None])[0]
        hi_b = cand.gather(0, hi_idx[None])[0]
        lo, hi = torch.where(allbad, lo, lo_b), torch.where(allbad, lo, hi_b)
    c = hi - PHI * (hi - lo)
    d = lo + PHI * (hi - lo)
    rem = iters
    if nb == 1:  # the chain: c, then d
        fc = evaluate([c])[0]
        fd = evaluate([d])[0]
    else:
        # c, d and every point of the first m shrinks: node k >= 2 on the
        # comparisons of k's bits below its leading one
        m = min(_ilog2(nb) - 1, rem)
        pts = [c, d] + [_path((lo, hi, c, d), _bits(k, _ilog2(k), lo))
                        for k in range(2, 2 << m)]
        ft = evaluate(pts)
        fc, fd = ft[0], ft[1]
        node = torch.ones_like(lo, dtype=torch.long)
        for _ in range(m):
            left = fc < fd
            lo, hi, c, d, _x = _shrink(lo, hi, c, d, left)
            node = 2 * node + left.long()
            fc, fd = _take(fc, fd, left, ft.gather(0, node[None])[0])
        rem -= m
    depth = _ilog2(nb + 1)
    while rem > 0:
        # the next m shrinks: node k >= 1, its first comparison known
        m = min(depth, rem)
        first = fc < fd
        pts = [_path((lo, hi, c, d), [first] + _bits(k, _ilog2(k), lo))
               for k in range(1, 1 << m)]
        ft = evaluate(pts)
        node = torch.ones_like(lo, dtype=torch.long)
        for level in range(m):
            left = fc < fd
            lo, hi, c, d, _x = _shrink(lo, hi, c, d, left)
            if level > 0:
                node = 2 * node + left.long()
            fc, fd = _take(fc, fd, left, ft.gather(0, (node - 1)[None])[0])
        rem -= m
    mid = 0.5 * (lo + hi)
    if not polish:
        return mid, rounds
    fm = evaluate([mid])[0]
    num = (mid - c) ** 2 * (fm - fd) - (mid - d) ** 2 * (fm - fc)
    den = (mid - c) * (fm - fd) - (mid - d) * (fm - fc)
    safe = den.abs() > 1e-30
    x_star = mid - 0.5 * torch.where(safe, num / torch.where(safe, den, 1.0), 0.0)
    ok = safe & (x_star > lo) & (x_star < hi)
    return torch.where(ok, x_star, mid), rounds


def _problem(dtype, T=12, Z=4, seed=1):
    """A statistic C (Z, T, T) like the H-step's; latent 2's is NaN (every
    candidate fails, x = lo), latent 3's gp_noise-free kernel fails
    Cholesky at the smooth end of its box."""
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=(Z, 30, T))
    C = np.einsum("zst,zsu->ztu", mu, mu) + np.eye(T)
    C[2] = np.nan
    lo = np.log(np.array([5e-4, 5e-4, 5e-4, 2e-3]))
    hi = np.log(np.array([5e-1, 5e-2, 5e-1, 2.0]))
    t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    return t(C), t(30.0), t([1.0, 0.7, 1.3, 1.0]), t(lo), t(hi)


def _objective(dtype, profile, gp_noise=1e-4):
    C, nseg, sigsq, lo, hi = _problem(dtype)
    return og._objective(C, nseg, sigsq, gp_noise, 1.0, profile), lo, hi


# (grid, iters, polish, profile_sigma, gp_noise): the flagship's setting
# and around it; gp_noise -1e-3 makes the smooth candidates' Cholesky fail
CASES = [(13, 24, False, True, 1e-4), (0, 7, True, False, 1e-4), (3, 0, False, True, 1e-4),
         (20, 7, True, True, 1e-4), (13, 24, True, False, -1e-3), (20, 24, False, False, 1e-4),
         (0, 0, True, True, 1e-4), (3, 24, False, True, -1e-3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nb", [1, 2, 3, 4, 5, 8, 16])
def test_cluster_schedule_equals_the_chain(nb, dtype):
    """At every cluster size (look-ahead depth 1 to 4, and odd sizes whose
    last level is short), over grids 0, 3, 13 and 20 (more candidates than
    blocks), 0, 7 and 24 shrinks, polish and the profiled sigma on and off,
    an all-NaN latent and candidates whose Cholesky fails: the schedule's x
    equals _golden_min's bit for bit, in the rounds the kernel counts."""
    for grid, iters, polish, profile, gp_noise in CASES:
        f, lo, hi = _objective(dtype, profile, gp_noise)
        ref = og._golden_min(f, lo, hi, iters, polish=polish, grid=grid, tiebreak=1e-4)
        got, rounds = _cluster_golden_min(f, lo, hi, iters, nb, polish=polish, grid=grid)
        case = (grid, iters, polish, profile, gp_noise)
        assert torch.equal(torch.isnan(got), torch.isnan(ref)), case
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(ref)), (case, got, ref)
        assert len(rounds) == _rounds(nb, grid, iters, polish), (case, rounds)
        if grid >= 3:  # the grid collapses the all-NaN latent onto lo
            assert float(got[2]) == float(lo[2])
    f, lo, hi = _objective(dtype, True, -1e-3)
    frac = torch.arange(13, dtype=dtype) / 12
    fcand = f(lo[None] + frac[:, None] * (hi - lo)[None])
    assert bool(torch.isnan(fcand[:, 3]).any()) and not bool(torch.isnan(fcand[:, 3]).all())


def test_flagship_round_counts():
    """The default Config's search (grid 13, 24 shrinks, no polish): 8
    rounds on 16 blocks, 11 on 8, the chain's 39 evaluations on one."""
    assert [_rounds(nb, 13, 24, False) for nb in (16, 8, 4, 2, 1)] == [8, 11, 17, 32, 39]
    f, lo, hi = _objective(torch.float32, True)
    _, rounds = _cluster_golden_min(f, lo, hi, 24, 16, grid=13)
    assert rounds == [13, 16, 15, 15, 15, 15, 15, 1]


def test_cluster_schedule_against_jax():
    """On the flagship's setting in float64, the schedule on 16 blocks
    against vlgp_tpu's _golden_min over its gp_elbo_stats."""
    C, nseg, sigsq, lo, hi = _problem(torch.float64)
    T = C.shape[-1]

    def jf(x):
        out = jgp.gp_elbo_stats(x, jnp.asarray(C.numpy()), 30.0, T,
                                jnp.asarray(sigsq.numpy())[:, None, None], 1e-4, 1.0,
                                profile_sigma=True)
        return -out[0]

    xj = jax.jit(lambda a, b: jgp._golden_min(jf, a, b, 24, grid=13, tiebreak=1e-4))(
        jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy()))
    f = og._objective(C, nseg, sigsq, 1e-4, 1.0, True)
    got, _ = _cluster_golden_min(f, lo, hi, 24, 16, grid=13)
    assert_close(got, np.asarray(xj))
