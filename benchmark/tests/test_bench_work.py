"""Each least-work count at one small shape against a count made by hand
(explicit loops over the operations)."""
import pytest
from conftest import BENCH

import harness


def work(name):
    return harness.load_module(BENCH / "work" / f"{name}.py")


def cholesky_fmas(R):
    """Multiply-adds of a textbook Cholesky."""
    n = 0
    for j in range(R):
        n += j  # the diagonal's sum of squares
        n += (R - 1 - j) * j  # each row below: its dot product with row j
    return n


def inverse_from_factor_fmas(R):
    """Multiply-adds of L^-1 (trtri) and then L^-T L^-1 (lauum)."""
    trtri = sum(i - j for j in range(R) for i in range(j + 1, R))
    lauum = sum(R - 1 - i for i in range(R) for j in range(i + 1))
    return trtri + lauum


@pytest.mark.parametrize("R", [2, 3, 4, 7])
def test_cholesky_counts(R):
    assert cholesky_fmas(R) == (R ** 3 - R) // 6
    assert inverse_from_factor_fmas(R) == (R ** 3 - R) // 3


@pytest.mark.parametrize("Z,S,T,R", [(1, 1, 2, 2), (2, 3, 5, 4)])
def test_ns_gram(Z, S, T, R):
    gram = sum(1 for _ in range(Z * S) for t in range(T) for i in range(R) for j in range(i, R))
    inv = Z * S * ((R ** 3 - R) // 6 + (R ** 3 - R) // 3)
    v = gram  # v_t = sum over the pairs of Xp[p] G[t, i] G[t, j]
    W = work("ns_gram")
    fma, nbytes = W.least(Z, S, T, R)
    assert fma == gram + inv
    assert nbytes == 4 * (Z * T * R + Z * S * T + Z * S)
    fma_v, nbytes_v = W.least(Z, S, T, R, want_v=True)
    assert fma_v == gram + inv + v and nbytes_v == nbytes + 4 * Z * S * T
    assert W.v_part(Z, S, T, R) == (v, 4 * Z * S * T)


def test_estep_project_and_step():
    Z, S, T, Y, R, B = 1, 1, 2, 3, 2, 1
    rows = B * S * T
    # predictor, rates' argument and the channel sum: 3 FMAs a (latent, row, channel)
    assert work("estep_project").least(Z, S, T, Y, B)[0] == 3 * Z * rows * Y
    # + G's two products with s and w u (2 T R each), X (R^2), G M (T R), u from G (T R)
    step = 3 * Z * rows * Y + Z * B * S * (4 * T * R + R * R)
    assert work("estep_step").least(Z, S, T, Y, R, B)[0] == step
    # members share y and the regressor term: one read, not B
    one = work("estep_project").least(Z, S, T, Y, 1)[1]
    two = work("estep_project").least(Z, S, T, Y, 2)[1]
    assert two - one == 4 * (3 * Z * S * T + 2 * Y)


def test_hstep_search():
    W = work("hstep_search")
    assert W.evaluations(13, 24) == 39 and W.evaluations(0, 24) == 26
    T = 3
    chol, inv = (T ** 3 - T) // 6, (T ** 3 - T) // 3
    trace = T * T  # tr(K^-1 C): the elementwise product summed
    assert W.least(2, T, 5)[0] == 2 * 5 * (chol + inv + trace)


def test_hstep_stat_and_mstep():
    Z, S, T, R = 1, 2, 3, 2
    q = S * T * R * R  # Q = P X
    qp = S * T * T * R  # sum_s Q_s P_s'
    assert work("hstep_stat").least(Z, S, T, R)[0] == Z * (q + qp)
    Zm, N, Y = 2, 3, 4
    per = 4 * Zm + 3 * Zm * Zm + 1
    assert work("mstep_stats").least(Zm, N, Y)[0] == per * N * Y
