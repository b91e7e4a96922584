"""Least work of one ``hstep_search`` call: Z latents times the search's
evaluations (a grid of ``grid`` candidates, the two golden points, one a
shrink), each the least work of the GP prior's objective on a T x T kernel:
its Cholesky ((T^3 - T) / 6 FMAs), K^-1 from L ((T^3 - T) / 3) and
tr(K^-1 C) (T^2).  Bytes (float32): C read once, the argument written."""


def evaluations(grid, iters):
    return (grid if grid >= 3 else 0) + 2 + iters


def least(Z, T, evals, nbytes=4):
    return Z * evals * ((T ** 3 - T) // 2 + T * T), nbytes * (Z * T * T + 5 * Z)
