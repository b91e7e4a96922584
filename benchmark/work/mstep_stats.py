"""Least work of one Newton iteration's statistics in the Poisson M-step:
the predictor, the rates' argument, C1 and C2 (4 Z a row and channel), the
Hessian's three pair sums (3 Z^2) and the bias's (1).  Bytes (float32): y, mu
and v read once, the statistics written."""


def least(Z, N, Y, nbytes=4):
    return (4 * Z + 3 * Z * Z + 1) * N * Y, nbytes * (N * Y + 2 * Z * N + Y * (5 + 3 * Z * Z))
