"""Least work of one ``estep_step`` call (the E-step's stages b-c: the
Woodbury step u - G X G'(w u) at the carried weights, the clip, mu + delta
and the weights under the new mu) for B members on S segments.  FMAs: the
predictor, rates and weights (3 Z a row and channel) and the step (4 Z T R +
Z R^2 a segment).  Bytes (float32): G, X, s, mu, w and v read once, the
mask, loading, regressor term and flags, mu, delta and w written."""


def least(Z, S, T, Y, R, B=1, nbytes=4):
    N, M = S * T, B * S * T
    fma = 3 * Z * M * Y + Z * B * S * (4 * T * R + R * R)
    return fma, nbytes * (Z * T * R + 4 * Z * M + Z * B * S * R * R + N + Z * Y + N * Y + Y
                          + (B * Y if B > 1 else 0) + 3 * Z * M) + Y
