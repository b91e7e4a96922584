"""Least work of one ``ns_gram`` call, X = (I + G' diag(w) G)^-1 for each of
Z S (latent, segment) pairs, and v = diag(G X G') where the call writes it:
the function's work, not a design's.  FMAs: the Gram's T P over the
P = R (R + 1) / 2 pairs of its upper triangle, one SPD inverse by Cholesky
((R^3 - R) / 6 for the factor, (R^3 - R) / 3 for L^-T L^-1), and T P more for
v.  Bytes (float32): G and w read once, one residual a matrix written, v
written.  X itself is not counted: a call in probe mode writes none, and the
trace cannot tell the modes apart, so the count is the lower one."""


def least(Z, S, T, R, want_v=False, nbytes=4):
    """(FMAs, bytes) of one call."""
    P = R * (R + 1) // 2
    fma = Z * S * (T * P + (R ** 3 - R) // 2 + (T * P if want_v else 0))
    return fma, nbytes * (Z * T * R + Z * S * T + Z * S + (Z * S * T if want_v else 0))


def v_part(Z, S, T, R, nbytes=4):
    """(FMAs, bytes) that writing v adds to a call."""
    return Z * S * T * (R * (R + 1) // 2), nbytes * Z * S * T
