"""Least work of one ``hstep_stat`` call (the H-step's pooled statistic:
P = diag(w) G, Q = P X and the sums over segments of Q P', X and P - Q):
FMAs Z S T R (R + T); bytes (float32) of G, w, X and the flags read once
and the three sums written once."""


def least(Z, S, T, R, nbytes=4):
    return (Z * S * T * R * (R + T),
            nbytes * (Z * T * R + Z * S * T + Z * S * R * R + S + Z * (T * T + T * R + R * R)))
