"""Least work of one ``estep_project`` call (the E-step's stage a: the
predictor, the rates, the masked working residual and s = residual a') for B
members on S segments of T bins, Y channels, Z latents.  FMAs: 3 Z a row and
channel (the predictor, the rates' argument and the channel sum).  Bytes
(float32): y and the regressor term read once (shared by the members), the
mask, each member's mu and v, the loading, the channel flags and noise, the
members' channel weights, s written once."""


def least(Z, S, T, Y, B=1, nbytes=4):
    N, M = S * T, B * S * T
    fma = 3 * Z * M * Y
    return fma, nbytes * (2 * N * Y + N + 2 * Z * M + Z * Y + Y + (B * Y if B > 1 else 0)
                          + Z * M) + Y
