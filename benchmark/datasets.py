"""Inputs of a run, made from ``--seed`` with NumPy: each dataset is a list of
trial dicts as users hand them to ``fit``, beside the loading and the true
latents that generated it."""
from __future__ import annotations

import numpy as np


def true_latents(bins: int, latents: int, freq: dict) -> np.ndarray:
    """(bins, latents): latent i is sin(linspace(0, base + step i, bins))."""
    return np.stack([np.sin(np.linspace(0, freq["base"] + freq["step"] * i, bins))
                     for i in range(latents)], 1)


def make_datasets(data: dict, seed: int, count: int) -> list:
    """``count`` datasets of one model: the loading ~ N(0, loading_sd^2) drawn
    from ``np.random.default_rng(loading_seed)``, the same for every seed;
    then, drawn in order from ``np.random.default_rng(seed)``, counts y ~
    Poisson(exp(z a + bias)) and an initial posterior mean ~ N(0,
    mu_init_sd^2) for every trial.  So every seed poses the same problem with
    fresh noise.  Returns [{"trials", "a", "z"}] in float32, z being one
    trial's true latents (the same in every trial)."""
    n, T, Y, Z = data["trials"], data["bins"], data["neurons"], data["latents"]
    a = (np.random.default_rng(data["loading_seed"]).normal(size=(Z, Y))
         * data["loading_sd"]).astype(np.float32)
    rng = np.random.default_rng(seed)
    z = true_latents(T, Z, data["freq"])
    out = []
    for _ in range(count):
        y = rng.poisson(np.exp(z @ a + data["bias"]), size=(n, T, Y)).astype(np.float32)
        mu = (rng.normal(size=(n, T, Z)) * data["mu_init_sd"]).astype(np.float32)
        out.append({"trials": [{"y": y[i], "mu": mu[i]} for i in range(n)], "a": a, "z": z})
    return out


def r2_aligned(mu: np.ndarray, zt: np.ndarray) -> float:
    """R^2 of the true latents zt (N, Z) on the posterior mean mu (N, Z)
    after the least-squares affine map that aligns them."""
    X = np.column_stack([mu, np.ones(len(mu))])
    beta, *_ = np.linalg.lstsq(X, zt, rcond=None)
    return float(1 - np.sum((X @ beta - zt) ** 2) / np.sum((zt - zt.mean(0)) ** 2))
