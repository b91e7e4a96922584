"""Evaluation: timers, model log-likelihood and the ELBO by term
(counterpart of ``vlgp_tpu/evaluation.py``; reference ``vlgp/evaluation.py``).

Functions on tensors run on the device of those tensors; ``elbo_terms``
builds its Woodbury inverses with the E-step's ``_woodbury_inverse``, so a
float32 CUDA state goes through the ``ns_packed`` kernel.
"""
from __future__ import annotations

import math
import time
from contextlib import contextmanager

import numpy as np
import torch

from .models.vlgp import _woodbury_inverse, _zmajor

__all__ = ["timer", "loglik", "poisson_loglik", "elbo_terms"]


@contextmanager
def timer():
    """Wall-clock timer context (evaluation.py:7-11); the elapsed closure is
    valid both inside and after the block."""
    tick = time.perf_counter()
    state = {"tock": None}
    try:
        yield lambda: (state["tock"] or time.perf_counter()) - tick
    finally:
        state["tock"] = time.perf_counter()


def poisson_loglik(y, eta):
    """Poisson log-likelihood sum(y * eta - exp(eta)) up to the y! constant."""
    return torch.sum(y * eta - torch.exp(eta))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def loglik(fit) -> float:
    """Poisson log-likelihood of a fit, sum(y * eta - exp(eta)) (the
    reference's evaluation.py:14-19 exponentiates twice, SURVEY §2).

    Accepts a :class:`~vlgp_tpu_torch.api.FitResult` (computed on its
    device) or a reference-style dict ``{"trials": [...], "params": ...}``
    (computed in NumPy on the host).
    """
    if hasattr(fit, "data"):
        data, params = fit.data, fit.params
        eta = torch.einsum("stz,zy->sty", data.mu, params.a) + torch.einsum(
            "stxy,xy->sty", data.x, params.b)
        return float(torch.sum((data.y * eta - torch.exp(eta)) * data.mask[..., None]))
    trials, params = fit["trials"], fit["params"]
    a = _np(params["a"] if isinstance(params, dict) else params.a)
    b = _np(params["b"] if isinstance(params, dict) else params.b)
    total = 0.0
    for t in trials:
        x = np.asarray(t["x"])
        xb = np.einsum("txy,xy->ty", x, b) if x.ndim == 3 else x @ b
        eta = np.asarray(t["mu"]) @ a + xb
        total += float(np.sum(t["y"] * eta - np.exp(eta)))
    return total


def _gp_bucket_term(G_L, mu_sel, X_sel, eps_total: float, nsel: int):
    """GP prior expectation for one length bucket, trials pooled at their
    true length Lt.  G_L (Z, Lt, R); mu_sel (Z, nsel, Lt); X_sel (Z, R, R)
    summed Woodbury inverses.  Returns (term, nsel * sum of the prior
    half-logdets): the one logdet serves both the prior term and the
    entropy, so their large opposite parts cancel exactly in the ELBO."""
    Lt = G_L.shape[1]
    Mbar = torch.einsum("znt,znu->ztu", mu_sel, mu_sel)
    C = Mbar + torch.einsum("ztr,zrq,zuq->ztu", G_L, X_sel, G_L)
    K = torch.einsum("ztr,zur->ztu", G_L, G_L) + eps_total * torch.eye(
        Lt, dtype=G_L.dtype, device=G_L.device)
    Lc = torch.linalg.cholesky(K)
    half = torch.linalg.solve_triangular(Lc, C, upper=False)
    Kinv_C = torch.linalg.solve_triangular(Lc.mT, half, upper=True)
    logdet = torch.sum(torch.log(torch.diagonal(Lc, dim1=-2, dim2=-1)), dim=-1)
    term = torch.sum(-0.5 * torch.diagonal(Kinv_C, dim1=-2, dim2=-1).sum(-1) - nsel * logdet)
    return term, nsel * torch.sum(logdet)


def elbo_terms(data, params, G, gp_reg: float = 1e-6) -> dict:
    """Evidence lower bound of the fitted model, by term
    (``vlgp_tpu.evaluation.elbo_terms``).

    Returns Python floats: the expected log-likelihoods ``poisson_ll`` and
    ``gaussian_ll``, the GP prior expectation ``gp_prior_ll`` (posterior
    covariances rebuilt from the stored weights by the low-rank Woodbury
    identity S = G (I + G'WG)^{-1} G'), the posterior ``entropy`` (1/2
    logdet of each posterior, logdet K + logdet X), and their sum
    ``elbo``, up to constants independent of q and the parameters.
    Ragged trials are pooled per distinct length and each bucket is scored
    against the prior restricted to its true length, so every trial counts
    its own grid.
    """
    mask = data.mask[..., None]
    eta = torch.einsum("stz,zy->sty", data.mu, params.a) + torch.einsum(
        "stxy,xy->sty", data.x, params.b)
    quad = 0.5 * torch.einsum("stz,zy->sty", data.v, params.a ** 2)
    rate = torch.exp(eta + quad)
    zero = torch.zeros((), dtype=eta.dtype, device=eta.device)
    pois_ll = torch.sum(torch.where(params.poisson, data.y * eta - rate, zero) * mask)
    gauss = ~params.poisson
    resid = torch.where(gauss, data.y - eta, zero) * mask
    gauss_ll = -0.5 * torch.sum(torch.where(
        gauss, resid ** 2 / params.noise + torch.log(2 * math.pi * params.noise) * mask, zero))

    muz = _zmajor(data.mu) * data.mask[None]
    wz = _zmajor(data.w) * data.mask[None]
    X = _woodbury_inverse(G, wz)  # (Z, N, R, R)

    # one bucket per distinct trial length: a trial of true length L has
    # nonzero mu/w only in its first L rows, and X built on the padded grid
    # equals the one built on G[:, :L], so the L-prefix is exact
    lengths = data.lengths.cpu().numpy()
    eps_total = params.gp_noise + gp_reg
    gp_ll = zero
    prior_half_logdet = zero
    for L_true in np.unique(lengths):
        sel = torch.from_numpy(np.nonzero(lengths == L_true)[0]).to(X.device)
        Lt = int(L_true)
        term, half_logdet = _gp_bucket_term(
            G[:, :Lt, :], muz[:, sel, :Lt], torch.sum(X[:, sel], dim=1), eps_total, len(sel))
        gp_ll = gp_ll + term
        prior_half_logdet = prior_half_logdet + half_logdet
    # H(q) = 1/2 (logdet K + logdet X) per (latent, trial), logdet X from
    # the Cholesky factor of the SPD X (a batched LU, as slogdet runs it,
    # takes several times longer on the card); fully masked padding
    # contributes 0 (w = 0 there makes X = I)
    LX = torch.linalg.cholesky(X)
    entropy = torch.sum(torch.log(torch.diagonal(LX, dim1=-2, dim2=-1))) + prior_half_logdet

    out = {
        "poisson_ll": float(pois_ll),
        "gaussian_ll": float(gauss_ll),
        "gp_prior_ll": float(gp_ll),
        "entropy": float(entropy),
    }
    out["elbo"] = (out["poisson_ll"] + out["gaussian_ll"]
                   + out["gp_prior_ll"] + out["entropy"])
    return out
