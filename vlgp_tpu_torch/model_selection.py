"""Model selection: speckled cross-validation over n_factors, and the
leave-one-neuron-out predictive score (counterpart of
``vlgp_tpu/model_selection.py``; reference ``vlgp/model_selection.py``).

Functions on tensors run on the device of those tensors;
``gmap_speckled_cv`` takes trials and a ``device`` (the current CUDA device
when None).  Inner-fit errors propagate (the reference leaves
``training_error`` unbound when an inner fit throws, model_selection.py:43-46).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from .config import _resolve_device
from .data import cut_trials, pack_trials
from .init import initialize
from .models import gpfa
from .models.gp import make_cholesky
from .models.vlgp import estep, update_v, update_w

__all__ = ["speckled_cv", "gmap_speckled_cv", "elementwise_error", "leave_one_neuron_out"]


def elementwise_error(yhat, y):
    """Squared element-wise prediction error (model_selection.py:25-28)."""
    r = yhat - y
    return r * r


def _speckled_cv_masked(y, C, d, R, K, test_mask, max_iter: int) -> Tuple[float, float]:
    """Speckled CV under a given boolean ``test_mask`` (y's shape): fit GPFA
    on the other entries (held-out entries imputed as the mean), score
    both partitions."""
    y = y - torch.mean(y)  # center so 0-imputation is the mean (ms.py:13)
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    y_training = torch.where(test_mask, zero, y)

    z, C, d, R = gpfa.em(y_training, C, d, R, K, max_iter)
    yhat = torch.einsum("mtz,zy->mty", z, C) + d[None, None, :]
    err = elementwise_error(yhat, y)

    training_error = torch.mean(torch.where(test_mask, zero, err)) / torch.mean(
        (~test_mask).to(y.dtype))
    test_error = torch.sum(torch.where(test_mask, err, zero)) / torch.clamp(
        torch.sum(test_mask), min=1)
    return float(training_error), float(test_error)


def speckled_cv(y, C, d, R, K, test_ratio: float, max_iter: int,
                generator: torch.Generator) -> Tuple[float, float]:
    """Speckled CV on one stacked segment set (model_selection.py:11-22):
    masks a random fraction ``test_ratio`` of the entries, drawn from
    ``generator`` (on y's device), fits GPFA on the rest and scores both
    partitions.  Returns (training error, test error)."""
    test_mask = torch.rand(y.shape, generator=generator, dtype=y.dtype,
                           device=y.device) < test_ratio
    return _speckled_cv_masked(y, C, d, R, K, test_mask, max_iter)


def gmap_speckled_cv(
    trials: Sequence[dict],
    n_factors_list: Sequence[int],
    test_ratio: float = 0.1,
    *,
    dt: float,
    var: float,
    scale: float,
    max_iter: int,
    seed: int = 0,
    window: int = 50,
    device=None,
) -> Tuple[list, list]:
    """CV sweep over candidate factor counts (model_selection.py:31-50).
    One generator seeded with ``seed`` draws every FA subsample and test
    mask in turn.  ``device`` defaults to the current CUDA device and
    raises when there is none."""
    device = _resolve_device(device, "gmap_speckled_cv")
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    training_errors, test_errors = [], []
    for n_factors in n_factors_list:
        data = pack_trials(trials, n_factors, device=device)
        _, a0, b0, _, _ = initialize(data, n_factors, generator)
        segments = cut_trials(data, window, seed=seed)
        K = gpfa.make_prior(segments.nbin, dt, var, scale, dtype=segments.y.dtype,
                            device=device)
        R0 = torch.ones(data.ydim, dtype=K.dtype, device=device)
        tr, te = speckled_cv(segments.y, a0, torch.exp(b0), R0, K, test_ratio, max_iter,
                             generator)
        training_errors.append(tr)
        test_errors.append(te)
    return training_errors, test_errors


def leave_one_neuron_out(result, neurons: Sequence[int] | None = None, batch: int = 25):
    """Leave-one-neuron-out predictive score for a fitted model, on the
    result's device.

    For each held-out channel n: infer latents from the *other* channels
    under the fitted parameters, then score channel n's observations under
    the model prediction (Poisson log-likelihood up to the y! constant, or
    Gaussian negative squared error).  The held-out channel is excluded by
    zeroing its loading column, which removes its influence exactly from
    every posterior update (``vlgp_tpu.model_selection._lono_scorer``).

    result: :class:`~vlgp_tpu_torch.api.FitResult`.  Returns
    {neuron: mean predictive log-likelihood per bin}.  ``batch`` is kept
    for signature compatibility: the port scores the neurons one after
    another (the kernel launches cannot be vmapped).
    """
    data, params, config = result.data, result.params, result.config
    ydim = params.ydim
    neurons = [int(n) for n in (range(ydim) if neurons is None else neurons)]
    if not neurons:
        return {}

    G = make_cholesky(data.nbin, params)
    d0 = data.replace(mu=torch.zeros_like(data.mu), w=torch.zeros_like(data.w),
                      v=torch.zeros_like(data.v), dmu=torch.zeros_like(data.dmu))
    m = d0.mask
    nvalid = torch.clamp(torch.sum(m), min=1.0)
    scores = {}
    for n in neurons:
        cmask = (torch.arange(ydim, device=params.a.device) != n).to(params.a.dtype)
        p_n = params.replace(a=params.a * cmask)
        d_n = update_w(d0, p_n, config)
        d_n = update_v(d_n, p_n, G, config)
        d_n = estep(d_n, p_n, G, config, niter=config.max_iter)

        # predict the held-out channel from the inferred latents, under the
        # full fitted parameters
        a_n = params.a[:, n]  # (z,)
        eta = torch.einsum("stz,z->st", d_n.mu, a_n) + torch.einsum(
            "stx,x->st", d0.x[..., n], params.b[:, n])
        y_n = d0.y[..., n]
        if bool(params.poisson[n]):
            ll = torch.sum((y_n * eta - torch.exp(eta)) * m) / nvalid
        else:
            noise_n = params.noise[n]
            quad = 0.5 * torch.einsum("stz,z->st", d_n.v, a_n * a_n)
            resid = (y_n - eta) * m
            ll = (-0.5 * torch.sum(resid * resid / noise_n
                                   + torch.log(2 * math.pi * noise_n) * m) / nvalid
                  - torch.sum(quad * m) / nvalid / noise_n)
        scores[n] = float(ll)
    return scores
