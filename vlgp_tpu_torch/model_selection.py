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
from .models.vlgp import infer_members

__all__ = ["speckled_cv", "gmap_speckled_cv", "elementwise_error", "leave_one_neuron_out",
           "LONO_CHUNKS"]

# one record per chunk of the last leave_one_neuron_out call: its neurons,
# each member's E-step sweeps and the rounds the chunk ran (every member
# sweeps in the first round, and a round runs while one is still sweeping,
# so the rounds are the members' most)
LONO_CHUNKS: list = []


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
    Gaussian negative squared error).  The held-out channel's residual and
    weight are zeroed, which is what zeroing its loading column does in
    ``vlgp_tpu.model_selection._lono_scorer``: its influence on the
    posterior is removed exactly.

    result: :class:`~vlgp_tpu_torch.api.FitResult`.  Returns
    {neuron: mean predictive log-likelihood per bin}.

    The neurons are scored in chunks of ``B = max(1, min(batch, ydim))``,
    as ``vlgp_tpu`` maps them in vmapped chunks: a chunk's B problems run as
    one inference over B x S segments, member-major
    (:func:`~vlgp_tpu_torch.models.vlgp.infer_members`), so every kernel
    launch serves the whole chunk and peak memory is about B x one
    inference's.  Each member leaves its E-step on its own norms, so its
    score is the one it gets alone, up to the order of sums; in float32 the
    inverse routes' residual checks decide once per chunk, within the
    Newton-Schulz contract.  The last chunk may be shorter.  The fused sweep
    (``VLGP_SWEEP_FUSED``) is not used.  ``LONO_CHUNKS`` holds one record
    per chunk of the last call: its neurons, each member's sweeps and the
    rounds it ran.  A chunk reads the host once per round for its exit
    test, in the inverse routes' checks, and once for its scores.
    """
    data, params, config = result.data, result.params, result.config
    ydim = params.ydim
    neurons = [int(n) for n in (range(ydim) if neurons is None else neurons)]
    LONO_CHUNKS.clear()
    if not neurons:
        return {}

    G = make_cholesky(data.nbin, params)
    B = max(1, min(batch, ydim))
    m = data.mask
    S, T = m.shape
    nvalid = torch.clamp(torch.sum(m), min=1.0)
    device = params.a.device
    scores = {}
    for k in range(0, len(neurons), B):
        chunk = neurons[k:k + B]
        idx = torch.tensor(chunk, device=device)
        cmask = (torch.arange(ydim, device=device)[None] != idx[:, None]).to(params.a.dtype)
        muz, vz, sweeps = infer_members(data, params, G, config, cmask, niter=config.max_iter)

        # predict each held-out channel from its member's latents, under the
        # full fitted parameters
        a_n = params.a[:, idx]  # (z, b)
        eta = (torch.einsum("zbst,zb->bst", muz.reshape(-1, len(chunk), S, T), a_n)
               + torch.einsum("stxb,xb->bst", data.x[..., idx], params.b[:, idx]))
        y_n = data.y[..., idx].permute(2, 0, 1)
        ll_pois = torch.sum((y_n * eta - torch.exp(eta)) * m, dim=(1, 2)) / nvalid
        noise_n = params.noise[idx]
        noise3 = noise_n[:, None, None]
        quad = 0.5 * torch.einsum("zbst,zb->bst", vz.reshape(-1, len(chunk), S, T), a_n * a_n)
        resid = (y_n - eta) * m
        ll_gauss = (-0.5 * torch.sum(resid * resid / noise3
                                     + torch.log(2 * math.pi * noise3) * m, dim=(1, 2)) / nvalid
                    - torch.sum(quad * m, dim=(1, 2)) / nvalid / noise_n)
        ll = torch.where(params.poisson[idx], ll_pois, ll_gauss)
        host = torch.cat([ll, sweeps.to(ll.dtype)]).tolist()  # the chunk's one read
        scores.update(zip(chunk, host[:len(chunk)]))
        member_sweeps = [int(n) for n in host[len(chunk):]]
        LONO_CHUNKS.append({"neurons": chunk, "sweeps": member_sweeps,
                            "rounds": max(member_sweeps)})
    return scores
