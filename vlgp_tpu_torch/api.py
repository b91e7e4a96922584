"""Public API: fit, transform, sample_posterior, fastfit, map2vi, resume
(counterpart of ``vlgp_tpu/api.py``).

The reference pipeline (api.py:18-76): config -> params -> FA
initialization -> prior factors -> w/v init -> segmentation -> VEM on
segments -> refreshed factors -> final full-length inference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .config import Config, Params, _resolve_device, _tensor, default_config, make_params
from .data import TrialSet, cut_trials, pack_trials, scatter_segments, unpack_trials
from .init import FactorModel, initialize
from .models import gpfa
from .models.driver import check_capturable, infer, vem
from .models.gp import effective_rank, make_cholesky, posterior_cov
from .models.vlgp import Dist, mstep, update_v, update_w

__all__ = ["fit", "transform", "sample_posterior", "fastfit", "map2vi", "resume",
           "FitResult"]


@dataclasses.dataclass
class FitResult:
    """Fit output.  Also indexable like the reference result dict
    (``result['trials']/'params'/'config'``, api.py:74-76)."""

    data: TrialSet
    params: Params
    config: Config
    factor_model: Optional[FactorModel]
    G: torch.Tensor
    runtime: dict
    initial_params: Optional[Params] = None
    _trials_in: Optional[Sequence[dict]] = None

    @property
    def trials(self) -> List[dict]:
        return unpack_trials(self.data, self._trials_in)

    def __getitem__(self, key):
        if key == "trials":
            return self.trials
        if key == "params":
            return self.params
        if key == "config":
            return self.config
        raise KeyError(key)


def _fill_missing_mu(data: TrialSet, trials, mu) -> TrialSet:
    """Merge an initializer's posterior means into ``data`` per trial,
    keeping any trial's user-supplied ``mu`` (preprocess.py:40-41)."""
    user_mu = [("mu" in t and t["mu"] is not None) for t in trials]
    mu = mu.to(data.mu.dtype)
    if any(user_mu):
        keep = torch.tensor(user_mu, device=mu.device)[:, None, None]
        mu = torch.where(keep, data.mu, mu)
    return data.replace(mu=mu)


def _to_device(obj, device: torch.device, dtype: Optional[torch.dtype] = None):
    """A Params or FactorModel with every tensor field moved to ``device``
    (and cast to ``dtype`` when given)."""
    moved = {f.name: getattr(obj, f.name).to(device=device, dtype=dtype)
             for f in dataclasses.fields(obj) if isinstance(getattr(obj, f.name), torch.Tensor)}
    return dataclasses.replace(obj, **moved)


def _prepare(
    trials: Sequence[dict],
    n_factors: int,
    config: Config,
    device: torch.device,
    *,
    lik: Union[str, Sequence[str]] = "poisson",
    history: int = 0,
    a=None,
    b=None,
    noise=None,
    sigma=None,
    omega=None,
    rank: int = 50,
    gp_noise: float = 1e-4,
    dt: float = 1.0,
    factor_model: Optional[FactorModel] = None,
) -> Tuple[TrialSet, Params, Optional[FactorModel]]:
    """Pack trials, initialize parameters and posterior (api.py:39-54).
    xdim = 1 + history (see ``vlgp_tpu.api._prepare``)."""
    xdim = history + 1
    dtype = config.tdtype
    data = pack_trials(trials, n_factors, xdim, dtype=dtype, device=device)

    need_init = a is None or b is None or noise is None
    fm = factor_model
    mu = None
    if factor_model is not None:
        mu = factor_model.transform(data.y) * data.mask[..., None]
    elif need_init:
        generator = torch.Generator(device=device)
        generator.manual_seed(config.seed)
        fm, a0, b0, noise0, mu = initialize(data, n_factors, generator, eps=config.eps)
        if a is None:
            a = a0
        if b is None:
            b = torch.zeros((xdim, data.ydim), dtype=dtype, device=device)
            b[0] = b0
        if noise is None:
            noise = noise0
    if mu is not None:
        data = _fill_missing_mu(data, trials, mu)

    if b is not None:
        b = _tensor(b, dtype, device)
        if b.ndim < 2:
            b = b.reshape(1, -1)
        if b.shape[0] != xdim:  # allow (ydim,) bias vectors
            full = torch.zeros((xdim, data.ydim), dtype=dtype, device=device)
            full[0] = b.reshape(-1)
            b = full

    if omega is None and config.omega_init == "staggered" and n_factors > 1:
        # log-uniform stagger over the smooth side of the omega box,
        # [1.2 lo, 4 lo] (see vlgp_tpu.api._prepare for the measurements)
        lo, hi = config.omega_bound
        bottom = min(lo * 1.2, hi)
        top = max(min(lo * 4, hi / 3), bottom)
        omega = np.clip(np.logspace(np.log10(bottom), np.log10(top), n_factors), lo, hi)

    params = make_params(
        data.ydim, n_factors, xdim, lik,
        a=a, b=b, noise=noise, sigma=sigma, omega=omega,
        omega_bound=config.omega_bound, rank=rank, gp_noise=gp_noise, dt=dt,
        dtype=dtype, device=device,
    )
    return data, params, fm


def fit(
    trials: Sequence[dict],
    n_factors: int,
    *,
    lik: Union[str, Sequence[str]] = "poisson",
    history: int = 0,
    a=None,
    b=None,
    noise=None,
    sigma=None,
    omega=None,
    rank: int = 50,
    gp_noise: float = 1e-4,
    dt: float = 1.0,
    callbacks: Sequence[Callable] = (),
    verbose: bool = False,
    fused: bool = False,
    block: int = 1,
    factor_model: Optional[FactorModel] = None,
    device=None,
    **config_kwargs,
) -> FitResult:
    """Fit the vLGP model (reference entry point api.py:18-76).

    trials: list of dicts with ``y`` (length, ydim); optional ``x``, ``mu``.
    Unequal lengths are padded and masked.  ``device`` defaults to the
    current CUDA device and raises when there is none: pass ``device="cpu"``
    to fit on the CPU.  The dtype is ``Config.dtype``.  ``fused=True`` runs
    each EM iteration as one step with one host read of its convergence
    norms, and ``block=k`` k iterations per read (``models.driver.vem``):
    on the card as replays of a captured CUDA graph, raising when the step
    cannot be captured (a process group that is not nccl).

    Passing ``path=...`` snapshots the parameters every ``saving_interval``
    seconds during VEM and once more at the end, as ``vlgp_tpu.fit`` does,
    to ``<path>.npz``.  Restore with :func:`vlgp_tpu_torch.utils.io.load_params`.
    """
    config = default_config(**config_kwargs)
    callbacks = list(callbacks)
    saver = None
    if config.path is not None:
        from .callback import Saver

        saver = Saver(config.path, config.saving_interval)
        callbacks.append(saver)
    device = _resolve_device(device, "fit")
    if fused or block > 1:
        check_capturable(config, Dist(), device)

    data, params, fm = _prepare(
        trials, n_factors, config, device,
        lik=lik, history=history, a=a, b=b, noise=noise, sigma=sigma,
        omega=omega, rank=rank, gp_noise=gp_noise, dt=dt,
        factor_model=factor_model,
    )

    # prior factors + initial posterior weights on full trials (api.py:52-54)
    G_full = make_cholesky(data.nbin, params)
    data = update_w(data, params, config)
    data = update_v(data, params, G_full, config)

    # segmentation (api.py:56-58); segment factors trimmed to the effective
    # rank of the sharpest kernel that can occur
    segments = cut_trials(data, config.window, seed=config.seed)
    omega_hi = max(float(params.omega.max()), config.omega_bound[1])
    seg_rank = min(params.rank, effective_rank(segments.nbin, omega_hi, dt))
    G_seg = make_cholesky(segments.nbin, params, rank=seg_rank)

    initial_params = params
    segments, params, G_seg, runtime = vem(
        segments, params, G_seg, config, callbacks=callbacks, verbose=verbose,
        fused=fused, block=block,
    )

    # write the trained posterior back, refresh factors, final full
    # inference (api.py:66-71)
    data = scatter_segments(data, segments)
    G_full = make_cholesky(data.nbin, params)
    data = update_w(data, params, config)
    data = update_v(data, params, G_full, config)
    data = infer(data, params, G_full, config)

    if saver is not None:  # final snapshot regardless of the interval
        saver.save(data, params, config, force=True)

    return FitResult(
        data=data,
        params=params,
        config=config,
        factor_model=fm,
        G=G_full,
        runtime=runtime,
        initial_params=initial_params,
        _trials_in=trials,
    )


def transform(
    trials: Sequence[dict],
    result_or_params,
    config: Optional[Config] = None,
    factor_model: Optional[FactorModel] = None,
    device=None,
) -> List[dict]:
    """Infer latents for new trials under fitted parameters (reference
    api.py:171-184; ``vlgp_tpu.transform``): prior factors are built for
    whatever lengths arrive.

    ``result_or_params`` is a :class:`FitResult`, which also supplies the
    config and the factor model unless they are given, or bare ``Params``
    (with ``Config()`` unless ``config`` is given).  A factor model fills
    the ``mu`` of every trial that brings none.  ``device`` defaults to the
    current CUDA device and raises when there is none: pass ``device="cpu"``
    to run on the CPU.  The params and the factor model are moved there.
    """
    if isinstance(result_or_params, FitResult):
        params = result_or_params.params
        config = result_or_params.config if config is None else config
        factor_model = (
            result_or_params.factor_model if factor_model is None else factor_model
        )
    else:
        params = result_or_params
        if config is None:
            config = Config()
    device = _resolve_device(device, "transform")
    params = _to_device(params, device)

    data = pack_trials(trials, params.zdim, params.xdim, dtype=config.tdtype, device=device)
    if factor_model is not None:
        factor_model = _to_device(factor_model, device, data.y.dtype)
        mu = factor_model.transform(data.y) * data.mask[..., None]
        data = _fill_missing_mu(data, trials, mu)
    G = make_cholesky(data.nbin, params)
    data = update_w(data, params, config)
    data = update_v(data, params, G, config)
    data = infer(data, params, G, config)
    return unpack_trials(data, trials)


def sample_posterior(
    result, trial, nsamples: Optional[int] = None, generator: Optional[torch.Generator] = None,
    reg: float = 1e-6, method: str = "lowrank", nsample: Optional[int] = None,
):
    """Draw joint posterior samples for one trial (reference api.py:142-168;
    ``vlgp_tpu.sample_posterior``).  Returns (nsamples, length, n_factors)
    on the posterior's device.

    Two call forms:

      * ``sample_posterior(fit_result, trial_index, nsamples)`` samples trial
        ``trial_index`` of a :class:`FitResult`;
      * ``sample_posterior(trial_dict, params, nsamples)`` samples any trial
        dict carrying the posterior state (``mu`` (T, z) and ``w``) under
        :class:`Params`, with prior factors built for the trial's length
        (on the params' device).

    ``generator`` draws the noise; when None, a generator on the posterior's
    device is seeded from ``config.seed`` (a FitResult) or 0 (a trial dict).
    method="lowrank" (default): with K = GG', S = G (I + G'WG)^{-1} G', so a
    sample is mu + G chol((I+G'WG)^{-1}) eps, O(T r) per sample.
    method="dense" builds the dense Woodbury covariance (util.py:541-547).
    """
    if nsamples is None:
        nsamples = nsample  # reference keyword spelling
    if nsamples is None:
        raise TypeError("nsamples is required")
    if isinstance(result, FitResult):
        seed = result.config.seed
        L = int(result.data.lengths[trial])
        mu = result.data.mu[trial]  # (T, z)
        w = result.data.w[trial]
        mask = result.data.mask[trial]
        G = result.G  # (z, T, r)
    else:  # raw (trial_dict, params), the reference call form
        trial_dict, params = result, trial
        if not isinstance(trial_dict, dict) or "mu" not in trial_dict:
            raise TypeError("expected a FitResult + trial index, or a trial dict with "
                            "'mu'/'w' + Params")
        seed = 0
        mu = _tensor(trial_dict["mu"], params.a.dtype, params.a.device)
        w = _tensor(trial_dict["w"], params.a.dtype, params.a.device)
        L = mu.shape[0]
        mask = torch.ones(L, dtype=mu.dtype, device=mu.device)
        G = make_cholesky(L, params)
    if generator is None:
        generator = torch.Generator(device=mu.device)
        generator.manual_seed(seed)
    wz = (w * mask[:, None]).T  # (z, T)
    muz = mu.T  # (z, T)
    zdim, T, R = G.shape

    if method == "lowrank":
        A = torch.einsum("ztr,zt,ztq->zrq", G, wz, G)
        eye = torch.eye(R, dtype=G.dtype, device=G.device)
        X = torch.linalg.inv(eye * (1.0 + reg) + A)
        C = torch.linalg.cholesky(X + reg * eye)
        eps = torch.randn((zdim, nsamples, R), generator=generator, dtype=G.dtype,
                          device=G.device)
        samples = muz[:, None, :] + (eps @ C.mT) @ G.mT  # (z, nsamples, T)
    else:
        eye = torch.eye(T, dtype=G.dtype, device=G.device)
        S = posterior_cov(wz, G, reg) + reg * eye
        C = torch.linalg.cholesky(S)
        eps = torch.randn((zdim, nsamples, T), generator=generator, dtype=G.dtype,
                          device=G.device)
        samples = muz[:, None, :] + eps @ C.mT
    return samples.permute(1, 2, 0)[:, :L, :]


def map2vi(trials, C, d, **kwargs) -> FitResult:
    """Seed vLGP with GPFA-style (C, d) and run a short fit (reference
    api.py:79-105, without its dead ``Saver`` reference).  ``kwargs`` go to
    :func:`fit`, ``device`` included; ``max_iter`` defaults to 5."""
    n_factors = C.shape[0]
    kwargs.setdefault("max_iter", 5)
    b = torch.log(torch.clamp(torch.as_tensor(d), min=1e-8))
    return fit(trials, n_factors, a=C, b=b, **kwargs)


def fastfit(trials, n_factors, dt, var, scale, max_iter=20, device=None,
            **kwargs) -> FitResult:
    """GPFA-warm-started fit (reference api.py:108-119): the linear-Gaussian
    GPFA EM on window segments for ``max_iter`` iterations, then
    :func:`map2vi` with the learned loading and bias and the matched
    omega = 0.5 / (scale / dt)^2.  ``device`` defaults to the current CUDA
    device and raises when there is none."""
    config = default_config(**{k: v for k, v in kwargs.items()
                               if k in Config.__dataclass_fields__})
    omega = np.full(n_factors, 0.5 / ((scale / dt) ** 2))
    device = _resolve_device(device, "fastfit")

    data, params, fm = _prepare(trials, n_factors, config, device, dt=dt)
    segments = cut_trials(data, config.window, seed=config.seed)
    K = gpfa.make_prior(segments.nbin, dt, var, scale, dtype=data.y.dtype, device=device)
    C0 = params.a
    d0 = torch.exp(params.b[0])
    R0 = torch.ones(data.ydim, dtype=K.dtype, device=device)
    _, C, d, _ = gpfa.em(segments.y, C0, d0, R0, K, max_iter)
    return map2vi(trials, C, d, omega=omega, dt=dt, factor_model=fm, device=device, **kwargs)


def resume(result: FitResult, **config_kwargs) -> FitResult:
    """Continue from a fit: infer -> M-step -> infer, on the result's
    device.  The reference ``resume`` (api.py:122-140) sets Eniter=0 in its
    middle pass, so its M phase never runs; here it does."""
    config = result.config if not config_kwargs else result.config.replace(**config_kwargs)
    data, params, G = result.data, result.params, result.G
    data = infer(data, params, G, config)
    params = mstep(data, params, config)
    data = infer(data, params, G, config)
    return dataclasses.replace(result, data=data, params=params, config=config)
