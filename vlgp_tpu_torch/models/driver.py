"""VEM outer loop (counterpart of ``vlgp_tpu/models/driver.py``).

Reference: ``vem`` (core.py:269-363) -- per iteration constrain_loading
-> E-step -> constrain_latent -> M-step -> H-step, with per-phase wall
clock timers, a callback hook and a relative-norm convergence test.  The
phases run eagerly; the ``hyper_interval`` cadence is a host-side branch.
"""
from __future__ import annotations

import time
from typing import Callable, Sequence, Tuple

import torch

from ..config import Config, Params
from ..data import TrialSet
from ..evaluation import elbo_terms
from ..utils.profiling import annotate
from .gp import hstep, make_cholesky
from .vlgp import Dist, constrain_latent, constrain_loading, em_norms, estep, mstep

__all__ = ["vem", "infer", "make_em_step", "xinv_zeros"]


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def make_em_step(config: Config, dist: Dist = Dist(), carry_xinv: bool = False
                 ) -> Callable:
    """Build a single-EM-iteration function.

    (data, params, G) -> (data, params, G, norms) with ``norms`` holding
    the squared norms for the convergence test (pre-step mu/a/b, post-step
    dmu/da/db, core.py:300-305 and 350-354).  With ``carry_xinv`` the step
    takes and returns the E-step's final Woodbury inverse, which
    warm-starts the next iteration.  ``it`` (the 0-based iteration index)
    applies the ``hyper_interval`` cadence; ``None`` runs the H-step.  The
    cadence is a host integer, the same on every rank, so under
    ``dist.data`` all ranks enter the H-step's all_reduces together.
    """

    def em_step(data: TrialSet, params: Params, G: torch.Tensor, xinv=None,
                it=None):
        pre = em_norms(data, params, dist)
        data, params = constrain_loading(data, params, config, dist)
        if carry_xinv:
            data, xinv = estep(data, params, G, config, dist=dist, xinv=xinv,
                               return_xinv=True)
        else:
            data = estep(data, params, G, config, dist=dist)
        data, params = constrain_latent(data, params, config, dist)
        params = mstep(data, params, config, dist=dist)
        interval = max(1, int(config.hyper_interval))
        if config.Hstep and (it is None or it % interval == 0):
            params = hstep(data, params, config, dist, rank=G.shape[-1], xinv=xinv)
            G = make_cholesky(data.nbin, params, rank=G.shape[-1])
        post = em_norms(data, params, dist)
        norms = dict(mu=pre["mu"], a=pre["a"], b=pre["b"],
                     dmu=post["dmu"], da=post["da"], db=post["db"])
        if carry_xinv:
            return data, params, G, norms, xinv
        return data, params, G, norms

    return em_step


def xinv_zeros(data: TrialSet, G: torch.Tensor) -> torch.Tensor:
    """Initial (useless) inverse carry: the probe routes it to a cold start."""
    Z, _, R = G.shape
    return torch.zeros((Z, data.ntrial, R, R), dtype=data.mu.dtype, device=data.mu.device)


def _converged(norms, tol: float) -> bool:
    """norm(d.) < tol * norm(.) for mu, a, b (squared form, core.py:354)."""
    t2 = tol * tol
    return bool(
        (norms["dmu"] < t2 * norms["mu"])
        and (norms["da"] < t2 * norms["a"])
        and (norms["db"] < t2 * norms["b"])
    )


def _track_elbo(config: Config) -> bool:
    return config.track_elbo or config.convergence == "elbo"


def _elbo_record(runtime: dict, data, params, G) -> None:
    """Append this iteration's ELBO (and its terms) to the runtime dict."""
    terms = elbo_terms(data, params, G)
    runtime.setdefault("elbo", []).append(terms["elbo"])
    runtime.setdefault("elbo_terms", []).append(terms)


def _iter_converged(runtime: dict, norms, config: Config) -> bool:
    """The convergence test of ``config.convergence``: the reference's
    relative-update norms (core.py:350-359), or an ELBO stall."""
    if config.convergence == "elbo":
        e = runtime.get("elbo", [])
        if len(e) < 2:
            return False
        return abs(e[-1] - e[-2]) <= config.tol * abs(e[-1])
    return _converged(norms, config.tol)


def _final_hstep(data, params, G, xinv, config: Config, runtime: dict):
    """Closing H-step for ``hyper_interval > 1``: when the loop exits on an
    iteration whose H-step was skipped, refresh omega/sigma against the
    final posterior; records ``runtime["final_hstep"] = True``."""
    interval = int(config.hyper_interval)
    if not (config.Hstep and interval > 1 and runtime["it"] > 0):
        return params, G
    if (runtime["it"] - 1) % interval == 0:  # the last iteration ran its H-step
        return params, G
    with annotate("vlgp:hstep"):
        params = hstep(data, params, config, rank=G.shape[-1], xinv=xinv)
        G = make_cholesky(data.nbin, params, rank=G.shape[-1])
        _sync(params.omega)
    runtime["final_hstep"] = True
    return params, G


def vem(
    data: TrialSet,
    params: Params,
    G: torch.Tensor,
    config: Config,
    callbacks: Sequence[Callable] = (),
    verbose: bool = False,
) -> Tuple[TrialSet, Params, torch.Tensor, dict]:
    """Variational EM loop with per-phase timing (core.py:269-363).

    Returns (data, params, G, runtime); ``runtime["converged_at"]``
    records the (1-based) iteration at which the convergence test first
    passed.  With ``config.track_elbo`` (or ``convergence="elbo"``) each
    iteration's ELBO and its terms land in ``runtime["elbo"]`` and
    ``runtime["elbo_terms"]``.
    """
    runtime = {"it": 0, "e_elapsed": [], "m_elapsed": [], "h_elapsed": [],
               "em_elapsed": []}
    xinv = xinv_zeros(data, G)
    interval = max(1, int(config.hyper_interval))

    for it in range(config.max_iter):
        runtime["it"] += 1
        tic_em = time.perf_counter()

        tic = time.perf_counter()
        with annotate("vlgp:estep"):
            pre = em_norms(data, params)
            data, params = constrain_loading(data, params, config)
            data, xinv = estep(data, params, G, config, xinv=xinv, return_xinv=True)
            _sync(data.mu)
        runtime["e_elapsed"].append(time.perf_counter() - tic)

        tic = time.perf_counter()
        with annotate("vlgp:mstep"):
            data, params = constrain_latent(data, params, config)
            params = mstep(data, params, config)
            _sync(params.a)
        runtime["m_elapsed"].append(time.perf_counter() - tic)

        tic = time.perf_counter()
        if config.Hstep and it % interval == 0:
            with annotate("vlgp:hstep"):
                params = hstep(data, params, config, rank=G.shape[-1], xinv=xinv)
                G = make_cholesky(data.nbin, params, rank=G.shape[-1])
                _sync(params.omega)
        runtime["h_elapsed"].append(time.perf_counter() - tic)

        runtime["em_elapsed"].append(time.perf_counter() - tic_em)
        if verbose:
            print(f"Iteration {runtime['it']:4d}, "
                  f"E-step {runtime['e_elapsed'][-1]:.2f}s, "
                  f"M-step {runtime['m_elapsed'][-1]:.2f}s")

        for cb in callbacks:
            try:
                cb(data, params, config)
            except RuntimeError:  # the reference swallows these (core.py:341-345)
                pass

        post = em_norms(data, params)
        norms = {"mu": float(pre["mu"]), "a": float(pre["a"]), "b": float(pre["b"]),
                 "dmu": float(post["dmu"]), "da": float(post["da"]),
                 "db": float(post["db"])}
        if _track_elbo(config):
            _elbo_record(runtime, data, params, G)
        if _iter_converged(runtime, norms, config) and it + 1 >= config.min_iter:
            runtime["converged_at"] = runtime["it"]
            break

    params, G = _final_hstep(data, params, G, xinv, config, runtime)
    return data, params, G, runtime


def infer(data: TrialSet, params: Params, G: torch.Tensor, config: Config) -> TrialSet:
    """Inference-only pass: the E-step run for ``max_iter`` sweeps
    (core.py:260-266)."""
    return estep(data, params, G, config, niter=config.max_iter)
