"""VEM outer loop (counterpart of ``vlgp_tpu/models/driver.py``).

Reference: ``vem`` (core.py:269-363) -- per iteration constrain_loading
-> E-step -> constrain_latent -> M-step -> H-step, with per-phase wall
clock timers, a callback hook and a relative-norm convergence test.

Three drivers, as in ``vlgp_tpu``:

  * ``vem`` runs the phases eagerly, with per-phase timers;
  * ``fused=True`` runs the whole EM step as one unit per iteration and
    reads the six convergence norms once per iteration;
  * ``block=k`` runs k steps per host read of their norms.

On a CUDA device the fused and block drivers capture the step
(:func:`make_em_step`) as CUDA graphs (:class:`_GraphSteps`): one replay
per EM iteration, the E-step's and M-step's exits, the residual nets of the
inverses and the Nystrom check as conditional nodes (``ops/control.py``),
nothing read by the host between the norms reads.  On the CPU they run the
same step eagerly, as ``vlgp_tpu``'s jitted step runs on a CPU backend.
"""
from __future__ import annotations

import collections
import time
from typing import Callable, Sequence, Tuple

import torch
import torch.distributed as tdist

from ..config import Config, Params
from ..data import TrialSet
from ..evaluation import elbo_terms
from ..ops import control
from ..ops import spd
from ..utils.profiling import annotate
from . import vlgp
from .gp import hstep, make_cholesky
from .vlgp import COLLECTIVES, Dist, constrain_latent, constrain_loading, em_norms, estep, mstep

__all__ = ["vem", "infer", "make_em_step", "xinv_zeros"]

# the convergence norms of one step, in the order of the norms buffer
NORM_KEYS = ("mu", "a", "b", "dmu", "da", "db")


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
    ``dist.data`` all ranks enter the H-step's all_reduces together; a
    captured step (:class:`_GraphSteps`) has one graph per cadence phase,
    chosen on the host from ``it`` (where ``vlgp_tpu`` takes a
    ``lax.cond`` on it).
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


def _jit_key(config: Config) -> Config:
    """The config without the fields that no EM step reads (checkpointing,
    seed, ELBO tracking and the EM loop's iteration counts and tolerance):
    the key of the captured-step cache, as ``vlgp_tpu``'s ``_jit_key`` is
    of its jit caches."""
    return config.replace(path=None, saving_interval=1800.0, seed=0, track_elbo=False,
                          convergence="norms", max_iter=1, min_iter=5, tol=1e-8)


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
    fused: bool = False,
    block: int = 1,
) -> Tuple[TrialSet, Params, torch.Tensor, dict]:
    """Variational EM loop with per-phase timing (core.py:269-363).

    Returns (data, params, G, runtime); ``runtime["converged_at"]``
    records the (1-based) iteration at which the convergence test first
    passed.  With ``config.track_elbo`` (or ``convergence="elbo"``) each
    iteration's ELBO and its terms land in ``runtime["elbo"]`` and
    ``runtime["elbo_terms"]``.

    ``fused=True`` runs each EM iteration as one step and reads its norms
    once; the per-phase timings then all land in ``em_elapsed``.
    ``block=k`` (k > 1, implies ``fused``) runs k iterations per host read:
    convergence is checked per iteration from the block's norms, and the
    callbacks and the ELBO record run at block boundaries.  In block mode
    ``runtime["it"]`` counts through the rest of the block after the
    convergence test passes: compare ``converged_at`` across driver modes,
    not ``it``.  On a CUDA device both drivers replay a captured CUDA graph
    per iteration (:class:`_GraphSteps`; ``runtime["capture_s"]`` holds the
    warm-up and capture time, outside ``em_elapsed``); a step that cannot be
    captured raises.  ``runtime["counts"]`` holds the sweeps, M-step
    iterations and fallbacks of the EM loop: from device counters of the
    replays under a capture, else from the host counters.
    """
    if fused or block > 1:  # scanning implies the fused step
        return _vem_scan(data, params, G, config, callbacks, verbose, block)
    runtime = {"it": 0, "e_elapsed": [], "m_elapsed": [], "h_elapsed": [],
               "em_elapsed": []}
    xinv = xinv_zeros(data, G)
    interval = max(1, int(config.hyper_interval))
    counts = _HostCounts()

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

        _run_callbacks(callbacks, data, params, config)

        post = em_norms(data, params)
        norms = {"mu": float(pre["mu"]), "a": float(pre["a"]), "b": float(pre["b"]),
                 "dmu": float(post["dmu"]), "da": float(post["da"]),
                 "db": float(post["db"])}
        if _track_elbo(config):
            _elbo_record(runtime, data, params, G)
        if _iter_converged(runtime, norms, config) and it + 1 >= config.min_iter:
            runtime["converged_at"] = runtime["it"]
            break

    runtime["counts"] = counts()
    params, G = _final_hstep(data, params, G, xinv, config, runtime)
    return data, params, G, runtime


def _run_callbacks(callbacks, data, params, config) -> None:
    for cb in callbacks:
        try:
            cb(data, params, config)
        except RuntimeError:  # the reference swallows these (core.py:341-345)
            pass


def _close_runtime(runtime: dict, steps) -> None:
    """The loop's decision counts (and, for a captured step, its warm-up
    and capture time) into ``runtime``."""
    runtime["counts"] = steps.counts()
    if steps.graphed:
        runtime["capture_s"] = steps.capture_s


def _vem_scan(data, params, G, config, callbacks, verbose, block):
    """``block`` fused steps per host read (``vlgp_tpu``'s ``_vem_scan``;
    ``block=1`` is its ``_vem_fused``); the tail block of
    ``max_iter % block`` steps runs the same per-step graphs."""
    runtime = {"it": 0, "e_elapsed": [], "m_elapsed": [], "h_elapsed": [],
               "em_elapsed": []}
    steps = make_steps(config, Dist(), data, params, G, xinv_zeros(data, G), block)
    done = False
    while runtime["it"] < config.max_iter and not done:
        k = min(block, config.max_iter - runtime["it"])
        tic, cap0 = time.perf_counter(), steps.capture_s
        steps.run(runtime["it"], k)
        norms_k = steps.norms()
        elapsed = time.perf_counter() - tic - (steps.capture_s - cap0)
        for norms in norms_k:
            runtime["it"] += 1
            runtime["em_elapsed"].append(elapsed / k)
            if (config.convergence == "norms" and _converged(norms, config.tol)
                    and runtime["it"] >= config.min_iter and not done):
                # ``it`` counts through the rest of the block; converged_at
                # is the index comparable across driver modes
                runtime["converged_at"] = runtime["it"]
                done = True
        if _track_elbo(config) or callbacks:
            d, p, g, _ = steps.state()
        if _track_elbo(config):
            # per-block trajectory (the state inside a block stays on the
            # device); the elbo test fires at block boundaries accordingly
            _elbo_record(runtime, d, p, g)
            if (config.convergence == "elbo" and not done
                    and runtime["it"] >= config.min_iter
                    and _iter_converged(runtime, {}, config)):
                runtime["converged_at"] = runtime["it"]
                done = True
        if verbose:
            print(f"Iteration {runtime['it']:4d}, EM {elapsed / k:.2f}s"
                  + (f"/it (block {k})" if block > 1 else ""))
        if callbacks:
            _run_callbacks(callbacks, d, p, config)
    data, params, G, xinv = steps.state()
    _close_runtime(runtime, steps)
    params, G = _final_hstep(data, params, G, xinv, config, runtime)
    return data, params, G, runtime


# ---------------------------------------------------------------------------
# Steps: k EM steps per call from a state, eagerly or as CUDA graphs
# ---------------------------------------------------------------------------


class _HostCounts:
    """The growth of the host's trip and fallback counters since it was
    made: a call returns them by name (the keys of ``runtime["counts"]``)."""

    def __init__(self):
        self._start = {**control.TRIPS, **spd.FALLBACKS}

    def __call__(self) -> dict:
        now = {**control.TRIPS, **spd.FALLBACKS}
        return {k: now[k] - self._start[k] for k in self._start}


class _EagerSteps:
    """The EM step run eagerly, k at a time (the CPU path)."""

    graphed = False
    capture_s = 0.0

    def __init__(self, em: Callable, data, params, G, xinv):
        self._em = em
        self._state = (data, params, G, xinv)
        self._norms = []
        self.counts = _HostCounts()

    def run(self, it0: int, k: int) -> None:
        data, params, G, xinv = self._state
        self._norms = []
        for j in range(k):
            data, params, G, norms, xinv = self._em(data, params, G, xinv, it=it0 + j)
            self._norms.append(norms)
        self._state = (data, params, G, xinv)

    def norm_tensors(self) -> dict:
        return {key: torch.stack([n[key] for n in self._norms]) for key in NORM_KEYS}

    def norms(self) -> list:
        return [{key: float(n[key]) for key in NORM_KEYS} for n in self._norms]

    def state(self):
        return self._state


def _tensor_fields(obj) -> list:
    return [(k, v) for k, v in vars(obj).items() if isinstance(v, torch.Tensor)]


def _layout(obj) -> tuple:
    """What a captured graph fixes about a TrialSet or Params: each tensor
    field's shape, stride and dtype, and the other fields' values."""
    return tuple((k, tuple(v.shape), v.stride(), v.dtype) if isinstance(v, torch.Tensor)
                 else (k, v) for k, v in vars(obj).items())


def _clone(obj):
    return obj.replace(**{k: v.clone() for k, v in _tensor_fields(obj)})


def _copy_fields(dst, src) -> None:
    for k, t in _tensor_fields(dst):
        s = getattr(src, k)
        if s is not t:
            t.copy_(s)


def _host_counters() -> list:
    return [dict(d) for d in (spd.KERNEL_LAUNCHES, spd.ROUTE_CALLS, spd.FALLBACKS,
                              control.TRIPS, COLLECTIVES)]


def _restore_counters(saved: list) -> None:
    for d, s in zip((spd.KERNEL_LAUNCHES, spd.ROUTE_CALLS, spd.FALLBACKS, control.TRIPS,
                     COLLECTIVES), saved):
        d.update(s)


# when True, the replays of a block run under torch.cuda.set_sync_debug_mode
# ("error"): any host synchronization between two norms reads raises
CHECK_REPLAY_SYNCS = False


class _GraphSteps:
    """The EM step captured as CUDA graphs, replayed k at a time.

    The state lives in static buffers (every tensor field of the TrialSet
    and the Params, G and the Woodbury carry): a replay reads them, and the
    step's outputs are copied back into them.  One graph per cadence phase
    (with and without the H-step), captured at its first use after a
    warm-up on copies of the state that runs every branch
    (``ops/control.py``); the graphs share one memory pool, since they run
    one at a time and keep nothing between replays.  Each replay writes
    its six norms into row ``slot`` of a (k, 6) device buffer and advances
    the device-side ``slot``, so k replays need no host read until
    :meth:`norms`.  Device counters count the sweeps, M-step iterations and
    fallbacks the replays took (:meth:`counts`)."""

    graphed = True

    def __init__(self, em: Callable, config: Config, data, params, G, xinv, k: int):
        self._em = em
        self._interval = max(1, int(config.hyper_interval))
        self._hstep = bool(config.Hstep)
        self.capturer = control.Capturer(G.device)
        self.data, self.params = _clone(data), _clone(params)
        self.G, self.xinv = G.clone(), xinv.clone()
        self._buf = torch.zeros((k, len(NORM_KEYS)), dtype=data.mu.dtype, device=G.device)
        self._slot = torch.zeros((1,), dtype=torch.int64, device=G.device)
        self._graphs = {}
        self._k = 0
        self.capture_s = 0.0

    def load(self, data, params, G, xinv) -> None:
        """Copy a state into the static buffers and zero the counters."""
        _copy_fields(self.data, data)
        _copy_fields(self.params, params)
        for t, s in ((self.G, G), (self.xinv, xinv)):
            if s is not t:
                t.copy_(s)
        self.capturer.reset_counts()

    def _record(self, it: int) -> None:
        data, params, G, norms, xinv = self._em(self.data, self.params, self.G, self.xinv, it=it)
        row = torch.stack([norms[key] for key in NORM_KEYS]).to(self._buf.dtype)
        _copy_fields(self.data, data)
        _copy_fields(self.params, params)
        for t, s in ((self.G, G), (self.xinv, xinv)):
            if s is not t:
                t.copy_(s)
        self._buf.index_copy_(0, self._slot, row[None])
        self._slot.add_(1)

    def _phase(self, it: int) -> bool:
        return self._hstep and it % self._interval == 0

    def _graph(self, phase: bool):
        graph = self._graphs.get(phase)
        if graph is None:
            tic = time.perf_counter()
            it = 0 if phase else 1  # an iteration of this cadence phase
            saved = _host_counters()
            self.capturer.warmup(lambda: self._em(_clone(self.data), _clone(self.params),
                                                  self.G.clone(), self.xinv.clone(), it=it))
            _restore_counters(saved)  # the warm-up ran every branch
            graph, _ = self.capturer.capture(lambda: self._record(it))
            self._graphs[phase] = graph
            self.capture_s += time.perf_counter() - tic
        return graph

    def run(self, it0: int, k: int) -> None:
        if not 1 <= k <= self._buf.shape[0]:
            raise ValueError(f"k={k} outside 1..{self._buf.shape[0]}")
        graphs = [self._graph(self._phase(it0 + j)) for j in range(k)]
        mode = torch.cuda.get_sync_debug_mode()
        if CHECK_REPLAY_SYNCS:
            torch.cuda.set_sync_debug_mode("error")
        try:
            self._slot.zero_()
            for graph in graphs:
                graph.replay()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        self._k = k

    def norm_tensors(self) -> dict:
        rows = self._buf[:self._k].clone()
        return {key: rows[:, i] for i, key in enumerate(NORM_KEYS)}

    def norms(self) -> list:
        """The last run's norms: one host read."""
        return [dict(zip(NORM_KEYS, row)) for row in self._buf[:self._k].tolist()]

    def state(self):
        """Copies of the state (the next replay rewrites the buffers)."""
        return _clone(self.data), _clone(self.params), self.G.clone(), self.xinv.clone()

    def close(self) -> None:
        """Drop the graphs and give their memory back (no replay after)."""
        self._graphs.clear()
        self.capturer.close()

    def counts(self) -> dict:
        """The device counters of the replays since :meth:`load` (one host
        read), under the keys of :class:`_HostCounts`."""
        got = self.capturer.read_counts()
        return {k: got.get(k, 0) for k in {**control.TRIPS, **spd.FALLBACKS}}


# captured steps by what their graphs fix (config, process groups, shapes,
# device, norms rows); the oldest is dropped beyond _CACHE_SIZE
_GRAPH_CACHE: "collections.OrderedDict[tuple, _GraphSteps]" = collections.OrderedDict()
_CACHE_SIZE = 4


def check_capturable(config: Config, dist: Dist, device: torch.device) -> None:
    """Raise, naming what refuses, when the EM step cannot be captured as
    a CUDA graph on ``device``."""
    if device.type != "cuda":
        return
    for axis in ("data", "model"):
        group = getattr(dist, axis)
        if group is not None and tdist.get_backend(group) != "nccl":
            raise ValueError(
                f"the {axis} axis's process group uses the {tdist.get_backend(group)!r} "
                "backend: a captured EM step on CUDA needs an 'nccl' group (gloo's CUDA "
                "collectives synchronize with the host, which a CUDA graph capture refuses)")


def make_steps(config: Config, dist: Dist, data, params, G, xinv, k: int):
    """k EM steps per call from (data, params, G, xinv): eager on the CPU,
    replayed CUDA graphs on a CUDA device (cached, so repeated fits at one
    shape capture once)."""
    em = make_em_step(config, dist, carry_xinv=True)
    if not G.is_cuda:
        return _EagerSteps(em, data, params, G, xinv)
    check_capturable(config, dist, G.device)
    # the module switches of the fused sweep and the fused probe pick the
    # code a capture records
    key = (_jit_key(config), dist, _layout(data), _layout(params), _layout_t(G),
           _layout_t(xinv), str(G.device), k, vlgp._SWEEP_FUSED, spd._FUSED_PROBE)
    steps = _GRAPH_CACHE.pop(key, None)
    if steps is None:
        steps = _GraphSteps(em, config, data, params, G, xinv, k)
    _GRAPH_CACHE[key] = steps
    while len(_GRAPH_CACHE) > _CACHE_SIZE:
        _GRAPH_CACHE.popitem(last=False)[1].close()
    steps.load(data, params, G, xinv)
    return steps


def _layout_t(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.stride(), t.dtype


def infer(data: TrialSet, params: Params, G: torch.Tensor, config: Config) -> TrialSet:
    """Inference-only pass: the E-step run for ``max_iter`` sweeps
    (core.py:260-266)."""
    return estep(data, params, G, config, niter=config.max_iter)
