"""Data-dependent control flow that a CUDA graph can hold.

Counterpart of ``vlgp_tpu``'s ``lax.cond`` and ``lax.while_loop`` uses
(``ops/spd.py:252-256``, ``:957``; ``ops/ichol.py:151-158``;
``models/vlgp.py:249-260``, ``:277-284``, ``:486-497``).

:func:`cond` and :func:`bounded_while` run in one of three modes:

* **eager** (the default, and always on the CPU): a host branch on the
  predicate, and a Python loop with its ``break`` -- the code the port ran
  before these functions existed.
* **warm-up** (:meth:`Capturer.warmup`, before a capture): every branch of
  every ``cond`` runs, each on the stream its body is captured on, and the
  predicate picks the result.  So no library handle, workspace or lazily
  loaded kernel is first made inside a capture, including the branches
  that the capture's data never takes (the exact Cholesky net, the ichol
  fallback).
* **capture** (:meth:`Capturer.capture`): ``cond`` records an IF node on
  the predicate and one on its negation (``csrc/graph_cond.cu``), the
  second branch's outputs copied into the first's, as
  ``torch/_higher_order_ops/cudagraph_conditional_nodes.py:if_else_node``
  does.  ``bounded_while`` unrolls into ``niter`` IF nodes on a latched
  device predicate: once a test fails, every later sweep is one skipped
  conditional node and launches nothing, so the graph does the eager loop's
  exact trip count and work.

Counters.  The host counters of the port (``ops.spd.KERNEL_LAUNCHES``,
``ROUTE_CALLS``, ``FALLBACKS``, ``models.vlgp.COLLECTIVES`` and
:data:`TRIPS`) count what the Python code runs: under a capture that is
once per capture, not once per replay.  :func:`tally` adds one to a host
counter and, under a capture, records an increment of a device counter in
the current body, so the device counts (:meth:`Capturer.read_counts`)
count what the replays did.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Callable, Optional

import torch

__all__ = ["cond", "bounded_while", "private", "tally", "mode", "Capturer", "TRIPS"]

# trip counts of the bounded loops, by loop name: sweeps of the E-step's
# per-sweep composition, Newton iterations of the M-step, and rounds of the
# leave-one-neuron-out E-step (models.vlgp.estep_members), each round one
# sweep of every member still sweeping
TRIPS = {"estep_sweeps": 0, "mstep_iters": 0, "lono_rounds": 0}

# nested IF bodies a capture may open (each depth has a stream and a pool)
_MAX_DEPTH = 16
# device counters a Capturer holds; names get slots in order of first use
_MAX_COUNTS = 64
_SLOTS: dict = {}
# cudaStreamCaptureMode of torch.cuda.graph's default "global"
_CAPTURE_MODE = 0


class _State(threading.local):
    mode = "eager"
    capturer: Optional["Capturer"] = None
    depth = 0


_STATE = _State()


def mode() -> str:
    """"eager", "warmup" or "capture"."""
    return _STATE.mode


def _slot(name: str) -> int:
    if name not in _SLOTS:
        if len(_SLOTS) >= _MAX_COUNTS:
            raise RuntimeError(f"more than {_MAX_COUNTS} device counters")
        _SLOTS[name] = len(_SLOTS)
    return _SLOTS[name]


def tally(counter: dict, key: str, n: int = 1) -> None:
    """``counter[key] += n`` on the host; under a capture, also one device
    increment of ``key`` in the body being captured."""
    counter[key] += n
    if _STATE.mode == "capture":
        _STATE.capturer.counts[_slot(key)].add_(n)


def private(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the result of a ``cond`` branch: a copy under a capture,
    where the other branch writes its result into this one's, and ``t``
    itself otherwise.  Use it for a result that the branch did not make,
    such as an operand passed through."""
    return t.clone() if _STATE.mode == "capture" else t


def _copy_into(dst, src) -> None:
    if dst is None and src is None:
        return
    if isinstance(dst, torch.Tensor):
        if src is not dst:
            dst.copy_(src)
        return
    if isinstance(dst, (tuple, list)) and len(dst) == len(src):
        for d, s in zip(dst, src):
            _copy_into(d, s)
        return
    raise TypeError(f"cond branches returned different structures: {type(dst)} and {type(src)}")


def cond(pred: torch.Tensor, true_fn: Callable, false_fn: Callable):
    """``true_fn()`` if the 0-d ``pred`` holds, else ``false_fn()``.

    Both branches return a tensor, a tuple of tensors or None, of the same
    structure, shapes and dtypes.  Under a capture the result is the
    tensors that ``true_fn`` returned, overwritten by ``false_fn``'s when
    ``pred`` is false at replay: ``true_fn`` returns tensors that nothing
    else reads (fresh ones, or :func:`private` copies)."""
    st = _STATE
    if st.mode == "eager" or not pred.is_cuda:
        return true_fn() if bool(pred) else false_fn()
    if st.mode == "warmup":
        out_t = _nested(1, true_fn)
        out_f = _nested(1, false_fn)
        return out_t if bool(pred) else out_f
    cap = st.capturer
    h_true = cap._handle(pred, negate=False)
    h_false = cap._handle(pred, negate=True)
    with cap._if_body(h_true):
        out = true_fn()
    with cap._if_body(h_false):
        _copy_into(out, false_fn())
    return out


def bounded_while(niter: int, keep_going: Callable, body: Callable, carry: tuple,
                  name: Optional[str] = None) -> tuple:
    """At most ``niter`` rounds of ``carry = body(carry)``, stopping before
    round ``i`` when ``keep_going(i, carry)`` returns a false 0-d tensor
    (``None`` means no test at ``i``).  ``name`` counts the rounds run in
    :data:`TRIPS` (and, under a capture, in the device counters).

    Under a capture the rounds before the first test are recorded as they
    are; from the first test on, round ``i`` runs inside an IF node on a
    latched device predicate ``alive``, itself inside the IF node of round
    ``i - 1``'s ``alive``: the test of round ``i`` runs only while the loop
    is alive, and a dead loop skips each later round at the cost of one
    conditional node.  The carry is copied into buffers of its own at the
    first test, and every later round's result into them."""
    st = _STATE
    if st.mode == "capture" and carry[0].is_cuda:
        return _while_capture(niter, keep_going, body, carry, name)
    # warm-up runs each test and round on the stream the capture records it
    # on: the first test at this depth and later ones one down; the round
    # of the first test one down and later rounds two down
    warm = st.mode == "warmup" and carry[0].is_cuda
    tested = 0
    for i in range(niter):
        if warm and tested:
            p = _nested(1, lambda: keep_going(i, carry))
        else:
            p = keep_going(i, carry)
        if p is not None:
            tested += 1
            if not bool(p):
                break
        carry = _nested(min(tested, 2), lambda: body(carry)) if warm else body(carry)
        if name is not None:
            TRIPS[name] += 1
    return carry


def _while_capture(niter, keep_going, body, carry, name):
    cap = _STATE.capturer

    def run(c):
        new = body(c)
        _copy_into(c, new)
        if name is not None:
            tally(TRIPS, name)

    alive = None  # None while no test has been recorded: the loop is alive
    for i in range(niter):
        if alive is None:
            p = keep_going(i, carry)
            if p is None:
                carry = body(carry)
                if name is not None:
                    tally(TRIPS, name)
                continue
            carry = tuple(t.clone() for t in carry)
            alive = p.clone()
            with cap._if_body(cap._handle(alive, negate=False)):
                run(carry)
            continue
        with cap._if_body(cap._handle(alive, negate=False)):
            p = keep_going(i, carry)
            if p is None:
                run(carry)
            else:
                alive.copy_(p)
                with cap._if_body(cap._handle(alive, negate=False)):
                    run(carry)
    return carry


def _nested(extra: int, fn: Callable):
    """Warm-up: ``fn()`` on the stream of the body ``extra`` levels down."""
    st = _STATE
    if extra == 0:
        return fn()
    cap = st.capturer
    cur = torch.cuda.current_stream(cap.device)
    stream = cap._stream(st.depth + extra)
    stream.wait_stream(cur)
    st.depth += extra
    try:
        with torch.cuda.stream(stream):
            out = fn()
    finally:
        st.depth -= extra
    cur.wait_stream(stream)
    return out


class Capturer:
    """Captures CUDA graphs whose code uses :func:`cond` and
    :func:`bounded_while`, on one device.

    Holds a stream for the top level and one per nesting depth of IF
    bodies, the private memory pool that its graphs share (they run one at
    a time and keep no tensor made in a capture alive between replays),
    one pool per body depth, and the device counters of :func:`tally`.
    Graphs captured here stay valid while the Capturer lives."""

    def __init__(self, device):
        from ._build import load_library

        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {self.device}")
        self._index = self.device.index if self.device.index is not None \
            else torch.cuda.current_device()
        self.device = torch.device("cuda", self._index)
        self._lib = load_library("graph_cond")
        with torch.cuda.device(self.device):
            self._streams = [torch.cuda.Stream(self.device) for _ in range(_MAX_DEPTH + 1)]
            self.pool = torch.cuda.graph_pool_handle()
            self._body_pools = [torch.cuda.graph_pool_handle() for _ in range(_MAX_DEPTH)]
        self._pool_uses = [0] * _MAX_DEPTH
        self.counts = torch.zeros(_MAX_COUNTS, dtype=torch.int64, device=self.device)
        self.graphs = []

    def _stream(self, depth: int) -> torch.cuda.Stream:
        if depth > _MAX_DEPTH:
            raise RuntimeError(f"IF bodies nested deeper than {_MAX_DEPTH}")
        return self._streams[depth]

    @contextlib.contextmanager
    def _mode(self, name: str):
        st = _STATE
        if st.mode != "eager":
            raise RuntimeError(f"a {name} inside a {st.mode}")
        st.mode, st.capturer, st.depth = name, self, 0
        try:
            yield
        finally:
            st.mode, st.capturer, st.depth = "eager", None, 0

    def warmup(self, fn: Callable):
        """Run ``fn()`` in warm-up mode on the capture stream; returns its
        result after a device synchronize."""
        cur = torch.cuda.current_stream(self.device)
        s0 = self._streams[0]
        s0.wait_stream(cur)
        with self._mode("warmup"), torch.cuda.device(self.device), torch.cuda.stream(s0):
            out = fn()
        cur.wait_stream(s0)
        torch.cuda.synchronize(self.device)
        return out

    def capture(self, fn: Callable):
        """Capture ``fn()`` into a new graph; returns (graph, fn's result).
        The result's tensors live in the graph's pool: a replay rewrites
        them."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), self._mode("capture"), \
                torch.cuda.graph(graph, pool=self.pool, stream=self._streams[0]):
            out = fn()
        self.graphs.append(graph)
        return graph, out

    def reset_counts(self) -> None:
        self.counts.zero_()

    def read_counts(self) -> dict:
        """The device counters by name (one host read)."""
        values = self.counts.tolist()
        return {name: values[i] for name, i in _SLOTS.items()}

    # -- IF nodes ---------------------------------------------------------

    def _check(self, rc: int, what: str) -> None:
        if rc != 0:
            msg = self._lib.ns_error_string(rc).decode()
            raise RuntimeError(f"{what} failed while capturing a CUDA graph: CUDA error "
                               f"{rc} ({msg})")

    def _handle(self, pred: torch.Tensor, negate: bool) -> ctypes.c_ulonglong:
        """A conditional handle of the graph being captured, set from
        ``pred`` (or its negation) by a kernel captured here."""
        if pred.device != self.device or pred.numel() != 1:
            raise ValueError(f"a condition must be one element on {self.device}")
        if pred.dtype != torch.bool:
            pred = pred != 0
        pred = pred.contiguous()
        handle = ctypes.c_ulonglong(0)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        rc = self._lib.vlgp_cond_handle(ctypes.c_void_p(stream), ctypes.c_void_p(pred.data_ptr()),
                                        int(negate), ctypes.byref(handle))
        self._check(rc, "cudaGraphConditionalHandleCreate")
        return handle

    @contextlib.contextmanager
    def _if_body(self, handle: ctypes.c_ulonglong):
        """Record an IF node on ``handle`` and capture the block's work into
        its body, on the next depth's stream and memory pool."""
        st = _STATE
        depth = st.depth + 1
        stream = self._stream(depth)
        pool = self._body_pools[depth - 1]
        parent = torch.cuda.current_stream(self.device).cuda_stream
        rc = self._lib.vlgp_if_begin(ctypes.c_void_p(parent), ctypes.byref(handle),
                                     ctypes.c_void_p(stream.cuda_stream), _CAPTURE_MODE)
        self._check(rc, "an IF node")
        with torch.cuda.stream(stream):
            torch._C._cuda_beginAllocateToPool(self._index, pool)
            self._pool_uses[depth - 1] += 1
            st.depth = depth
            try:
                yield
            finally:
                st.depth = depth - 1
                torch._C._cuda_endAllocateToPool(self._index, pool)
                rc = self._lib.vlgp_if_end(ctypes.c_void_p(stream.cuda_stream))
        self._check(rc, "the end of an IF body")

    def close(self) -> None:
        """Drop the graphs and give their memory back to the allocator."""
        self.graphs.clear()
        torch.cuda.synchronize(self.device)
        for pool, uses in zip(self._body_pools, self._pool_uses):
            for _ in range(uses):
                torch._C._cuda_releasePool(self._index, pool)
        self._pool_uses = [0] * _MAX_DEPTH
