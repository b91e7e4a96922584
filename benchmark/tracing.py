"""Reduction of a ``torch.profiler`` trace of the traced items (whole fits
or whole passes) to what the per-layer metrics read: each device operation's
calls and seconds by name, the busy time (the union of the device
operations' intervals), the traced window, the operations that took the most
time and the longest idle gaps named by what the host was doing."""
from __future__ import annotations

import collections


def _union(spans) -> float:
    """Seconds covered by the union of (start_ns, end_ns) intervals."""
    busy, end, cur = 0, None, None
    for a, b in sorted(spans):
        if end is None or a > end:
            if end is not None:
                busy += end - cur
            cur, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        busy += end - cur
    return busy * 1e-9


def _gaps(spans, lo, hi):
    """Idle intervals (start_ns, end_ns) of the device between lo and hi."""
    out, end = [], lo
    for a, b in sorted(spans):
        if a > end:
            out.append((end, a))
        end = max(end, b)
    if hi > end:
        out.append((end, hi))
    return out


def reduce(events, device_type) -> dict:
    """{"ops": {name: [calls, seconds]}, "busy_s", "window_s", "device_ops",
    "idle_gaps"} from a profiler's kineto events.  The window runs from the
    first to the last event of either side."""
    dev, host = [], []
    for e in events:
        rec = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        if e.device_type() == device_type:
            if not e.is_user_annotation():  # a record_function's device span is no work
                dev.append(rec)
        else:
            host.append(rec)
    if not dev:
        return {"ops": {}, "busy_s": 0.0, "window_s": 0.0, "device_ops": [], "idle_gaps": []}
    lo = min(x[0] for x in dev + host)
    hi = max(x[1] for x in dev + host)
    ops = collections.defaultdict(lambda: [0, 0.0])
    for a, b, name in dev:
        ops[name][0] += 1
        ops[name][1] += (b - a) * 1e-9
    spans = [(a, b) for a, b, _ in dev]
    top = sorted(ops.items(), key=lambda kv: -kv[1][1])[:10]
    gaps = sorted(_gaps(spans, lo, hi), key=lambda g: g[0] - g[1])[:10]
    host.sort()
    named = []
    for a, b in gaps:
        mid = (a + b) // 2
        cover = [h for h in host if h[0] <= mid < h[1]]
        # the innermost host operation running across the gap's middle
        name = max(cover, key=lambda h: h[0])[2] if cover else "host idle"
        named.append([name[:120], (b - a) * 1e-9])
    return {"ops": {k: list(v) for k, v in ops.items()}, "busy_s": _union(spans),
            "window_s": (hi - lo) * 1e-9,
            "device_ops": [[k[:120], v[1]] for k, v in top], "idle_gaps": named}


def matching(ops: dict, *needles, exclude=()) -> tuple:
    """(calls, seconds) of the device operations whose name holds any of
    ``needles`` and none of ``exclude``."""
    calls, secs = 0, 0.0
    for name, (c, s) in ops.items():
        if any(n in name for n in needles) and not any(x in name for x in exclude):
            calls += c
            secs += s
    return calls, secs
