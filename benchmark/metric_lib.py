"""Helpers shared by the metric readers in ``metrics/``."""
from __future__ import annotations

from tracing import matching  # noqa: F401  (readers import it from here)


def least_s(run, work) -> float:
    """The least time of (FMAs, bytes) on the card: the larger of its
    operations at the FP32 peak and its bytes at the memory bandwidth."""
    fma, nbytes = work
    return max(2.0 * fma / run.peaks["flops_fp32"], nbytes / run.peaks["bytes_per_s"])


def traced_items(run) -> list:
    return run.items[: int(run.traffic.get("trace_items", 2))]


def kind(run) -> str:
    return run.traffic["kind"]


def mean(xs):
    xs = list(xs)
    return sum(xs) / len(xs) if xs else None


def share(num: float, den: float):
    """100 num / den, or None where there is nothing to read."""
    return 100.0 * num / den if den > 0 and num > 0 else None
