"""What the per-layer metric files share: a roofline share over a trace,
and the small statistics of spans.

A kernel family's share is its operations' least time (``flops.py``, per
launch from the shapes in the program's launch counters) over the device
time its kernels took in the traced window.  Where the tracer lost some of
a family's records, its time is the recorded mean per launch times the
launches counted; a family with no record gives no share.
"""

from __future__ import annotations

import statistics
from typing import Callable, Dict, Optional, Sequence, Tuple

from bench_port import flops

__all__ = ["roofline", "median", "mean", "idle_share", "mfu"]

# (counter, kernel name patterns whose records that counter counts)
Timed = Tuple[str, Sequence[str]]


def _family_s(rec, counter: str, patterns: Sequence[str]) -> Optional[float]:
    counted = sum(rec.counters.get(counter, {}).values())
    n = t = 0
    for pat in patterns:
        dn, dt = rec.trace.matching(pat)
        n, t = n + dn, t + dt
    if counted == 0:
        return 0.0 if n == 0 else None
    if n == 0:
        return None
    return t / n * counted


def roofline(rec, bounds: Dict[str, Callable[..., float]],
             timed: Sequence[Timed]) -> Optional[float]:
    """100 x (sum over ``bounds``' counters of launches x least time) /
    (device time of the ``timed`` families); None without a trace or
    without a launch."""
    if rec.trace is None:
        return None
    least = sum(n * fn(*key) for counter, fn in bounds.items()
                for key, n in rec.counters.get(counter, {}).items())
    spent = 0.0
    for counter, patterns in timed:
        s = _family_s(rec, counter, patterns)
        if s is None:
            return None
        spent += s
    if least == 0 or spent == 0:
        return None
    return 100.0 * least / spent


def median(rec, span: str) -> Optional[float]:
    v = rec.spans.get(span)
    return statistics.median(v) if v else None


def mean(rec, span: str) -> Optional[float]:
    v = rec.spans.get(span)
    return statistics.fmean(v) if v else None


def idle_share(rec) -> Optional[float]:
    """100 x the traced window's time with no device record in it."""
    if rec.trace is None or rec.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)


def mfu(rec) -> Optional[float]:
    """100 x the window's analytic operations over its wall time and the
    card's bf16 peak."""
    if not rec.window_s:
        return None
    return 100.0 * rec.flops / rec.window_s / flops.PEAK_BF16_FLOPS
