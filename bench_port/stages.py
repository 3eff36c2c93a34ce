"""What the stage-idle metrics share: the port's own spans over the traced
window, and the device's idle time inside them.

The spans are ``fgdm_tpu_torch.utils.profiling``'s, recorded while the
traced window's profiler records, on the clock of the device records; the
device records and the window (``[start_ns, end_ns]``) are the trace
summary's.  An idle stretch counts once, for the spans open while the
device waited (``profiling.idle_within``).  Each value is None without a
trace, without the program's span recorder (a program older than it),
without a span of the stages asked for in the window, or when the
recorder dropped a span.
"""

from __future__ import annotations

from typing import Optional, Sequence

__all__ = ["window_spans", "idle_ms", "per_image", "per_step"]


def window_spans(rec) -> Optional[list]:
    """The recorder's spans that overlap the traced window, or None."""
    if rec.trace is None:
        return None
    try:
        from fgdm_tpu_torch.utils import profiling
    except ImportError:
        return None
    if profiling.dropped():
        return None
    lo, hi = rec.trace.start_ns, rec.trace.end_ns
    got = [s for s in profiling.spans() if s.start_ns < hi and s.end_ns > lo]
    return got or None


def idle_ms(rec, spans, names: Sequence[str]) -> float:
    """Device-idle ms of the traced window inside the spans named
    ``names``, clipped to the window."""
    from fgdm_tpu_torch.utils.profiling import idle_within

    return idle_within(rec.trace.records, rec.trace.start_ns,
                       rec.trace.end_ns,
                       [(s.start_ns, s.end_ns) for s in spans
                        if s.name in names]) / 1e6


def _found(spans, names) -> bool:
    return spans is not None and any(s.name in names for s in spans)


def per_image(rec, names: Sequence[str], minus: Sequence[str] = ()
              ) -> Optional[float]:
    """Idle ms inside ``names``' spans, less that inside ``minus``' (spans
    that lie within them), over the window's images."""
    spans = window_spans(rec)
    if not _found(spans, names) or not rec.work:
        return None
    ms = idle_ms(rec, spans, names)
    if minus:
        ms -= idle_ms(rec, spans, minus)
    return ms / rec.work


def per_step(rec, names: Sequence[str]) -> Optional[float]:
    """Idle ms inside ``names``' spans over the window's ``train.step``
    spans."""
    spans = window_spans(rec)
    if not _found(spans, names):
        return None
    steps = sum(s.name == "train.step" for s in spans)
    return idle_ms(rec, spans, names) / steps if steps else None
