"""The device trace of a ``--trace 1`` window, summarised in memory, and the
program's launch counters.

The tracer (``torch.profiler`` with CUDA activity) loses the kernel records
of the first few launches of a trace and, in some traces, of its last ones,
whatever the kernel; the launch records stay.  So the window sits between
two pads of spin kernels that take those losses, and the window's own
launches and device records are the ones whose correlation ids lie between
the pads'.  Nothing is written to disk: the summary keeps each device
record's name, start and end.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

__all__ = ["PAD_LAUNCHES", "Summary", "Tracer", "summarize", "union_ns",
           "reset_counters", "read_counters", "device_ops"]

PAD_LAUNCHES = (512, 4096)
PAD_CYCLES = 100_000   # about 50 us a spin kernel on an H100

# (name, start ns, end ns) of one device record
Rec = Tuple[str, int, int]


@dataclasses.dataclass
class Summary:
    """The window's device records, its kernel-launch calls, the device
    window (from the end of the lead pad to the start of the trailing
    pad) and the launches whose device record the tracer lost."""

    records: List[Rec]
    launches: int
    start_ns: int
    end_ns: int
    lost: int

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def busy_s(self) -> float:
        return union_ns(self.records, self.start_ns, self.end_ns) / 1e9

    def by_name(self) -> Dict[str, Tuple[int, float]]:
        """{record name: (count, seconds)}."""
        out: Dict[str, List[float]] = collections.defaultdict(
            lambda: [0, 0.0])
        for name, s, e in self.records:
            out[name][0] += 1
            out[name][1] += (e - s) / 1e9
        return {k: (int(n), t) for k, (n, t) in out.items()}

    def matching(self, pattern: str) -> Tuple[int, float]:
        """(count, seconds) of the records whose name holds ``pattern``."""
        n, t = 0, 0.0
        for name, s, e in self.records:
            if pattern in name:
                n += 1
                t += (e - s) / 1e9
        return n, t

    def idle_gaps(self, k: int = 10) -> List[Tuple[str, float]]:
        """The ``k`` longest stretches with no device record, each named by
        the records on either side."""
        recs = sorted(self.records, key=lambda r: r[1])
        gaps, edge, prev = [], self.start_ns, "window start"
        for name, s, e in recs:
            if s > edge:
                gaps.append((f"after {prev[:70]} / before {name[:70]}",
                             (s - edge) / 1e9))
            if e > edge:
                edge, prev = e, name
        if self.end_ns > edge:
            gaps.append((f"after {prev[:70]} / window end",
                         (self.end_ns - edge) / 1e9))
        return sorted(gaps, key=lambda g: -g[1])[:k]


def union_ns(records, lo: int, hi: int) -> int:
    """Length of the union of the records' intervals clipped to [lo, hi]:
    records on two streams that overlap count once."""
    total, edge = 0, lo
    for _, s, e in sorted(records, key=lambda r: r[1]):
        s, e = max(s, edge), min(e, hi)
        if e > s:
            total += e - s
            edge = e
    return total


def summarize(events, lead: int, trail: int) -> Summary:
    """``events``: ``(kind, name, correlation id, start ns, end ns)`` with
    kind "launch" (a host kernel-launch call) or "device" (a record on the
    device), the lead and trailing pads' launches among them."""
    launches = sorted(c for kind, _, c, _, _ in events if kind == "launch")
    lo, hi = launches[lead - 1], launches[-trail]
    dev = [(n, c, s, e) for kind, n, c, s, e in events if kind == "device"]
    recorded = {c for _, c, _, _ in dev}
    records = [(n, s, e) for n, c, s, e in dev if lo < c < hi]
    lead_ends = [e for _, c, _, e in dev if c <= lo]
    trail_starts = [s for _, c, s, _ in dev if c >= hi]
    run = launches[lead:-trail]
    start = max(lead_ends) if lead_ends else min(s for _, s, _ in records)
    end = min(trail_starts) if trail_starts else max(e for _, _, e in records)
    return Summary(records, len(run), start, end,
                   sum(c not in recorded for c in run))


class Tracer:
    """``with Tracer() as t: run()`` traces ``run`` between the pads; then
    ``t.summary``."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.torch = torch
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._pad(PAD_LAUNCHES[0])
        return self

    def _pad(self, n):
        for _ in range(n):
            self.torch.cuda._sleep(PAD_CYCLES)
        self.torch.cuda.synchronize()

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self._pad(PAD_LAUNCHES[1])
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = summarize(_events(self.prof), *PAD_LAUNCHES)
        return False


def _events(prof):
    import torch

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        kind = e.device_type()
        if kind == cpu:
            name = e.name()
            if "Launch" in name and "Kernel" in name:
                out.append(("launch", name, e.correlation_id(), 0, 0))
        elif kind == cuda and not e.is_user_annotation():
            s = e.start_ns()
            out.append(("device", e.name(), e.correlation_id(), s,
                        s + e.duration_ns()))
    return out


def _program_counters() -> Dict[str, collections.Counter]:
    from fgdm_tpu_torch.kernels import attention, conv, groupnorm

    return {"flash_attention": attention.flash_attention.launches,
            "flash_combine": attention.flash_combine.launches,
            "flash_attention_bwd_dq": attention.flash_attention_bwd_dq.launches,
            "flash_attention_bwd_dkv":
                attention.flash_attention_bwd_dkv.launches,
            "conv3x3_kernel": conv.conv3x3_kernel.launches,
            "nchw_to_nhwc": conv.nchw_to_nhwc.launches,
            "group_norm_silu_kernel": groupnorm.group_norm_silu_kernel.launches}


def reset_counters() -> None:
    for c in _program_counters().values():
        c.clear()


def read_counters() -> Dict[str, Dict[tuple, int]]:
    """{counter: {key: launches}} since ``reset_counters``."""
    return {k: dict(c) for k, c in _program_counters().items()}


def device_ops(summary: Optional[Summary], k: int = 10):
    """The ``k`` device operations that took most time, ``[name, s]``."""
    if summary is None:
        return []
    ranked = sorted(summary.by_name().items(), key=lambda kv: -kv[1][1])
    return [[name[:160], t] for name, (_, t) in ranked[:k]]
