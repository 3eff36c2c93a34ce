"""Spans of the port's stages, recorded while a ``torch.profiler`` records.

Counterpart of ``fgdm_tpu/utils/profiling.py``: where JAX names a traced
region for ``jax.profiler``, the port opens ``span(name, **attrs)`` around
each stage of its paths (``engine.generate``, ``chain.condition``,
``sampler.step``, ``train.backward``, ...).  Tracing is on while a
``torch.profiler`` records, and nothing else switches it: an operator
traces a job as any PyTorch job, and the exported Chrome trace shows the
port's stages above the kernels, since each span also enters
``torch.profiler.record_function(name)``.

With no profiler recording, ``span`` returns one shared no-op object and
keeps nothing.  With one, each span keeps ``Span(id, name, start_ns,
end_ns, parent, root, attrs)`` in a bounded store in memory: the times
from ``time.time_ns()``, the clock the profiler stamps its events with;
``parent`` the id of the enclosing span of the same thread (``None`` for
an outermost span), ``root`` the id of the outermost one, so all spans of
one engine call or one training step share it.  Past ``CAPACITY`` spans
the store counts what it drops.  Nothing is written to disk.

``idle_within`` puts the device's idle time down to the spans: the
window minus the union of the device records, inside the union of the
spans' intervals.
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time
from typing import (Any, Dict, Iterable, List, NamedTuple, Optional,
                    Sequence, Tuple)

import torch
import torch.autograd.profiler as _profiler

__all__ = ["CAPACITY", "Span", "span", "spans", "dropped", "clear",
           "idle_within"]

CAPACITY = 1 << 17


class Span(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    root: int
    attrs: Dict[str, Any]


_store: List[Span] = []
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
# the open span of this thread (a new thread starts with none)
_open: contextvars.ContextVar = contextvars.ContextVar("fgdm_span",
                                                      default=None)


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "attrs", "id", "parent", "root", "token", "fn",
                 "start")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        up = _open.get()
        self.id = next(_ids)
        self.parent = None if up is None else up.id
        self.root = self.id if up is None else up.root
        self.token = _open.set(self)
        # stamped before the profiler's event opens and after it closes,
        # so the event lies inside the span
        self.start = time.time_ns()
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        return self

    def __exit__(self, *exc):
        self.fn.__exit__(*exc)
        end = time.time_ns()
        _open.reset(self.token)
        _keep(Span(self.id, self.name, self.start, end, self.parent,
                   self.root, self.attrs))
        return False


def _keep(s: Span) -> None:
    global _dropped
    with _lock:
        if len(_store) < CAPACITY:
            _store.append(s)
        else:
            _dropped += 1


def span(name: str, **attrs):
    """A context manager that records ``name`` while a profiler records;
    else the shared no-op.  Pass only cheap constants as ``attrs``."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _On(name, attrs)


def spans() -> List[Span]:
    """A copy of the store, in the order the spans ended."""
    with _lock:
        return list(_store)


def dropped() -> int:
    """Spans that ended past ``CAPACITY`` and were not kept."""
    return _dropped


def clear() -> None:
    global _dropped
    with _lock:
        _store.clear()
        _dropped = 0


def _merged(pairs: Iterable[Tuple[int, int]], lo: int, hi: int
            ) -> List[Tuple[int, int]]:
    """The union of ``pairs`` clipped to [lo, hi], as sorted disjoint
    intervals."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in pairs):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def idle_within(records: Iterable[Sequence], lo_ns: int, hi_ns: int,
                intervals: Iterable[Tuple[int, int]]) -> int:
    """Nanoseconds the device was idle inside ``intervals``: the window
    [lo_ns, hi_ns] minus the union of the device ``records`` (``(name,
    start_ns, end_ns)``; records on two streams that overlap count once),
    intersected with the union of ``intervals`` (``(start_ns, end_ns)``),
    so each idle stretch counts once, however many spans were open."""
    want = _merged(intervals, lo_ns, hi_ns)
    busy = _merged(((r[1], r[2]) for r in records), lo_ns, hi_ns)
    idle, j = 0, 0
    for s, e in want:
        idle += e - s
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            idle -= min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
    return idle
