"""What a CUDA graph capture of the hand-written kernels has to take with it.

Each kernel wrapper counts its launches in a ``collections.Counter`` on
the function (``flash_attention.launches``, ...), through ``count`` when
it launches.  A graph's replay runs the captured kernels again and none of
that Python.  So while a thread has a ``Capture`` open, ``count`` puts
that thread's launches into the capture's delta and leaves the counters
alone (a capture runs nothing on the device); whoever replays the graph
adds the delta once a replay (``add_launches``).  The counts then read as
if every replay had run eagerly, and another thread's eager launches
during a capture are counted as they run.

A captured launch also reads tensors made outside the graph's memory:
the conv's weight packs, kept per weight (``conv.packed_weight``).  While
a thread has a capture open, ``keep`` hands each such tensor to it, and
the capture holds them as long as its graph lives.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List

__all__ = ["launch_counters", "count", "Capture", "add_launches", "keep"]

# the capture each thread has open, if any
_local = threading.local()


def launch_counters() -> Dict[str, collections.Counter]:
    """The kernels' launch counters, by wrapper name."""
    from fgdm_tpu_torch.kernels import attention, conv, groupnorm

    fns = (attention.flash_attention, attention.flash_combine,
           attention.flash_attention_bwd_dq, attention.flash_attention_bwd_dkv,
           conv.conv3x3_kernel, conv.nchw_to_nhwc,
           groupnorm.group_norm_silu_kernel)
    return {fn.__name__: fn.launches for fn in fns}


def count(fn, key: tuple) -> None:
    """One launch by the wrapper ``fn`` under ``key``: into
    ``fn.launches``, or into the delta of this thread's open capture."""
    c = getattr(_local, "capture", None)
    if c is None:
        fn.launches[key] += 1
    else:
        c.delta.setdefault(fn.__name__, collections.Counter())[key] += 1


def add_launches(delta: Dict[str, Dict[tuple, int]]) -> None:
    """Count ``delta``'s launches once more, as one replay of a capture."""
    counters = launch_counters()
    for name, d in delta.items():
        counters[name].update(d)


def keep(*tensors) -> None:
    """Hold ``tensors`` for this thread's open capture, if it has one."""
    c = getattr(_local, "capture", None)
    if c is not None:
        c.kept.extend(tensors)


class Capture:
    """``with Capture() as c: <capture a graph>``; then ``c.delta`` is the
    launches this thread counted inside, ``{counter: {key: n}}``, and
    ``c.kept`` the tensors the captured launches read outside the graph's
    memory.  The counters are left as they were."""

    def __init__(self):
        self.delta: Dict[str, collections.Counter] = {}
        self.kept: List = []

    def __enter__(self):
        if getattr(_local, "capture", None) is not None:
            raise RuntimeError("a capture is already open on this thread")
        _local.capture = self
        return self

    def __exit__(self, *exc):
        _local.capture = None
        return False
