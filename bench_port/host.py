"""What the host did during a window, logged beside the run's numbers: both
cells are paced by the host's dispatch, so their rates follow its speed.

``with Watch() as w:`` around a window; ``w.summary()`` gives the host's
speed on a fixed piece of pure Python before and after (``python_ms``;
higher is slower), the seconds the hypervisor gave the machine's cores to
others (``steal_s``, from ``/proc/stat``), the process's CPU seconds, and
the interpreter's garbage collections inside the window, counted and timed
by generation.
"""

from __future__ import annotations

import gc
import os
import statistics
import time
from typing import Dict

__all__ = ["Watch", "python_ms"]

PROBE_LOOPS = 1_000_000


def python_ms() -> float:
    """The median of three timings of a fixed pure-Python loop, in ms."""
    def once():
        t0 = time.perf_counter()
        x = 0
        for i in range(PROBE_LOOPS):
            x += i & 7
        return 1e3 * (time.perf_counter() - t0)

    return statistics.median(once() for _ in range(3))


def _steal_s() -> float:
    """The machine's stolen core-seconds since boot (0 where the kernel
    does not count them)."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return 0.0


class Watch:
    """Host readings around a ``with`` block (see the module's doc)."""

    def __enter__(self):
        self.n, self.s, self.longest = [0] * 3, [0.0] * 3, 0.0
        self._t0 = None
        self.before = python_ms()
        self.steal0, self.cpu0 = _steal_s(), time.process_time()
        gc.callbacks.append(self._collected)
        return self

    def _collected(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            dt, g = time.perf_counter() - self._t0, info["generation"]
            self.n[g] += 1
            self.s[g] += dt
            self.longest = max(self.longest, dt)
            self._t0 = None

    def __exit__(self, *exc):
        gc.callbacks.remove(self._collected)
        self.steal = _steal_s() - self.steal0
        self.cpu = time.process_time() - self.cpu0
        self.after = python_ms()
        return False

    def summary(self) -> Dict[str, float]:
        out = {"python_ms_before": self.before, "python_ms_after": self.after,
               "steal_s": self.steal, "process_cpu_s": self.cpu,
               "cores": len(os.sched_getaffinity(0))}
        for g in range(3):
            out[f"gc{g}_n"], out[f"gc{g}_s"] = self.n[g], self.s[g]
        out["gc_longest_s"] = self.longest
        return out
