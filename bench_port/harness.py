"""The benchmark's registry and the record a run keeps.

Everything a cell needs is found by name from ``BENCHMARK.json``: the
configuration's file (``configs/<config>.json``), the traffic mix
(``traffic/<traffic>.json``, whose ``entry`` names the entry module
``entries/<entry>.py``) and each per-layer metric's reader
(``metrics/<metric>.py``).  A later cell is new files and new entries in
``BENCHMARK.json``; nothing here changes.
"""

from __future__ import annotations

import collections
import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

__all__ = ["ROOT", "PKG", "FORBIDDEN", "Cell", "Record", "load_benchmark",
           "find_cell", "load_module", "metric_reader", "forbidden_modules"]

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
# the reference package and its toolchain: a run of the port loads none
FORBIDDEN = ("jax", "jaxlib", "flax", "fgdm_tpu")


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Cell:
    """One workload with what it names, resolved."""

    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    entry: ModuleType
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def load_module(path: Path, name: str) -> ModuleType:
    """A Python file as a module (metric files carry dots in their names,
    so they are loaded by path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def find_cell(name: str, bench: Optional[Dict[str, Any]] = None,
              root: Path = ROOT) -> Cell:
    bench = bench or load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (root / "bench_port" / "traffic" / f"{w['traffic']}.json").read_text())
    entry = load_module(PKG / "entries" / f"{traffic['entry']}.py",
                        f"bench_port.entries.{traffic['entry']}")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return Cell(name, int(w["chips"]), config, traffic, entry, e2e, layer)


def metric_reader(name: str) -> ModuleType:
    return load_module(PKG / "metrics" / f"{name}.py",
                       f"bench_port.metrics.{name.replace('.', '_')}")


class Record:
    """What a run observed: host spans by name, the program's launch
    counters over the window, the trace summary of a traced run, the work
    done and the analytic counts the readers divide by."""

    def __init__(self):
        self.spans: Dict[str, List[float]] = collections.defaultdict(list)
        self.counters: Dict[str, Dict[tuple, int]] = {}
        self.trace = None          # trace.Summary of a ``--trace 1`` run
        self.work = 0              # images of the window's work
        self.window_s = 0.0        # the window's host-clock length
        self.flops = 0.0           # analytic operations of that work

    def span(self, name: str, start: float, end: float) -> None:
        self.spans[name].append(end - start)

    def timed(self, name: str):
        return _Span(self, name)


class _Span:
    def __init__(self, rec: Record, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.rec.span(self.name, self.t0, time.perf_counter())
        return False


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``fgdm_tpu_torch`` is not
    ``fgdm_tpu``."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})
