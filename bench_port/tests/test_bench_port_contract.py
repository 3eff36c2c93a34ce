"""BENCHMARK.json against the benchmark's contract, and the registry that
finds a cell's files by name."""

from __future__ import annotations

import ast
import json
import re

import pytest

from bench_port import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_and_sizes(bench):
    assert set(bench) == KEYS
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (harness.ROOT / p).is_dir()
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    # the full check's time: 2 + 14 runs a cell, 24 cells at most
    r = bench["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    assert (2 + 14 * 24) * (r + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys(bench):
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("bench_port/")
        assert (harness.ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.add(c["name"])
    used = set()
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
    assert used == names
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_reports_what_it_must(bench):
    for w in bench["workloads"]:
        cell = harness.find_cell(w["name"], bench)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    harness.load_benchmark()["per_layer"]])
def test_every_metric_has_a_reader(metric):
    """Each per-layer metric is a file of its own, found by the name
    BENCHMARK.json gives it; the file holds only its reader."""
    mod = harness.metric_reader(metric)
    assert callable(mod.read)
    assert not {"NAME", "UNIT", "LAYER", "MOVES"} & set(vars(mod))


def test_a_cell_added_as_files_is_found(tmp_path, bench):
    """A new configuration, traffic mix and cell, as files and entries
    only, resolve through the registry with no code changed."""
    (tmp_path / "bench_port" / "traffic").mkdir(parents=True)
    cfg = json.loads((harness.PKG / "configs" /
                      "sd14_fgdm_seg_chain.json").read_text())
    cfg["sampler"]["f2_steps"] = 30
    (tmp_path / "bench_port" / "new.json").write_text(json.dumps(cfg))
    traffic = json.loads((harness.PKG / "traffic" /
                          "offline_b8.json").read_text())
    traffic["batch"] = 4
    (tmp_path / "bench_port/traffic/offline_b4.json").write_text(
        json.dumps(traffic))
    bench = json.loads(json.dumps(bench))
    bench["configs"].append({"name": "new_cfg", "source": "x",
                             "file": "bench_port/new.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "new_cell", "config": "new_cfg",
                               "traffic": "offline_b4", "chips": 1,
                               "why": "x"})
    for m in bench["end_to_end"]:
        if "images_per_s" == m["name"]:
            m["workloads"].append("new_cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.find_cell("new_cell", root=tmp_path)
    assert cell.config["sampler"]["f2_steps"] == 30
    assert cell.traffic["batch"] == 4
    assert cell.entry.__name__ == "bench_port.entries.chain"
    assert {m["name"] for m in cell.end_to_end} == {"images_per_s",
                                                     "setup_s"}
    # per-layer metrics name their cells: a new cell reports none until an
    # entry lists it
    assert cell.per_layer == []


def test_forbidden_modules_compares_whole_top_level_names():
    mods = {"fgdm_tpu_torch": 1, "fgdm_tpu_torch.kernels": 1, "jaxtyping": 1,
            "fgdm_tpu.cli": 1, "jax": 1, "jaxlib.xla": 1, "flax.linen": 1,
            "flaxen": 1, "numpy": 1}
    assert harness.forbidden_modules(mods) == ["fgdm_tpu.cli", "flax.linen",
                                              "jax", "jaxlib.xla"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_sources_import_neither_jax_nor_the_reference_package():
    for path in harness.PKG.rglob("*.py"):
        assert not set(_imports(path)) & set(harness.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (harness.PKG / "reference").rglob("*.py"):
        assert "fgdm_tpu_torch" not in set(_imports(path)), path
