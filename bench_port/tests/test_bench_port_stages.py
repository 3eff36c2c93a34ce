"""The stage-idle readers on a synthetic trace summary and span store: each
gives its hand-computed value, and None without a trace, without a span in
the window, with a dropped span, or without the program's recorder."""

from __future__ import annotations

import sys

import pytest

from bench_port import harness
from bench_port.trace import Summary
from fgdm_tpu_torch import utils
from fgdm_tpu_torch.utils import profiling
from fgdm_tpu_torch.utils.profiling import Span

M = 1_000_000   # ns a ms

CHAIN = ("condition_idle_ms_per_image.offline",
         "image_idle_ms_per_image.offline",
         "engine_other_idle_ms_per_image.offline")
TRAIN = ("encode_idle_ms_per_step.train", "fwd_bwd_idle_ms_per_step.train",
         "update_idle_ms_per_step.train")


def _spans(rows):
    """``(name, start ms, end ms, parent index or None)`` -> Spans, ids
    from 1 in row order, each root the outermost ancestor's."""
    out = []
    for i, (name, s, e, up) in enumerate(rows, start=1):
        root = i if up is None else out[up - 1].root
        out.append(Span(i, name, s * M, e * M, up, root, {}))
    return out


# the window [0, 1000] ms; device busy [100, 300] (two streams), [500,
# 600], [900, 950]: idle [0, 100], [300, 500], [600, 900], [950, 1000]
CHAIN_RECORDS = [("k", 100 * M, 200 * M), ("copy", 150 * M, 300 * M),
                 ("k", 500 * M, 600 * M), ("k", 900 * M, 950 * M)]
CHAIN_SPANS = _spans([
    ("engine.generate", 50, 980, None),
    ("engine.contexts", 50, 120, 1),
    ("chain.condition", 120, 550, 1),
    ("sampler.step", 120, 330, 3),
    ("sampler.step", 330, 550, 3),
    ("vae.decode", 550, 555, 1),
    ("chain.hint", 555, 560, 1),
    ("chain.image", 560, 920, 1),
    ("engine.to_host", 920, 980, 1),
    ("engine.generate", 1100, 1200, None),   # after the window: left out
])
# over 2 images: idle inside the condition factor [300, 500] = 200 ms,
# the image factor [600, 900] = 300 ms, the engine call 50 + 200 + 300 +
# 30 = 580 ms, so outside both factors 80 ms
CHAIN_WANT = (100.0, 150.0, 40.0)

# two steps and a batch fetch between them; device busy [20, 80], [100,
# 300], [400, 480], [500, 600], [650, 930] of the window [0, 1000]
TRAIN_RECORDS = [("k", 20 * M, 80 * M), ("k", 100 * M, 300 * M),
                 ("k", 400 * M, 480 * M), ("copy", 500 * M, 600 * M),
                 ("k", 650 * M, 930 * M)]
TRAIN_SPANS = _spans([
    ("train.step", 0, 500, None),
    ("train.encode", 0, 100, 1),        # idle 40
    ("train.forward", 100, 250, 1),     # idle 0
    ("train.backward", 250, 400, 1),    # idle 100
    ("train.update", 400, 480, 1),      # idle 0
    ("data.next_batch", 500, 520, None),
    ("train.step", 520, 1000, None),
    ("train.encode", 520, 600, 7),      # idle 0
    ("train.forward", 600, 700, 7),     # idle 50
    ("train.backward", 700, 900, 7),    # idle 0
    ("train.update", 900, 990, 7),      # idle 60
])
TRAIN_WANT = (20.0, 75.0, 30.0)


def _rec(records, work=2):
    rec = harness.Record()
    rec.trace = Summary(records, launches=10, start_ns=0, end_ns=1000 * M,
                        lost=0)
    rec.work = work
    return rec


@pytest.fixture
def store(monkeypatch):
    """Replace the recorder's store: ``store(spans, dropped=0)``."""
    def put(spans, dropped=0):
        monkeypatch.setattr(profiling, "spans", lambda: list(spans))
        monkeypatch.setattr(profiling, "dropped", lambda: dropped)
    return put


def _read(name, rec):
    return harness.metric_reader(name).read(rec)


@pytest.mark.parametrize("name, want", list(zip(CHAIN, CHAIN_WANT))
                         + list(zip(TRAIN, TRAIN_WANT)))
def test_reader_gives_its_hand_computed_value(store, name, want):
    chain = name in CHAIN
    store(CHAIN_SPANS if chain else TRAIN_SPANS)
    rec = _rec(CHAIN_RECORDS if chain else TRAIN_RECORDS)
    assert _read(name, rec) == pytest.approx(want)


def test_chain_stages_add_up_to_the_idle_time_inside_the_engine_calls(
        store):
    store(CHAIN_SPANS)
    rec = _rec(CHAIN_RECORDS)
    whole = profiling.idle_within(
        CHAIN_RECORDS, 0, 1000 * M,
        [(s.start_ns, s.end_ns) for s in CHAIN_SPANS
         if s.name == "engine.generate"]) / M / rec.work
    assert sum(_read(n, rec) for n in CHAIN) == pytest.approx(whole)


@pytest.mark.parametrize("name", CHAIN + TRAIN)
def test_reader_gives_none_without_what_it_reads(store, monkeypatch, name):
    chain = name in CHAIN
    spans = CHAIN_SPANS if chain else TRAIN_SPANS
    records = CHAIN_RECORDS if chain else TRAIN_RECORDS
    store(spans)
    rec = _rec(records)
    assert _read(name, rec) is not None
    rec.trace = None                          # an untraced run
    assert _read(name, rec) is None
    store([s._replace(start_ns=s.start_ns + 2000 * M,
                      end_ns=s.end_ns + 2000 * M) for s in spans])
    assert _read(name, _rec(records)) is None     # no span in the window
    store(TRAIN_SPANS if chain else CHAIN_SPANS)
    assert _read(name, _rec(records)) is None     # the other cell's stages
    store(spans, dropped=1)
    assert _read(name, _rec(records)) is None     # the store dropped one
    store(spans)
    # an older program, without the recorder
    monkeypatch.delattr(utils, "profiling")
    monkeypatch.setitem(sys.modules, "fgdm_tpu_torch.utils.profiling", None)
    assert _read(name, _rec(records)) is None
