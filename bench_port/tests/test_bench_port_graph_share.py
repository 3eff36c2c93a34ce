"""``graph_step_share.offline`` on a synthetic span store: None without the
``graph`` attribute (a program older than the step graphs), without a
trace or a step in the window; 100 with every step replayed, the share of
replays with a mix."""

from __future__ import annotations

import pytest

from bench_port import harness
from bench_port.trace import Summary
from fgdm_tpu_torch.utils import profiling
from fgdm_tpu_torch.utils.profiling import Span

M = 1_000_000   # ns a ms
NAME = "graph_step_share.offline"


def _spans(steps, start=100):
    """An engine call, a condition factor and one ``sampler.step`` span a
    step of ``steps`` (its attrs), 10 ms each from ``start`` ms."""
    out = [Span(1, "engine.generate", start * M, (start + 800) * M, None, 1,
                {}),
           Span(2, "chain.condition", start * M, (start + 700) * M, 1, 1,
                {"factor": 0})]
    for i, attrs in enumerate(steps):
        s = (start + 10 * i) * M
        out.append(Span(3 + i, "sampler.step", s, s + 10 * M, 2, 1, attrs))
    return out


def _read(monkeypatch, spans, trace=True):
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    monkeypatch.setattr(profiling, "dropped", lambda: 0)
    rec = harness.Record()
    if trace:
        rec.trace = Summary([("k", 0, 1000 * M)], launches=10, start_ns=0,
                            end_ns=1000 * M, lost=0)
    rec.work = 8
    return harness.metric_reader(NAME).read(rec)


@pytest.mark.parametrize("steps, want", [
    ([{}] * 5, None),                                   # no attribute
    ([{"graph": True}] * 70, 100.0),
    ([{"graph": False}] * 4, 0.0),
    ([{"graph": False}] + [{"graph": True}] * 3, 75.0),
    ([{"graph": False}] * 2 + [{}] * 2 + [{"graph": True}] * 4, 50.0),
])
def test_share_of_replayed_steps(monkeypatch, steps, want):
    got = _read(monkeypatch, _spans(steps))
    assert got == (None if want is None else pytest.approx(want))


def test_none_without_a_trace_or_a_step_in_the_window(monkeypatch):
    steps = [{"graph": True}] * 3
    assert _read(monkeypatch, _spans(steps), trace=False) is None
    assert _read(monkeypatch, _spans(steps, start=5000)) is None
    assert _read(monkeypatch, _spans([])) is None
