"""Share of the sampler's steps in the traced window that replayed a CUDA
graph: the ``sampler.step`` spans whose ``graph`` attribute is True, over
all ``sampler.step`` spans of the window.  None where no step carries the
attribute (a program that graphs no step)."""

from bench_port import stages


def read(rec):
    spans = stages.window_spans(rec)
    steps = [s for s in spans or () if s.name == "sampler.step"]
    if not any("graph" in s.attrs for s in steps):
        return None
    replayed = sum(s.attrs.get("graph") is True for s in steps)
    return 100.0 * replayed / len(steps)
