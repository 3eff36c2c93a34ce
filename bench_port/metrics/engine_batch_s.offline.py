"""Median wall time of one engine call (``ChainEngine.generate``, ending on
the host copy of the uint8 images), from the benchmark's spans."""

from bench_port import readers


def read(rec):
    return readers.median(rec, "generate")
