"""Mean host time a training step waits to take its next batch from
``data/prefetch.device_prefetch`` (the pinned copy and the hand-over to the
step's stream), from the benchmark's spans."""

from bench_port import readers


def read(rec):
    v = readers.mean(rec, "next_batch")
    return None if v is None else 1e3 * v
