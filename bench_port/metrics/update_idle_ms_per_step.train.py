"""Device-idle ms per training step inside its update (``train.update``:
gradient norm, AdamW, EMA), in the traced window."""

from bench_port import stages


def read(rec):
    return stages.per_step(rec, ("train.update",))
