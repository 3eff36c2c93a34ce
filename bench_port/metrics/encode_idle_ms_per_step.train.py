"""Device-idle ms per training step inside its frozen VAE encode and CLIP
(``train.encode``), in the traced window."""

from bench_port import stages


def read(rec):
    return stages.per_step(rec, ("train.encode",))
