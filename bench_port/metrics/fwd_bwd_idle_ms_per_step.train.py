"""Device-idle ms per training step inside its forward and backward
(``train.forward`` and ``train.backward``: the UNet, the loss and the
checkpoints' recompute), in the traced window."""

from bench_port import stages


def read(rec):
    return stages.per_step(rec, ("train.forward", "train.backward"))
