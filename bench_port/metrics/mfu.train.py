"""The whole training step's share of the card's bf16 peak: the analytic
operations of the window's steps (``flops.train_step_flops``, plain and
distillation steps in their cadence) over the untraced window's wall time,
at 989e12 operations/s."""

from bench_port import readers


def read(rec):
    return readers.mfu(rec)
