"""The whole chain's share of the card's bf16 peak: the analytic operations
of the images completed (``flops.chain_flops_per_image``) over the
untraced window's wall time, at 989e12 operations/s."""

from bench_port import readers


def read(rec):
    return readers.mfu(rec)
