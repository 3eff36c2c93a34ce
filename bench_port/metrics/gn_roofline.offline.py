"""The fused GroupNorm+SiLU kernel K4's share of its roofline (one read,
one write), over its device time in the traced window."""

from bench_port import flops, readers


def _bound(shape, eps, dtype):
    return flops.gn_bound(shape, dtype)


BOUNDS = {"group_norm_silu_kernel": _bound}
TIMED = (("group_norm_silu_kernel", ("gn_silu_kernel",)),)


def read(rec):
    return readers.roofline(rec, BOUNDS, TIMED)
