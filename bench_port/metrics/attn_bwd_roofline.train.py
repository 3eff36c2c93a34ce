"""The flash backward kernels' share of their roofline: K5 (dQ) and K6
(dK/dV), each launch's least time from its shape, over their device time
in the traced window."""

from bench_port import flops, readers


def _dq(b, h, nq, nk, d, dtype):
    return flops.attn_bwd_bounds(b, h, nq, nk, d, dtype)[0]


def _dkv(b, h, nq, nk, d, dtype):
    return flops.attn_bwd_bounds(b, h, nq, nk, d, dtype)[1]


BOUNDS = {"flash_attention_bwd_dq": _dq, "flash_attention_bwd_dkv": _dkv}
TIMED = (("flash_attention_bwd_dq", ("flash_bwd_dq_kernel",
                                     "flash_bwd_dq_f32_kernel")),
         ("flash_attention_bwd_dkv", ("flash_bwd_dkv_kernel",
                                      "flash_bwd_dkv_f32_kernel")))


def read(rec):
    return readers.roofline(rec, BOUNDS, TIMED)
