"""The flash forward kernels' share of their roofline: K1 (d = 40/80),
K2/K3 (d = 512) with the combine pass, each launch's least time from its
shape, over those kernels' device time in the traced window."""

from bench_port import flops, readers

BOUNDS = {"flash_attention": flops.attn_fwd_bound}
TIMED = (("flash_attention", ("flash_fwd_kernel", "flash_fwd_d512_kernel",
                              "flash_fwd_f32_kernel",
                              "flash_fwd_d512_f32_kernel")),
         ("flash_combine", ("flash_combine_kernel",)))


def read(rec):
    return readers.roofline(rec, BOUNDS, TIMED)
