"""The 3x3 conv kernel K7's share of its roofline, its pre-pass (the NHWC
copy of the input) counted in its time: each conv's least time from its
shape, over the two kernels' device time in the traced window."""

from bench_port import flops, readers

BOUNDS = {"conv3x3_kernel": flops.conv_bound}
TIMED = (("conv3x3_kernel", ("conv3x3_wgmma_kernel", "conv3x3_f32_kernel")),
         ("nchw_to_nhwc", ("nchw_to_nhwc_kernel", "nchw_to_nhwc_f32_kernel")))


def read(rec):
    return readers.roofline(rec, BOUNDS, TIMED)
