"""Device ms per image of the library's copies and casts (the parameters'
float32 -> bf16 casts at every forward, ``.contiguous()`` copies) and of
cuDNN's NCHW <-> NHWC layout transposes, in the traced window."""

# kernel names: PyTorch's copy (and dtype-converting copy) kernels, cuDNN's
# layout transposes (the port's own K7 pre-pass is lower-case
# ``nchw_to_nhwc_kernel`` and is not among them)
PATTERNS = ("direct_copy_kernel", "copy_kernel", "nchwToNhwc", "nhwcToNchw")


def read(rec):
    if rec.trace is None or not rec.work:
        return None
    total = 0.0
    for name, s, e in rec.trace.records:
        if any(p in name for p in PATTERNS):
            total += (e - s) / 1e9
    return 1e3 * total / rec.work
