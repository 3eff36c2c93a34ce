"""The traced window's share with no operation on the device: 1 - the union
of the device records' intervals over the window (records on the copy and
compute streams that overlap count once)."""

from bench_port import readers


def read(rec):
    return readers.idle_share(rec)
