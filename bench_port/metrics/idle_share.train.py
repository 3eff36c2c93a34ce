"""The traced window's share with no operation on the device (see
``idle_share.offline``)."""

from bench_port import readers


def read(rec):
    return readers.idle_share(rec)
