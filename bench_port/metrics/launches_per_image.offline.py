"""Kernel launches the host made in the traced window, per image."""


def read(rec):
    if rec.trace is None or not rec.work:
        return None
    return rec.trace.launches / rec.work
