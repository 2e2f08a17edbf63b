"""Dispatch (``ops/vmem_engine.py``: ``_upload`` and the enqueue of K5, K1,
the crop, the ring's renormalisation and the download): the program's
``mobiclip.dispatch`` spans in the window, the host's launch cost while the
card waits, in microseconds per frame delivered."""


def read(ctx):
    us = ctx.trace.span_us("mobiclip.dispatch")
    return us / ctx.work["frames"] if us > 0 and ctx.work["frames"] else None
