"""Device wait (``ops/vmem_engine.py``: ``_finish``'s wait on each GOP's
download, ``decode_stream_chunk``'s download): the program's
``mobiclip.device_decode`` spans in the window, how long the host waits on
the card, in microseconds per frame delivered."""


def read(ctx):
    us = ctx.trace.span_us("mobiclip.device_decode")
    return us / ctx.work["frames"] if us > 0 and ctx.work["frames"] else None
