"""Pack (``ops/packing.py``): the program's ``mobiclip.pack`` spans in the
window, in microseconds per frame delivered."""


def read(ctx):
    us = ctx.trace.span_us("mobiclip.pack")
    return us / ctx.work["frames"] if us > 0 and ctx.work["frames"] else None
