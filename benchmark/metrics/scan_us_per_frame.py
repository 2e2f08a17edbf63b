"""Host scan (``utils/native.py`` over ``native/scanner.cpp``): the
program's ``mobiclip.scan`` spans in the window, in microseconds per frame
delivered.  The transcoder's chunk path records no such span, so a file
cell reads nothing here."""


def read(ctx):
    us = ctx.trace.span_us("mobiclip.scan")
    return us / ctx.work["frames"] if us > 0 and ctx.work["frames"] else None
