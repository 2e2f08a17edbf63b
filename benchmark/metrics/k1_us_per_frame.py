"""Executor (``ops/executor.py`` -> K1, ``csrc/gop_executor.cu``): K1's
device time in the window, by its kernel's name, in microseconds per frame
delivered."""

KERNEL = "mobi_gop_executor"


def read(ctx):
    us = ctx.trace.device_us(lambda n: KERNEL in n)
    return us / ctx.work["frames"] if us > 0 and ctx.work["frames"] else None
