"""Prologue (``ops/prologue.py`` -> K5 ``mobi_prologue_sblob``): the least
time K5's work could take at the card's memory rate, over K5's device time
in the window, in percent.  The bytes are the frozen counts of
``harness/work.py`` (``k5_bytes``)."""

from benchmark.harness.work import HBM_BYTES_PER_S

KERNEL = "mobi_prologue_sblob"


def read(ctx):
    us = ctx.trace.device_us(lambda n: KERNEL in n)
    if us <= 0 or not ctx.work["k5_bytes"]:
        return None
    return 100.0 * (ctx.work["k5_bytes"] / HBM_BYTES_PER_S) / (us / 1e6)
