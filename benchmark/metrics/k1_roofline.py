"""Executor: the least time K1's work could take at the card's memory
rate, over K1's device time in the window, in percent.  The bytes are the
frozen counts of ``harness/work.py`` (``k1_bytes``), summed over the
launches of the window's delivered work."""

from benchmark.harness.work import HBM_BYTES_PER_S

KERNEL = "mobi_gop_executor"


def read(ctx):
    us = ctx.trace.device_us(lambda n: KERNEL in n)
    if us <= 0 or not ctx.work["k1_bytes"]:
        return None
    return 100.0 * (ctx.work["k1_bytes"] / HBM_BYTES_PER_S) / (us / 1e6)
