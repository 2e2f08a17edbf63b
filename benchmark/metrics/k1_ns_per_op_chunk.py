"""Executor: K1's device time in the window, by its kernel's name, in
nanoseconds per op chunk (256 op rows) of the window's frames.  The op
chunks are the program's count (``runtime/metrics.py`` ``TOTALS``: the
scans' ``nct`` summed over each launch's streams, no padding), taken per
frame over the process (``op_chunks / frames``) times the window's frames.

A ratio of the process's totals does not depend on where the window
starts, and the cell's traffic is cyclic, so set-up's warm-up GOPs do not
bias it.  A program without the counters reads nothing."""

KERNEL = "mobi_gop_executor"


def read(ctx):
    try:
        from mobiclipdecoder_tpu_torch.runtime.metrics import TOTALS
    except ImportError:
        return None
    if not TOTALS.frames or not TOTALS.op_chunks:
        return None
    chunks = ctx.work["frames"] * TOTALS.op_chunks / TOTALS.frames
    us = ctx.trace.device_us(lambda n: KERNEL in n)
    return us * 1e3 / chunks if us > 0 and chunks else None
