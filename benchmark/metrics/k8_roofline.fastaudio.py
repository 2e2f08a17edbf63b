"""Audio: the least time K8's work could take at the card's memory rate,
over K8's device time in the window, in percent.  The bytes are the
driver's frozen ``k8_bytes`` (``drivers/fastaudio_file.py``: packets in,
samples out, each channel's state a launch), summed over the window's
delivered files.  K8 is bound by each channel's serial chain of samples,
not by bytes, so this reads far below 1%."""

from benchmark.harness.work import HBM_BYTES_PER_S

KERNEL = "mobi_fastaudio"


def read(ctx):
    us = ctx.trace.device_us(lambda n: KERNEL in n)
    if us <= 0 or not ctx.work.get("k8_bytes"):
        return None
    return 100.0 * (ctx.work["k8_bytes"] / HBM_BYTES_PER_S) / (us / 1e6)
