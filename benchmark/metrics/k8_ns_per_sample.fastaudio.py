"""Audio: K8's device time in the window, by its kernel's name, in
nanoseconds per FastAudio sample a channel of the window's frames.  The
samples are the program's count (``runtime/metrics.py`` ``TOTALS``:
``fastaudio_samples``, what the transcoder's lattice synthesised, rows
summed, padding left out), taken per frame over the process
(``fastaudio_samples / frames``) times the window's frames, as
``k1_ns_per_op_chunk`` takes its op chunks.  The channels of a launch run
side by side, so this is the time of one serial sample over the channels.
A program without the counter reads nothing."""

KERNEL = "mobi_fastaudio"


def read(ctx):
    try:
        from mobiclipdecoder_tpu_torch.runtime.metrics import TOTALS
    except ImportError:
        return None
    samples = getattr(TOTALS, "fastaudio_samples", 0)
    if not TOTALS.frames or not samples:
        return None
    n = ctx.work["frames"] * samples / TOTALS.frames
    us = ctx.trace.device_us(lambda name: KERNEL in name)
    return us * 1e3 / n if us > 0 and n else None
