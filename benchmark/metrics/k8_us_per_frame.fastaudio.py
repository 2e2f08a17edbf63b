"""Audio (``runtime/transcode.py`` ``_decode_fastaudio`` ->
``ops/audio_lpc.py`` -> K8, ``csrc/audio.cu``): K8's device time in the
window, by its kernel's name, in microseconds per frame delivered.  Each
frame's chunk precedes its video, so the first launch's K8 is part of
every file's first frame: it moves ``first_frame_p95_ms``.  A program
that decodes FastAudio on the host launches no K8 and reads nothing."""

KERNEL = "mobi_fastaudio"


def read(ctx):
    us = ctx.trace.device_us(lambda n: KERNEL in n)
    return us / ctx.work["frames"] if us > 0 and ctx.work["frames"] else None
