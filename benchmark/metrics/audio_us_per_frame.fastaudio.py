"""Audio (``runtime/transcode.py`` ``decode_moflex``: each chunk's parse
on arrival, then each launch's ``_frame_pcm``, copies, K8 and its wait
included): the program's ``mobiclip.audio`` spans in the window, in
microseconds per frame delivered.  Each frame's chunk precedes its video,
so the first frame's audio is part of every file's first frame: it moves
``first_frame_p95_ms``."""


def read(ctx):
    us = ctx.trace.span_us("mobiclip.audio")
    return us / ctx.work["frames"] if us > 0 and ctx.work["frames"] else None
