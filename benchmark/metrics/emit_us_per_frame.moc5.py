"""Emit (``runtime/transcode.py`` ``_chunked_video_frames``): the
program's ``mobiclip.emit`` spans in the window, each ``DecodedFrame``'s
three plane copies of a 640x480 frame, in microseconds per frame
delivered.  A file's first frame is emitted before it is delivered: it
moves ``first_frame_p95_ms``."""


def read(ctx):
    us = ctx.trace.span_us("mobiclip.emit")
    return us / ctx.work["frames"] if us > 0 and ctx.work["frames"] else None
