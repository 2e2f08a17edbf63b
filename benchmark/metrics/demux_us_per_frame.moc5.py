"""Demux (``containers/moc5.py``, walked by ``runtime/transcode.py``
``decode_moc5``): the program's ``mobiclip.demux`` spans in the window, in
microseconds per frame delivered.  A program whose ``decode_moc5`` records
no such span reads nothing here.  Each file's walk comes before its first
frame: it moves ``first_frame_p95_ms``."""


def read(ctx):
    us = ctx.trace.span_us("mobiclip.demux")
    return us / ctx.work["frames"] if us > 0 and ctx.work["frames"] else None
