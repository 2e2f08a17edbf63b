"""Host scan: ``scan_us_per_frame`` in the file cells, where
``decode_stream_chunk`` records a ``mobiclip.scan`` span around each
chunk's native scan (checkpoint, ``scan_gop_packed``, rollback) and its
per-packet fallback; the first chunk's scan is part of every file's first
frame: it moves ``first_frame_p95_ms``."""

from benchmark.harness.spec import reader

read = reader("scan_us_per_frame").read
