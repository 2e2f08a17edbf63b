"""Host scan: ``scan_us_per_frame`` in the MOC5 file cell, the one-thread
native scan of each chunk at 1,200 macroblocks a frame; the first chunk's
scan is part of every file's first frame: it moves
``first_frame_p95_ms``."""

from benchmark.harness.spec import reader

read = reader("scan_us_per_frame").read
