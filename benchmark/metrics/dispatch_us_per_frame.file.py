"""Dispatch: ``dispatch_us_per_frame`` in the file cells, where each chunk
of the transcoder is uploaded and launched at B=1 and the first chunk's
dispatch is part of every file's first frame: it moves
``first_frame_p95_ms``."""

from benchmark.harness.spec import reader

read = reader("dispatch_us_per_frame").read
