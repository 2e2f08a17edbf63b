"""Executor: ``k1_us_per_frame`` in the MOC5 file cell, where every K1
launch takes the form with the working plane in global memory (640x480
at stride 1024 does not fit a block's shared memory): K1 at B=1 once per
chunk, the first chunk's part of every file's first frame.  It moves
``first_frame_p95_ms``."""

from benchmark.harness.spec import reader

read = reader("k1_us_per_frame").read
