"""Transfers: ``copy_us_per_frame`` in the file cells, where each chunk
is uploaded and downloaded with a sync and the first chunk's copies are part
of every file's first frame: it moves ``first_frame_p95_ms``."""

from benchmark.harness.spec import reader

read = reader("copy_us_per_frame").read
