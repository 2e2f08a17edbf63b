"""Prologue: ``k5_roofline`` in the file cells, where K5 runs once per
chunk of the transcoder and the first chunk's K5 is part
of every file's first frame: it moves ``first_frame_p95_ms``."""

from benchmark.harness.spec import reader

read = reader("k5_roofline").read
