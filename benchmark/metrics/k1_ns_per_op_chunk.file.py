"""Executor: ``k1_ns_per_op_chunk`` in the file cells, where K1 runs at B=1
once per chunk of the transcoder and the first chunk's K1 is part of
every file's first frame: it moves ``first_frame_p95_ms``."""

from benchmark.harness.spec import reader

read = reader("k1_ns_per_op_chunk").read
