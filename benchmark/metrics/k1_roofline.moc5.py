"""Executor: ``k1_roofline`` in the MOC5 file cell, K1's share of its
roofline in its global-memory plane form: the frozen K1 bytes of the
window's files (the same work whatever implements it) at 3.35 TB/s over
K1's device time.  It moves ``first_frame_p95_ms``."""

from benchmark.harness.spec import reader

read = reader("k1_roofline").read
