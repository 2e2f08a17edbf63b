"""Host scan: ``scan_native_share`` in the file cells, where one thread
scans each chunk of the transcoder, the first chunk's scan part of every
file's first frame: it moves ``first_frame_p95_ms``."""

from benchmark.harness.spec import reader

read = reader("scan_native_share").read
