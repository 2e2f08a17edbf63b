"""Device wait: ``device_wait_us_per_frame`` in the file cells, where the
host waits on each chunk's download before it emits the chunk's frames,
the first chunk's wait part of every file's first frame: it moves
``first_frame_p95_ms``."""

from benchmark.harness.spec import reader

read = reader("device_wait_us_per_frame").read
