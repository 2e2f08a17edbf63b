"""The device: ``device_idle`` in the MOC5 file cell, where the card waits
on the host's demux, scan and emit around each chunk: it moves
``first_frame_p95_ms``."""

from benchmark.harness.spec import reader

read = reader("device_idle").read
