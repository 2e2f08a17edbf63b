"""The device: ``device_idle`` in the file cells, where the card waits on
the host's work around each chunk (demux, scan, audio, the decoder's
set-up), as every file's first frame does: it moves
``first_frame_p95_ms``."""

from benchmark.harness.spec import reader

read = reader("device_idle").read
