"""What the trace cannot yet see: ``idle_unspanned`` in the file cells,
where the card idles while the host demuxes, scans, decodes audio and
copies frames around each chunk, as every file's first frame does: it
moves ``first_frame_p95_ms``."""

from benchmark.harness.spec import reader

read = reader("idle_unspanned").read
