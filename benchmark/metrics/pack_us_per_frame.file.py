"""Pack: ``pack_us_per_frame`` in the file cells, where the transcoder's
``decode_stream_chunk`` packs each chunk and the first chunk's pack is part
of every file's first frame: it moves ``first_frame_p95_ms``."""

from benchmark.harness.spec import reader

read = reader("pack_us_per_frame").read
