"""Decode counters and trace spans (SURVEY.md §5 observability).

The reference's only observability is a percent counter in the CLI
(MobiConverter/Program.cs:168-175).  Here each decoder keeps a
``DecodeMetrics`` of what it did (frames, input bytes, the op chunks its
scans emitted, the time of its native scans, the FastAudio samples the
transcoder synthesised on its device), and every add
also goes to the process-wide ``TOTALS``, which outlives the decoders that a
transcoder builds per file.  Only the thread that drives a decode adds:
scan-pool workers time their own task and return the times in the scan
result.  The counters stay on whether or not a profile is taken.

``span(name)`` is the port's one way to open a ``torch.profiler`` range
(``mobiclip.*``): a ``record_function`` while the profiler records on the
calling thread, else a shared null context, so a span costs one flag check
when tracing is off.  The profiler's state is per thread, so spans are
opened on the driving thread only; no layer's span encloses another's, and
none is open across a ``yield``.
"""
from __future__ import annotations

import contextlib
import dataclasses

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

_NULL = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler`` range named ``name`` while the profiler
    records on this thread, else a no-op context."""
    if _profiler_enabled():
        return record_function(name)
    return _NULL


@dataclasses.dataclass
class DecodeMetrics:
    frames: int = 0
    bytes_in: int = 0
    #: the scans' op chunks (``nct``) summed over the streams of each
    #: executor launch, padding to buckets left out
    op_chunks: int = 0
    #: each native whole-GOP scan's own time, in the thread that ran it,
    #: summed over streams; the part of it inside ``scanner_scan_gop``;
    #: those stages' wall time times the threads that could run
    scan_busy_seconds: float = 0.0
    scan_native_seconds: float = 0.0
    scan_slot_seconds: float = 0.0
    #: the transcoder's ``decode_stream_chunk`` calls that its launch ramp
    #: (``transcode.launch_frames``) made shorter than ``CHUNK_FRAMES``,
    #: with frames of the stream left over after them
    ramp_launches: int = 0
    #: the per-channel samples the transcoder's FastAudio lattice
    #: synthesised (``transcode._FastAudio.decode``), its padding left out
    fastaudio_samples: int = 0

    def add(self, **counts) -> None:
        """Add to these counters and to ``TOTALS``."""
        for k, v in counts.items():
            setattr(self, k, getattr(self, k) + v)
            setattr(TOTALS, k, getattr(TOTALS, k) + v)


#: every decoder's counters in this process, summed
TOTALS = DecodeMetrics()
