"""Host scan: the share of the native scans' own time spent inside the C++
scanner (``scanner_scan_gop``), in percent (``runtime/metrics.py``
``TOTALS``: ``scan_native_seconds / scan_busy_seconds``).  The rest is the
Python wrapper around it: its buffers, joins and result.

The counters are the process's totals, set-up's warm-up included; a ratio
does not depend on where the window starts, and the cell's traffic is
cyclic, so the warm-up GOPs do not bias it.  A program without the
counters reads nothing."""


def read(ctx):
    try:
        from mobiclipdecoder_tpu_torch.runtime.metrics import TOTALS
    except ImportError:
        return None
    if not TOTALS.scan_busy_seconds:
        return None
    return 100.0 * TOTALS.scan_native_seconds / TOTALS.scan_busy_seconds
