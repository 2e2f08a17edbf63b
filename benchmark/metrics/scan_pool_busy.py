"""Host scan: how busy the scan pool's threads are, in percent: the native
whole-GOP scans' own time in their threads over the scan stages' wall time
times the threads that could run (``runtime/metrics.py`` ``TOTALS``:
``scan_busy_seconds / scan_slot_seconds``).

The counters are the process's totals, set-up's warm-up included; a ratio
does not depend on where the window starts, and the cell's traffic is
cyclic, so the warm-up GOPs do not bias it.  A program without the
counters reads nothing."""


def read(ctx):
    try:
        from mobiclipdecoder_tpu_torch.runtime.metrics import TOTALS
    except ImportError:
        return None
    if not TOTALS.scan_slot_seconds:
        return None
    return 100.0 * TOTALS.scan_busy_seconds / TOTALS.scan_slot_seconds
