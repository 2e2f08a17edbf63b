"""Transfers (``VmemBatchDecoder._upload``, ``_start_download``): the
device time of the window's host-to-device and device-to-host copies, in
microseconds per frame delivered."""


def _copy(name: str) -> bool:
    low = name.lower()
    return low.startswith("memcpy") and ("htod" in low or "dtoh" in low)


def read(ctx):
    us = ctx.trace.device_us(_copy)
    return us / ctx.work["frames"] if us > 0 and ctx.work["frames"] else None
