"""The traced run: torch.profiler over the window, reduced to intervals.

``Trace`` keeps, in microseconds on the profiler's clock, the window's
range, the host spans the program records (``mobiclip.*``
``record_function`` ranges) and each device activity (kernel, memcpy,
memset) with its name.  The per-layer metric readers in
``benchmark/metrics`` read a ``Trace``; nothing here knows a layer.
"""
from __future__ import annotations

import dataclasses

#: the record_function range around the measured window
WINDOW = "benchmark.window"
#: host spans that the program records, by prefix
SPAN_PREFIX = "mobiclip."


@dataclasses.dataclass
class Trace:
    window: tuple[float, float]
    spans: dict[str, list[tuple[float, float]]]
    device: list[tuple[str, float, float]]   # (name, start, end)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def span_us(self, name: str) -> float:
        """Summed length of the host spans ``name`` that start in the
        window."""
        w0, w1 = self.window
        return sum(b - a for a, b in self.spans.get(name, ())
                   if w0 <= a < w1)

    def device_us(self, match) -> float:
        """Summed device time of the activities whose name ``match``
        accepts, clipped to the window."""
        w0, w1 = self.window
        return sum(max(0.0, min(b, w1) - max(a, w0))
                   for n, a, b in self.device if match(n))

    def busy_us(self) -> float:
        return union(((a, b) for _n, a, b in self.device), *self.window)

    def gaps(self) -> list[tuple[float, float]]:
        return gaps([(a, b) for _n, a, b in self.device], *self.window)


def _clip(intervals, w0: float, w1: float):
    return sorted((max(a, w0), min(b, w1)) for a, b in intervals
                  if b > w0 and a < w1)


def union(intervals, w0: float, w1: float) -> float:
    """Length of the union of the (start, end) intervals within [w0, w1]."""
    total, cur = 0.0, None
    for a, b in _clip(intervals, w0, w1):
        if cur is None or a > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        total += cur[1] - cur[0]
    return total


def gaps(intervals, w0: float, w1: float) -> list[tuple[float, float]]:
    """The stretches of [w0, w1] that no interval covers, in order."""
    out, t = [], w0
    for a, b in _clip(intervals, w0, w1):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < w1:
        out.append((t, w1))
    return out


def label(gap: tuple[float, float], spans: dict) -> str:
    """The host span open over most of ``gap``, or "none" where more of
    the gap lies outside every span than inside any one."""
    inside = union((iv for ivs in spans.values() for iv in ivs), *gap)
    best, name = (gap[1] - gap[0]) - inside, "none"
    for n, ivs in spans.items():
        cover = union(ivs, *gap)
        if cover > best:
            best, name = cover, n
    return name


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time in the window (by name,
    seconds summed) and its longest idle gaps (each labelled with the host
    span open over most of it), at most ``top`` of each."""
    by: dict[str, float] = {}
    w0, w1 = tr.window
    for n, a, b in tr.device:
        d = max(0.0, min(b, w1) - max(a, w0))
        if d > 0:
            key = short_name(n)
            by[key] = by.get(key, 0.0) + d
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    gs = sorted(tr.gaps(), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, us / 1e6] for n, us in ops],
            "idle_gaps": [[label(g, tr.spans), (g[1] - g[0]) / 1e6]
                          for g in gs]}


def short_name(name: str) -> str:
    """A device activity's name without its argument list, at most 100
    characters."""
    name = name.split("(")[0] if not name.startswith("void at::") else name
    name = name.removeprefix("void ")
    return name if len(name) <= 100 else name[:97] + "..."


def reduce(events) -> Trace:
    """A Trace from torch.profiler's events (``prof.events()``): the
    window's host range, the ``mobiclip.*`` host spans, and every device
    activity that is not the device-side copy of a host annotation."""
    import torch
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    window = None
    spans: dict[str, list] = {}
    device = []
    for e in events:
        r = (e.time_range.start, e.time_range.end)
        if e.device_type == cpu:
            if e.name == WINDOW:
                window = r
            elif e.name.startswith(SPAN_PREFIX):
                spans.setdefault(e.name, []).append(r)
        elif (e.device_type == cuda
              and not getattr(e, "is_user_annotation", False)
              and e.name != WINDOW and not e.name.startswith(SPAN_PREFIX)):
            device.append((e.name, *r))
    if window is None:
        raise RuntimeError("the trace holds no window range")
    return Trace(window, spans, device)
