"""What the trace cannot yet see: the share of the window's device-idle
time (``Trace.gaps()``) that no ``mobiclip.*`` host span covers, in
percent.  The rest of the idle time is put down to a layer by its span."""


def read(ctx):
    tr = ctx.trace
    gaps = tr.gaps()
    idle = sum(b - a for a, b in gaps)
    if idle <= 0 or tr.busy_us() <= 0:
        return None
    spans = _merged(iv for ivs in tr.spans.values() for iv in ivs)
    covered, j = 0.0, 0
    for a, b in gaps:       # both lists sorted and disjoint: one sweep
        while j < len(spans) and spans[j][1] <= a:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < b:
            covered += min(b, spans[k][1]) - max(a, spans[k][0])
            k += 1
    return 100.0 * (idle - covered) / idle


def _merged(intervals) -> list[list[float]]:
    """The union of the (start, end) intervals as sorted disjoint ones."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out
