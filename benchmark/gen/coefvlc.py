"""Coefficient run-level VLC codec: the exact inverse of ReadDCTMatrix.

Shared by the encoder (shortest-code emission, mirroring the reference
EncodeDCT cascade, MobiEncoder.cs:675-765) and the stream synthesizer
(which *forces* specific encoding kinds so tests exercise every branch of
the decoder's VLC: plain table hit, escape 1 (+level offset), escape 2
(+run offset) and escape 3 (fully explicit) — MobiclipDecoder.cs:3330-3432).
"""
from __future__ import annotations

from ..reference.tables import TABLES
from .bitio import BitWriter

KINDS = ("plain", "esc1", "esc2", "esc3")


class CoefCodec:
    """Inverse of ReadDCTMatrix (MobiclipDecoder.cs:3330-3432): per
    (end, run, |level|) the plain table code and the three escape
    fallbacks."""

    def __init__(self, table: int = 0):
        ta = TABLES.coef_vlc1_a if table else TABLES.coef_vlc0_a
        tb = TABLES.coef_vlc1_b if table else TABLES.coef_vlc0_b
        entries = []  # (entry, end, skip, value, code, code_nbits)
        seen = set()
        for idx in range(4096):
            e = int(ta[idx])
            if e in seen or e == 1:  # 0x0001 filler
                continue
            seen.add(e)
            nbits = e & 0xF
            value = (e >> 4) & 0x1F
            skip = (e >> 10) & 0x3F
            end = (e >> 15) & 1
            code = idx >> (12 - (nbits - 1)) if nbits > 1 else 0
            entries.append((e, end, skip, value, code, nbits - 1))
        # plain path: codeword must not collide with the 7-bit escape prefix
        # 0000011 (the decoder checks r3>>25==3 before the table lookup)
        self.plain: dict[tuple[int, int, int], tuple[int, int]] = {}
        # escape 1 (+level offset) / escape 2 (+run offset): the embedded
        # table code is read unconditionally, so every entry is usable
        self.esc1: dict[tuple[int, int, int], tuple[int, int]] = {}
        self.esc2: dict[tuple[int, int, int], tuple[int, int]] = {}
        for e, end, skip, value, code, nb in entries:
            if value == 0:
                continue
            is_escape_prefixed = (nb >= 7 and (code >> (nb - 7)) == 0b0000011)
            if not is_escape_prefixed:
                k = (end, skip, value)
                if k not in self.plain or nb < self.plain[k][1]:
                    self.plain[k] = (code, nb)
            v1 = value + int(tb[e >> 9])
            k = (end, skip, v1)
            if k not in self.esc1 or nb < self.esc1[k][1]:
                self.esc1[k] = (code, nb)
            s2 = skip + int(tb[0x80 + value + (end << 6)])
            k = (end, s2, value)
            if s2 < 64 and (k not in self.esc2 or nb < self.esc2[k][1]):
                self.esc2[k] = (code, nb)
        # (end, run) -> sorted |level| choices, per kind — used by the
        # synthesizer to force coverage of each decode branch
        self.mags: dict[str, dict[tuple[int, int], list[int]]] = {
            "plain": {}, "esc1": {}, "esc2": {}}
        for kind in ("plain", "esc1", "esc2"):
            d = getattr(self, kind)
            inv = self.mags[kind]
            for (end, run, mag) in d:
                inv.setdefault((end, run), []).append(mag)
            for v in inv.values():
                v.sort()

    def _pick(self, end: int, run: int, mag: int):
        """Returns (kind, (code, nbits), total_bits) for the shortest
        encoding of one run-level pair."""
        best = ("esc3", None, 7 + 2 + 1 + 6 + 12)
        if mag < 64 and run < 64:
            k = (end, run, mag)
            c = self.plain.get(k)
            if c is not None and c[1] + 1 < best[2]:
                best = ("plain", c, c[1] + 1)
            c = self.esc1.get(k)
            if c is not None and 8 + c[1] + 1 < best[2]:
                best = ("esc1", c, 8 + c[1] + 1)
            c = self.esc2.get(k)
            if c is not None and 9 + c[1] + 1 < best[2]:
                best = ("esc2", c, 9 + c[1] + 1)
        return best

    def bits(self, end: int, run: int, level: int) -> int:
        return self._pick(end, run, abs(level))[2]

    def emit(self, bw: BitWriter, end: int, run: int, level: int,
             kind: str | None = None) -> None:
        """Emit one run-level pair; ``kind`` forces a specific encoding
        (must be legal for (end, run, |level|)) instead of the shortest."""
        mag = abs(level)
        if kind is None:
            kind, c, _ = self._pick(end, run, mag)
        elif kind != "esc3":
            c = getattr(self, kind)[(end, run, mag)]
        if kind == "plain":
            bw.write_bits(c[0], c[1])
            bw.write_bits(1 if level < 0 else 0, 1)
        elif kind == "esc1":
            bw.write_bits(0b0000011, 7)
            bw.write_bits(0, 1)
            bw.write_bits(c[0], c[1])
            bw.write_bits(1 if level < 0 else 0, 1)
        elif kind == "esc2":
            bw.write_bits(0b0000011, 7)
            bw.write_bits(0b10, 2)
            bw.write_bits(c[0], c[1])
            bw.write_bits(1 if level < 0 else 0, 1)
        else:
            # escape 3: fully explicit (MobiclipDecoder.cs:3391-3405)
            bw.write_bits(0b0000011, 7)
            bw.write_bits(0b11, 2)
            bw.write_bits(end, 1)
            bw.write_bits(run, 6)
            bw.write_bits(level & 0xFFF, 12)


_CODECS: dict[int, CoefCodec] = {}


def codec_for(table: int) -> CoefCodec:
    if table not in _CODECS:
        _CODECS[table] = CoefCodec(table)
    return _CODECS[table]
