"""Majesco codec — stub parity with the reference (documented, not decodable).

The reference ships an LZ+Huffman inflater for the Majesco compression
algorithm (patent US7353233) that is *incomplete by design*: its
`UncompressBlock` body is empty and `Inflate()` constructs the object and
returns null (LibMobiclip/Codec/Majesco/MajescoInflater.cs:127-130, 368-372);
`MajescoDecoder` is an empty shell (MajescoDecoder.cs:10-17).  Per SURVEY.md
§2 #33 the parity target is the same surface, honestly documented: the
working pieces (header parsing, the bit reader, the canonical two-level
Huffman decode-table builder, and the distance/length base+extra-bit tables)
are implemented and tested; `inflate()` returns None exactly like the
reference returns null.

Format facts mirrored from the reference:
  * 256 + 32 literal symbols, 32 distance symbols, codes up to 15 bits,
    8-bit primary decode table (MajescoInflater.cs:13-16).
  * payload starts with a u32-LE uncompressed size (:118-119).
  * bit reader: MSB-aligned u32 register refilled 16 bits at a time from
    little-endian u16 words (:351-366) — the same refill cadence as the
    Mobiclip video bit reader.
  * code-length-code transmission order (:85-88) and the distance / bytes-
    to-copy (base, extra-bits) table (:18-82).
"""
from __future__ import annotations

import numpy as np

LITERALS = 256 + 32
DISTANCES = 32
CODE_MAX_BITS = 15
PRIMARY_TABLE_BITS = 8

# Transmission order of the code-length-code lengths (MajescoInflater.cs:85).
CODE_LENGTH_ORDER = np.array(
    [0x10, 0x11, 0x12, 0, 8, 7, 9, 6, 0xA, 5, 0xB, 4, 0xC, 3, 0xD, 2,
     0xE, 1, 0xF, 0], dtype=np.int32)

# (base, extra_bits) per distance code (MajescoInflater.cs:18-82, even rows).
DISTANCE_TABLE = np.array([
    (0x0001, 0), (0x0002, 0), (0x0003, 0), (0x0004, 0), (0x0005, 1),
    (0x0007, 1), (0x0009, 2), (0x000D, 2), (0x0011, 3), (0x0019, 3),
    (0x0021, 4), (0x0031, 4), (0x0041, 5), (0x0061, 5), (0x0081, 6),
    (0x00C1, 6), (0x0101, 7), (0x0181, 7), (0x0201, 8), (0x0301, 8),
    (0x0401, 9), (0x0601, 9), (0x0801, 10), (0x0C01, 10), (0x1001, 11),
    (0x1801, 11), (0x2001, 12), (0x3001, 12), (0x4001, 13), (0x6001, 13),
], dtype=np.int32)

# (base, extra_bits) per bytes-to-copy code (odd rows of the same table;
# code 0 is an escape and unused).
LENGTH_TABLE = np.array([
    (0, 0), (3, 0), (4, 0), (5, 0), (6, 0), (7, 0), (8, 0), (9, 0),
    (10, 0), (11, 1), (13, 1), (15, 1), (17, 1), (19, 2), (23, 2), (27, 2),
    (31, 2), (35, 3), (43, 3), (51, 3), (59, 3), (67, 4), (83, 4), (99, 4),
    (115, 4), (131, 5), (163, 5), (195, 5), (227, 5), (258, 0),
], dtype=np.int32)


def build_decode_table(lengths: np.ndarray,
                       primary_bits: int = PRIMARY_TABLE_BITS):
    """Canonical-Huffman two-level decode LUT (CreateDecodeTable's role,
    MajescoInflater.cs:172-340).

    Returns (primary, secondary, sec_base) where:
      primary[p]  for an 8-bit peek p: if length <= 8, packs
                  (symbol << 4) | length; else packs
                  (sec_index << 4) | 0xF marking a secondary lookup.
      secondary   flat array of (symbol << 4) | length entries indexed by
                  sec_base[sec_index] + low bits of the peek.
    Codes are assigned canonically (shorter codes first, symbol order
    breaking ties), the standard DEFLATE-style construction.
    """
    lengths = np.asarray(lengths, dtype=np.int32)
    if lengths.max(initial=0) > CODE_MAX_BITS:
        raise ValueError("code length exceeds format maximum (15)")
    bl_count = np.bincount(lengths[lengths > 0], minlength=CODE_MAX_BITS + 1)
    # over-subscribed code check
    left = 1
    for bits in range(1, CODE_MAX_BITS + 1):
        left = (left << 1) - int(bl_count[bits])
        if left < 0:
            raise ValueError("over-subscribed code")
    next_code = np.zeros(CODE_MAX_BITS + 2, dtype=np.int64)
    code = 0
    for bits in range(1, CODE_MAX_BITS + 1):
        code = (code + int(bl_count[bits - 1])) << 1
        next_code[bits] = code
    primary = np.zeros(1 << primary_bits, dtype=np.int64)
    secondary: list[int] = []
    sec_base: dict[int, int] = {}
    max_len = int(lengths.max(initial=0))
    for sym in range(len(lengths)):
        ln = int(lengths[sym])
        if ln == 0:
            continue
        c = int(next_code[ln])
        next_code[ln] += 1
        if ln <= primary_bits:
            hi = c << (primary_bits - ln)
            for fill in range(1 << (primary_bits - ln)):
                primary[hi | fill] = (sym << 4) | ln
        else:
            hi = c >> (ln - primary_bits)
            if hi not in sec_base:
                sec_base[hi] = len(secondary)
                secondary.extend([0] * (1 << (max_len - primary_bits)))
                primary[hi] = (sec_base[hi] << 4) | 0xF
            low = c & ((1 << (ln - primary_bits)) - 1)
            base = sec_base[hi]
            shift = max_len - ln
            for fill in range(1 << shift):
                secondary[base + ((low << shift) | fill)] = (sym << 4) | ln
    return primary, np.asarray(secondary, dtype=np.int64), sec_base


class MajescoBitReader:
    """MSB-aligned u32 register, 16-bit LE-word refill (:351-366)."""

    def __init__(self, data: bytes, offset: int = 0):
        self.data = data
        self.offset = offset
        self.bits = 0
        self.n = 0

    def _fill(self) -> None:
        w = self.data[self.offset] | (self.data[self.offset + 1] << 8)
        self.bits |= (w << (16 - self.n)) & 0xFFFFFFFF
        self.offset += 2
        self.n += 16

    def read(self, nbits: int) -> int:
        if self.n < nbits:
            self._fill()
        out = self.bits >> (32 - nbits)
        self.n -= nbits
        self.bits = (self.bits << nbits) & 0xFFFFFFFF
        return out


def get_output_size(data: bytes, offset: int = 0) -> int:
    """u32-LE uncompressed size header (MajescoInflater.cs:374-377)."""
    return int.from_bytes(data[offset:offset + 4], "little")


def inflate(data: bytes, offset: int = 0) -> None:
    """Stub parity: the reference's Inflate constructs the inflater and
    returns null (MajescoInflater.cs:368-372) because UncompressBlock was
    never finished upstream.  We validate the header and return None."""
    _ = get_output_size(data, offset)
    return None


class MajescoDecoder:
    """Empty shell, like the reference (MajescoDecoder.cs:10-17)."""

    def decode(self, *_args, **_kw) -> None:
        return None
