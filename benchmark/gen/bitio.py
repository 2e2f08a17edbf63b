"""Bitstream writer matching the Mobiclip bit-packing conventions.

Mirror of the reference BitWriter (LibMobiclip/Codec/Mobiclip/BitWriter.cs:9-108):
an MSB-first 32-bit accumulator flushed 16 bits at a time as *little-endian*
u16 words — the exact inverse of the decoder's FillBits refill
(MobiclipDecoder.cs:2988-2996) — plus Elias-gamma (Exp-Golomb) varints.
"""
from __future__ import annotations

_M32 = 0xFFFFFFFF


class BitWriter:
    def __init__(self) -> None:
        self._out = bytearray()
        self._bits = 0
        self._count = 0

    def write_bits(self, value: int, nbits: int) -> None:
        """WriteBits (BitWriter.cs:16-22)."""
        if nbits <= 0:
            return
        assert self._count + nbits <= 32, "accumulator overflow"
        self._bits |= ((value & ((1 << nbits) - 1))
                       << (32 - nbits - self._count)) & _M32
        self._count += nbits
        if self._count >= 16:
            self._flush16()

    def write_varint_u(self, value: int) -> None:
        """WriteVarIntUnsigned (BitWriter.cs:25-32): n zeros, stop bit, n bits."""
        assert value >= 0
        n = ((value + 1) // 2).bit_length()
        self.write_bits(0, n)
        self.write_bits(1, 1)
        self.write_bits(value - ((1 << n) - 1), n)

    def write_varint_s(self, value: int) -> None:
        """WriteVarIntSigned (BitWriter.cs:34-44)."""
        v = (1 - value * 2) if value <= 0 else value * 2
        n = (v // 2).bit_length()
        self.write_bits(0, n)
        self.write_bits(1, 1)
        self.write_bits(v - (1 << n), n)

    def _flush16(self) -> None:
        """Flush (BitWriter.cs:58-65): emit top 16 bits as LE u16."""
        self._out.append((self._bits >> 16) & 0xFF)
        self._out.append((self._bits >> 24) & 0xFF)
        self._count -= 16
        self._bits = (self._bits << 16) & _M32

    @property
    def bit_position(self) -> int:
        return len(self._out) * 8 + self._count

    def to_bytes(self) -> bytes:
        """Flush all pending bits (zero-padded to a u16 boundary)."""
        while self._count > 0:
            self._flush16()
        self._bits = 0
        self._count = 0
        return bytes(self._out)


def varint_u_nbits(value: int) -> int:
    """GetNrBitsRequiredVarIntUnsigned (BitWriter.cs:83-92)."""
    n = ((value + 1) // 2).bit_length()
    return 2 * n + 1


def varint_s_nbits(value: int) -> int:
    """GetNrBitsRequiredVarIntSigned (BitWriter.cs:94-106)."""
    v = (1 - value * 2) if value <= 0 else value * 2
    n = (v // 2).bit_length()
    return 2 * n + 1
