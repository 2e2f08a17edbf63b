"""Sx audio decoder — NumPy/bytearray oracle.

Mirror of the reference (LibMobiclip/Codec/Sx/SxDecoder.cs:9-478, itself
reconstructed from DWARF dumps of the original ARM binary).  The decoder is a
codebook-driven LPC codec: 128 samples per frame, an external per-channel
0xC34-byte codebook (from the MODS header region), a double-buffered
excitation workspace selected by a flip flag, pulse-train residual unpack at
2 or 3 bits per sample with bitrate-dependent stride, 8-tap LPC coefficient
expansion from three codebook indices, and a lattice-ish synthesis filter.

The reference state is a byte-addressed 0x8B8 scratch (`Internal`) accessed
through little-endian u32 reads/writes; we keep exactly that representation —
the layout (offsets 0x00 coefficient save, 0x60 gain, 0x64 flip flag,
0x68-0x6B indices, 0x6C output cursor, 0x70 filter ring, 0xB8+ double
excitation buffers) is part of the decoder's observable behavior.

Why Sx stays host-side (unlike IMA's scan kernel and FastAudio's batched
device lattice): `_expand_coefs`'s recursive pairwise mixing multiplies
coefficients by each other, and the saved coefficient state compounds
across predicted frames, so the spec's intermediate magnitudes are
unbounded.  Measured (tools/probe_sx_precision.py -> SX_PRECISION.json):
format-legal codebooks — MODS carries them as unvalidated file bytes,
ModsDemuxer.cs:20-29 — reach 146-bit intermediates within 64 frames, and
even codebooks with |s16 rows| <= 256 cross 64 bits; only rows <= ~16 stay
int64-safe.  A fixed-width device lattice is therefore unsound for legal
input; channels are decoded in parallel on host instead (this oracle's
Python ints are arbitrary precision).
"""
from __future__ import annotations

import struct

import numpy as np

_M32 = 0xFFFFFFFF


def _s32(v: int) -> int:
    v &= _M32
    return v - (1 << 32) if v >= (1 << 31) else v


class SxDecoder:
    """Stateful per-channel decoder (SxDecoder.cs:35-60)."""

    #: packet-size-ish lookup (SxDecoder.cs:40 table_83E) — read, unused
    _TABLE_83E = (0x14, 0xE, 0xC, 0xA, 0, 0)
    #: bitrate-dependent (count, stride) pairs (SxDecoder.cs:434 table_836)
    _TABLE_836 = (0, 0, 5, 0xC, 4, 0x10, 3, 0x14)

    def __init__(self) -> None:
        self.data: bytes = b""
        self.offset = 0
        self.internal = bytearray(0x8B8)
        self.codebook: bytes = bytes(0xC34)

    # ---------------------------------------------------------- raw access
    def _ru32(self, buf, off) -> int:
        return struct.unpack_from("<I", buf, off)[0]

    def _wu32(self, off: int, val: int) -> None:
        struct.pack_into("<I", self.internal, off, val & _M32)

    def _iu32(self, off: int) -> int:
        return _s32(self._ru32(self.internal, off))

    def _rd16(self) -> int:
        v = self.data[self.offset] | (self.data[self.offset + 1] << 8)
        self.offset += 2
        return v

    # ------------------------------------------------------------- decode
    def decode(self) -> np.ndarray:
        """Decode (SxDecoder.cs:42-60): one frame -> 128 int16 samples."""
        val = self._rd16()
        if (val >> 9) == 0x7F:
            result = self._key_init(val)
        else:
            result = self._predicted(val)
        self._wu32(0x64, self._ru32(self.internal, 0x64) ^ 1)
        out = np.empty(128, dtype=np.int16)
        for i in range(128):
            r7 = self._iu32(result + i * 4)
            out[i] = max(-32768, min(32767, r7))
        return out

    # -- excitation workspace helpers --------------------------------------
    def _clear_excitation(self, off: int) -> None:
        """sub_0 (SxDecoder.cs:62-74): zero 128 u32s at off+0x200."""
        base = off + 0x200
        self.internal[base:base + 0x200] = bytes(0x200)

    def _window_copy(self, off: int, off2: int, r6: int) -> None:
        """sub_28 (SxDecoder.cs:76-178): build the excitation from the other
        buffer's tail, windowed: 1 + 6 ramp-up, 114 halved, 6 ramp-down, 1."""
        dst = off + 0x200
        src = off2 + (0x7F - r6) * 4
        v = self._iu32(src)
        src += 4
        self._wu32(dst, v >> 4)
        dst += 4
        r1 = 2
        for _ in range(6):
            v = self._iu32(src)
            src += 4
            self._wu32(dst, (v * r1) >> 4)
            dst += 4
            r1 += 1
        r1 -= 1  # last increment not applied (SxDecoder.cs:116 comment)
        for _ in range(0x72):
            v = self._iu32(src)
            src += 4
            self._wu32(dst, v >> 1)
            dst += 4
        for _ in range(6):
            v = self._iu32(src)
            src += 4
            self._wu32(dst, (v * r1) >> 4)
            r1 -= 1
            dst += 4
        v = self._iu32(src)
        self._wu32(dst, v >> 4)

    def _pulses2(self, off: int, r6: int, r7: int, r8: int, r9: int) -> None:
        """sub_170 (SxDecoder.cs:180-207): 2-bit pulse rows, stride r9."""
        base = off + 0x200 + r7 * 4
        r7_2 = -r6 - 2 * r6
        r6 *= 2
        for _ in range(r8):
            val = self._rd16()
            r11 = 0xE
            while True:
                cur = self._iu32(base)
                self._wu32(base, cur + r6 * ((val >> r11) & 3) + r7_2)
                base += r9
                r11 -= 2
                if r11 < 0:
                    break

    def _pulses3(self, off: int, r6: int, r7: int) -> None:
        """sub_1B8 (SxDecoder.cs:209-250): 3-bit pulse rows, stride 0xC,
        plus two trailing pulses assembled from the rows' spare bits."""
        base = off + 0x200 + r7 * 4
        bias = -r6 - (r6 << 1) * 2 - (r6 << 1)
        step = r6 << 1
        r9 = 0
        for _ in range(8):
            val = self._rd16()
            r11 = 0xD
            while True:
                cur = self._iu32(base)
                self._wu32(base, cur + step * ((val >> r11) & 7) + bias)
                base += 0xC
                r11 -= 3
                if r11 < 0:
                    break
            r9 = (r9 << 1) | (val & 1)
        for sh in (5, 2):
            cur = self._iu32(base)
            self._wu32(base, cur + step * ((r9 >> sh) & 7) + bias)
            base += 0xC

    # -- LPC coefficients ---------------------------------------------------
    def _add_cb8(self, src, cb_off: int, things: list[int]) -> None:
        """sub_3B4 (SxDecoder.cs:316-323): add 8 s16s from a codebook row."""
        for i in range(8):
            things[i] += struct.unpack_from("<h", src, cb_off + i * 2)[0]

    def _expand_coefs(self, src, off: int) -> list[int]:
        """sub_244 (SxDecoder.cs:252-314): 8 base values + three codebook
        rows, then the recursive pairwise mixing and -x/2 finish."""
        c = [self._ru32(src, off + i * 4) for i in range(8)]
        c = [_s32(v) for v in c]
        self._add_cb8(self.codebook, self.internal[0x68] * 16, c)
        self._add_cb8(self.codebook, self.internal[0x69] * 16 + 0x400, c)
        self._add_cb8(self.codebook, self.internal[0x6A] * 16 + 0x800, c)
        for i in range(8):
            self._wu32(i * 4, c[i])
        # pairwise mixing (exact statement order matters)
        c[0] += (c[0] * c[1]) >> 15
        tmp = c[0] * c[2]
        c[0] += (c[1] * c[2]) >> 15
        c[1] += tmp >> 15
        tmp = c[0] * c[3]
        c[0] += (c[2] * c[3]) >> 15
        c[2] += tmp >> 15
        c[1] += (c[1] * c[3]) >> 15
        tmp = c[0] * c[4]
        c[0] += (c[3] * c[4]) >> 15
        c[3] += tmp >> 15
        tmp = c[1] * c[4]
        c[1] += (c[2] * c[4]) >> 15
        c[2] += tmp >> 15
        tmp = c[0] * c[5]
        c[0] += (c[4] * c[5]) >> 15
        c[4] += tmp >> 15
        tmp = c[1] * c[5]
        c[1] += (c[3] * c[5]) >> 15
        c[3] += tmp >> 15
        c[2] += (c[2] * c[5]) >> 15
        tmp = c[0] * c[6]
        c[0] += (c[5] * c[6]) >> 15
        c[5] += tmp >> 15
        tmp = c[1] * c[6]
        c[1] += (c[4] * c[6]) >> 15
        c[4] += tmp >> 15
        tmp = c[2] * c[6]
        c[2] += (c[3] * c[6]) >> 15
        c[3] += tmp >> 15
        tmp = c[0] * c[7]
        c[0] += (c[6] * c[7]) >> 15
        c[6] += tmp >> 15
        tmp = c[1] * c[7]
        c[1] += (c[5] * c[7]) >> 15
        c[5] += tmp >> 15
        tmp = c[2] * c[7]
        c[2] += (c[4] * c[7]) >> 15
        c[4] += tmp >> 15
        c[3] += (c[3] * c[7]) >> 15
        return [-(v >> 1) for v in c]

    # -- synthesis ----------------------------------------------------------
    def _synth(self, src_off: int, count: int, things: list[int]) -> int:
        """sub_3F8 (SxDecoder.cs:325-354): 8-tap recursive synthesis over
        `count` samples from the excitation at src_off; appends to the output
        cursor Internal[0x6C]; returns the advanced src_off."""
        ring = 0x70
        r1 = self._iu32(0x6C)
        remaining = count
        while True:
            for i in range(8):
                r4 = self._iu32(src_off)
                src_off += 4
                r4 <<= 14
                idx = (7 + i) & 7
                for i2 in range(8):
                    r4 += self._iu32(ring + idx * 4) * things[i2]
                    idx -= 1
                    if idx < 0:
                        idx = 7
                r4 >>= 14
                self._wu32(ring + i * 4, r4)
                self._wu32(r1, r4)
                r1 += 4
            remaining -= 8
            if remaining == 0:
                break
        self._wu32(0x6C, r1)
        return src_off

    def _avg_into(self, r2: int, things: list[int]) -> None:
        """sub_6C0 (SxDecoder.cs:356-363)."""
        for i in range(8):
            things[i] = (things[i] + self._iu32(r2 + i * 4)) >> 1

    def _synth_frame(self, off: int, off2: int, things: list[int]) -> None:
        """sub_728 (SxDecoder.cs:365-399): 4 x 32-sample sub-frames with
        coefficient interpolation between the previous and current sets."""
        r2 = self._ru32(self.internal, 0x64)
        r0 = off + 0x200
        self._wu32(0x6C, off2)
        # double-buffered coefficient slots at 0x20/0x40 (SxDecoder.cs:372)
        if r2 == 1:
            io2 = 0x20
            io = io2 + 0x20
        else:
            io = 0x20
            io2 = io + 0x20
        for i in range(8):
            self._wu32(io + i * 4, things[i])
        self._avg_into(io2, things)
        things2 = list(things)
        self._avg_into(io2, things)
        r0 = self._synth(r0, 0x20, things)
        things[:] = list(things2)
        r0 = self._synth(r0, 0x20, things)
        self._avg_into(io, things)
        r0 = self._synth(r0, 0x20, things)
        for i in range(8):
            things[i] = self._iu32(io + i * 4)
        r0 = self._synth(r0, 0x20, things)

    def _reset(self) -> None:
        """sub_798 (SxDecoder.cs:401-412)."""
        self._wu32(0x60, self._ru32(self.codebook, 0xC30))
        self._wu32(0x64, 1)
        for i in range(8):
            self._wu32(0x70 + i * 4, 0)

    def _frame_header(self, off: int, val: int) -> None:
        """sub_844 (SxDecoder.cs:436-462)."""
        r6 = (val >> 6) & 7
        self.internal[0x68] = val & 0x3F
        val = self._rd16()
        r7 = (val >> 14) & 3
        r8 = _s32(struct.unpack_from("<h", self.codebook, 0xC00 + r6 * 2)[0])
        gain = self._iu32(0x60)
        r11 = (val >> 12) & 3
        gain = (r8 * gain) >> 13
        self._wu32(0x60, gain)
        self.internal[0x69] = (val >> 6) & 0x3F
        self.internal[0x6A] = val & 0x3F
        self.internal[0x6B] = r11
        if r11 == 0:
            self._pulses3(off, gain, r7)
        else:
            self._pulses2(off, gain, r7,
                          self._TABLE_836[r11 * 2],
                          self._TABLE_836[r11 * 2 + 1])

    def _key_init(self, val: int) -> int:
        """sub_8BC (SxDecoder.cs:464-476): key frame — full reset, coefs
        from the codebook's fixed row, single 128-sample synthesis."""
        self._reset()
        self._clear_excitation(0x4B8)
        self._frame_header(0x4B8, val)
        things = self._expand_coefs(self.codebook, 0xC10)
        for i in range(8):
            self._wu32(0x40 + i * 4, things[i])
        self._wu32(0x6C, 0xB8)
        self._synth(0x6B8, 0x80, things)
        return 0xB8

    def _predicted(self, val: int) -> int:
        """sub_8FC (SxDecoder.cs:455-476): predicted frame — copy the other
        buffer's excitation, optional windowed long-term prediction, pulse
        add, interpolated synthesis."""
        r2 = self._ru32(self.internal, 0x64)
        r3 = r2 * 0x400 + 0xB8
        r4 = (r2 ^ 1) * 0x400 + 0xB8
        src = r4 + 0x200
        self.internal[r3:r3 + 0x200] = self.internal[src:src + 0x200]
        if (val >> 9) == 0x7E:
            self._clear_excitation(r3)
        else:
            self._window_copy(r3, r4, val >> 9)
        self._frame_header(r3, val)
        things = self._expand_coefs(self.internal, 0)
        self._synth_frame(r3, r4, things)
        return r4
