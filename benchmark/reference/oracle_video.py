"""Sequential NumPy oracle for the Mobiclip video codec.

This module is the *executable specification* of the codec: a routine-for-routine
behavioral mirror of the reference decoder
(LibMobiclip's `Codec/Mobiclip/MobiclipDecoder.cs`, cited per
method below), written in plain Python/NumPy.  It is intentionally sequential
and unoptimized — its job is to be obviously correct so that every vectorized
TPU kernel in `mobiclipdecoder_tpu.ops` can be property-tested against it
bit-for-bit on the YUV planes.

Integer-exactness notes (the things that make this codec easy to get wrong):

* The bitstream register is a 32-bit MSB-aligned accumulator refilled 16 bits
  at a time from little-endian u16 words (MobiclipDecoder.cs:2988-2996).  The
  deficit counter may go transiently negative between refill checks; all
  behavior (including reads past end-of-data, which are silently tolerated)
  is mirrored exactly.
* C# shift counts on 32-bit operands are masked to 5 bits; the Exp-Golomb
  reader relies on this when the register is all zeros (CLZ == 32).
* Half-pel motion compensation averages with per-operand truncation
  `(a >> 1) + (b >> 1)` (MobiclipDecoder.cs:433,441,449) — NOT `(a+b)>>1`.
* Arithmetic (sign-propagating) right shifts on negatives appear throughout
  the IDCT and plane predictors; we use numpy int32 (same semantics).
* The dequant tables pack `raster_pos | (scale << (QP/6 + 6 or 8))` into one
  u32 whose low byte is re-extracted at decode time
  (MobiclipDecoder.cs:3884-3911, 3424-3429); for QP < 12 in the 8x8 case the
  fields alias — we keep the packed representation so the aliasing behaves
  identically.
"""
from __future__ import annotations

import enum

import numpy as np

from .tables import TABLES

_M32 = 0xFFFFFFFF


def _s32(v: int) -> int:
    """Reinterpret a uint32 value as int32 (C# (int) cast)."""
    v &= _M32
    return v - (1 << 32) if v >= (1 << 31) else v


def _avg2(a: int, b: int) -> int:
    return (a + b + 1) >> 1


def _avg3(a: int, mid: int, c: int) -> int:
    return (a + 2 * mid + c + 2) >> 2


class MobiclipVersion(enum.IntEnum):
    """Profile selector (MobiclipDecoder.cs:32-38)."""

    VX_DS = 0
    MODS_DS = 1
    MOFLEX_3DS = 2


# Splitting geometry of the recursive P-block partition tree: for each block
# size, mode 8 / mode 9 split into two sub-blocks of the given size at the
# given offsets.  (MobiclipDecoder.cs:469-1746, one Switch per size.)
# value: {8: ((w, h), off_fn2), 9: ...} — first sub-block is always at off.
_PB_SPLIT: dict[tuple[int, int], dict[int, tuple[tuple[int, int], int, int]]] = {
    # (w, h): {case: ((sw, sh), d_off2_mul_stride, d_off2_pixels)}
    (16, 16): {8: ((16, 8), 8, 0), 9: ((8, 16), 0, 8)},
    (8, 16): {8: ((8, 8), 8, 0), 9: ((4, 16), 0, 4)},
    (4, 16): {8: ((4, 8), 8, 0), 9: ((2, 16), 0, 2)},
    (2, 16): {8: ((2, 8), 8, 0)},
    (16, 8): {8: ((16, 4), 4, 0), 9: ((8, 8), 0, 8)},
    (16, 4): {8: ((16, 2), 2, 0), 9: ((8, 4), 0, 8)},
    (16, 2): {9: ((8, 2), 0, 8)},
    (8, 8): {8: ((8, 4), 4, 0), 9: ((4, 8), 0, 4)},
    (8, 4): {8: ((8, 2), 2, 0), 9: ((4, 4), 0, 4)},
    (8, 2): {9: ((4, 2), 0, 4)},
    (4, 8): {8: ((4, 4), 4, 0), 9: ((2, 8), 0, 2)},
    (4, 4): {8: ((4, 2), 2, 0), 9: ((2, 4), 0, 2)},
    (4, 2): {9: ((2, 2), 0, 2)},
    (2, 8): {8: ((2, 4), 4, 0)},
    (2, 4): {8: ((2, 2), 2, 0)},
    (2, 2): {},
}


class OracleDecoder:
    """Mirror of the reference `MobiclipDecoder` class (MobiclipDecoder.cs:13)."""

    def __init__(self, width: int, height: int, version: MobiclipVersion):
        self.width = int(width)
        self.height = int(height)
        self.version = MobiclipVersion(version)
        # stride policy (MobiclipDecoder.cs:50-52)
        if width <= 256:
            self.stride = 256
        elif width <= 512:
            self.stride = 512
        else:
            self.stride = 1024
        self.y_planes: list[np.ndarray | None] = [None] * 6
        self.uv_planes: list[np.ndarray | None] = [None] * 6
        self.quantizer = 0
        self.yuv_format = 0
        self.data: bytes = b""
        self.offset = 0  # byte offset into self.data, public like the ref
        # Internal[] mirror (MobiclipDecoder.cs:28): 392 u32 slots.
        #   [10..73]  packed 8x8 dequant entries     [74..89] packed 4x4 entries
        #   [90..153] coefficient block              [218] VLC table select
        #   [219..220] MV predictor                  [221..] per-column MV cache
        self.internal = np.zeros(392, dtype=np.uint32)
        # byte-aliased intra-mode cache = bytes 0..36 of Internal
        # (MobiclipDecoder.cs:1835-1862, 3913-3924); kept as a separate byte
        # array since Internal[0..9] is only ever touched through the alias.
        self.imode = np.zeros(40, dtype=np.uint8)
        # bit register
        self._r3 = 0
        self._nb = 0
        # tables
        self._t = TABLES

    # ------------------------------------------------------------------ bits
    def _fill(self) -> None:
        """FillBits (MobiclipDecoder.cs:2988): refill 16 bits from a LE u16.

        A silent no-op at end-of-data (the over-read tolerance that the
        containers' trailing-zero-byte conventions rely on); raises on an odd
        trailing byte exactly where the C# ReadU16LE would throw.
        """
        if self.offset >= len(self.data):
            return
        w = self.data[self.offset] | (self.data[self.offset + 1] << 8)
        self.offset += 2
        self._nb += 16
        self._r3 = (self._r3 | (w << ((16 - self._nb) & 31))) & _M32

    def _adv(self, n: int) -> None:
        """r3 <<= n; nb -= n; refill-check — the ubiquitous consume pattern."""
        self._r3 = (self._r3 << n) & _M32
        self._nb -= n
        if self._nb < 0:
            self._fill()

    def _bit(self) -> int:
        b = self._r3 >> 31
        self._adv(1)
        return b

    def _varint_u(self) -> int:
        """ReadVarIntUnsigned (MobiclipDecoder.cs:2970): Exp-Golomb."""
        r3 = self._r3
        n = 32 - r3.bit_length()  # CLZ (MobiclipDecoder.cs:3927)
        r3 = (r3 << (n & 31)) & _M32  # C# shifts are mod-32
        r3 = (r3 << 1) & _M32  # stop bit
        sh = 32 - n
        val = 0 if sh == 32 else r3 >> sh
        val += (1 << (n & 31)) - 1
        self._r3 = (r3 << (n & 31)) & _M32
        self._nb -= 2 * n + 1
        if self._nb < 0:
            self._fill()
        return val

    def _varint_s(self) -> int:
        """ReadVarIntSigned (MobiclipDecoder.cs:2998).

        The C# computes in a wrapping 32-bit int; for format-legal varints
        (~15 bits) that never matters, but a degenerate 31-zero prefix makes
        `r6 += 1 << r10` overflow — mirror the wrap exactly so malformed
        streams decode identically."""
        r3 = self._r3
        n = 32 - r3.bit_length()
        r3 = (r3 << (n & 31)) & _M32
        r3 = (r3 << 1) & _M32
        sh = 32 - n
        val = 0 if sh == 32 else r3 >> sh
        val = _s32((val + (1 << (n & 31))) & _M32)
        if val & 1:
            val = _s32((1 - val) & _M32)
        val >>= 1
        self._r3 = (r3 << (n & 31)) & _M32
        self._nb -= 2 * n + 1
        if self._nb < 0:
            self._fill()
        return val

    # ----------------------------------------------------------------- frame
    def decode_frame(self, rgb: bool = False):
        """DecodeFrame/DecodeVXS2 (MobiclipDecoder.cs:56,97).

        Consumes the packet at self.data[self.offset:], advances self.offset
        past the video payload (the MODS audio-start convention depends on
        this), and returns (Y, UV) plane views — or an RGB HxWx3 array when
        ``rgb`` is True.  Unlike the reference we let decode errors propagate
        instead of swallowing them (MobiclipDecoder.cs:325 `catch {}`).
        """
        if self.version == MobiclipVersion.VX_DS:
            return self._decode_vxs1()
        S, H, W = self.stride, self.height, self.width
        for i in range(5, 0, -1):
            self.y_planes[i] = self.y_planes[i - 1]
            self.uv_planes[i] = self.uv_planes[i - 1]
        self.y_planes[0] = np.zeros(S * H, dtype=np.uint8)
        self.uv_planes[0] = np.zeros(S * H // 2, dtype=np.uint8)

        self._r3 = ((self.data[self.offset] | (self.data[self.offset + 1] << 8))
                    << 16) & _M32
        self.offset += 2
        self._nb = 0

        iframe = self._r3 >> 31
        self._r3 = (self._r3 << 1) & _M32
        if not iframe:
            self._nb -= 1
            if self._nb < 0:
                self._fill()
            self._decode_pframe()
        else:
            self._decode_iframe()
        if rgb:
            return self.to_rgb()
        return self.y_planes[0], self.uv_planes[0]

    def _decode_vxs1(self):
        """DecodeVXS1 stub parity (MobiclipDecoder.cs:63-95): one varint per
        16x16 block; only value 1 ("skip": copy the co-located block from
        the previous frame) is implemented upstream — anything else throws
        NotImplementedException, and so do we.  Full .vx decode is an
        upstream TODO (README.md:13)."""
        S, H = self.stride, self.height
        for i in range(5, 0, -1):
            self.y_planes[i] = self.y_planes[i - 1]
            self.uv_planes[i] = self.uv_planes[i - 1]
        self.y_planes[0] = self.y_planes[1].copy() if self.y_planes[1] is not \
            None else np.zeros(S * H, dtype=np.uint8)
        self.uv_planes[0] = self.uv_planes[1].copy() if self.uv_planes[1] \
            is not None else np.zeros(S * H // 2, dtype=np.uint8)
        self._r3 = ((self.data[self.offset]
                     | (self.data[self.offset + 1] << 8)) << 16) & _M32
        self.offset += 2
        self._nb = 0
        for _my in range(0, self.height, 16):
            for _mx in range(0, self.width, 16):
                v = self._varint_u()
                if v != 1:
                    raise NotImplementedError(
                        "Vx block mode %d: only skip (1) is implemented, "
                        "matching the reference stub "
                        "(MobiclipDecoder.cs:75-94)" % v)
        return self.y_planes[0], self.uv_planes[0]

    def _decode_iframe(self) -> None:
        """I-frame branch of DecodeVXS2 (MobiclipDecoder.cs:222-258)."""
        self.yuv_format = self._r3 >> 31
        self._r3 = (self._r3 << 1) & _M32
        self.internal[218] = self._r3 >> 31  # coefficient table select
        self._r3 = (self._r3 << 1) & _M32
        self._nb -= 3
        if self._nb < 0:
            self._fill()
        quantizer = self._r3 >> 26
        self._adv(6)
        if self.quantizer != quantizer:
            self._setup_quant(quantizer)
        S = self.stride
        off = 0
        for _my in range(0, self.height, 16):
            for _mx in range(0, self.width, 16):
                sub = self._bit()
                if sub:
                    self._dec_intra_sub_mb(off)
                else:
                    self._dec_intra_full_mb(off)
                off += 16
            off += S * 16 - self.width

    def _decode_pframe(self) -> None:
        """P-frame branch of DecodeVXS2 (MobiclipDecoder.cs:115-221)."""
        if self.version == MobiclipVersion.MOFLEX_3DS:
            dq = self._varint_s()
            if self.quantizer == 0:
                self._setup_quant(0)
            elif dq != 0:
                self._setup_quant((self.quantizer + dq) & _M32)
        else:  # MODS_DS
            dq = self._varint_s()
            if dq != 0:
                self._setup_quant((self.quantizer + dq) & _M32)
        self.internal[218] = 0  # P-frames always use table 0 (:144)
        inr = self.internal
        io = 221
        w = self.width + 0x20
        while True:
            inr[io] = 0
            inr[io + 1] = 0
            io += 2
            w -= 16
            if w <= 0:
                break
        S = self.stride
        off = 0
        for _my in range(0, self.height, 16):
            io = 221
            for _mx in range(0, self.width, 16):
                v = [_s32(int(inr[io + k])) for k in range(6)]
                io += 2
                # component-wise median of (left, above, above-right) MVs
                if v[0] > v[2]:
                    v[0], v[2] = v[2], v[0]
                if v[2] > v[4]:
                    v[2], v[4] = v[4], v[2]
                if v[0] > v[2]:
                    v[0], v[2] = v[2], v[0]
                if v[1] > v[3]:
                    v[1], v[3] = v[3], v[1]
                if v[3] > v[5]:
                    v[3], v[5] = v[5], v[3]
                if v[1] > v[3]:
                    v[1], v[3] = v[3], v[1]
                inr[219] = v[2] & _M32
                inr[220] = v[3] & _M32
                inr[io] = 0
                inr[io + 1] = 0
                self._read_pblock(16, 16, io, off)
                off += 16
            off += S * 16 - self.width

    # --------------------------------------------------------------- pblocks
    def _read_pblock(self, w: int, h: int, io: int, off: int) -> None:
        """ReadPBlockWxH dispatch (MobiclipDecoder.cs:458-1746)."""
        prof = "moflex" if self.version == MobiclipVersion.MOFLEX_3DS else "mods"
        mode_lut = self._t[f"pb{w}x{h}_mode_{prof}"]
        bits_lut = self._t[f"pb{w}x{h}_bits_{prof}"]
        peek = int(self._t[f"pb{w}x{h}_peek_{prof}"])
        mode = int(mode_lut[self._r3 >> (32 - peek)])
        self._adv(int(bits_lut[mode]))
        self._switch_pblock(w, h, mode, io, off)

    def _switch_pblock(self, w: int, h: int, mode: int, io: int, off: int) -> None:
        if mode == 0:
            self._mc(w, h, io, 1, _s32(int(self.internal[219])),
                     _s32(int(self.internal[220])), off)
        elif 1 <= mode <= 5:
            dx = self._varint_s() + _s32(int(self.internal[219]))
            dy = self._varint_s() + _s32(int(self.internal[220]))
            self._mc(w, h, io, mode, dx, dy, off)
        elif mode == 6 and (w, h) == (16, 16):
            self._dec_intra_full_mb(off)
        elif mode == 7 and (w, h) == (16, 16):
            self._dec_intra_sub_mb(off)
        elif mode in (8, 9):
            try:
                (sw, sh), dmul, dpix = _PB_SPLIT[(w, h)][mode]
            except KeyError:
                raise ValueError(
                    f"illegal partition mode {mode} for {w}x{h}") from None
            self._read_pblock(sw, sh, io, off)
            self._read_pblock(sw, sh, io, off + dmul * self.stride + dpix)
        else:
            raise ValueError(f"illegal partition mode {mode} for {w}x{h}")
        if (w, h) == (16, 16) and mode not in (6, 7):
            self._residual_mb(off)

    def _mc(self, w: int, h: int, io: int, ref: int, dx: int, dy: int,
            off: int) -> None:
        """Store MV + copy Y/U/V blocks (loc_1147B0 family, :409-416 etc.).

        ``ref`` is the 1-based past-frame index (reference passes srcFrame/4).
        """
        self.internal[io] = dx & _M32
        self.internal[io + 1] = dy & _M32
        self._exec_mc(w, h, ref, dx, dy, off)

    def _copy_block(self, src: np.ndarray, dx: int, dy: int, w: int, h: int,
                    dst: np.ndarray, off: int) -> None:
        """CopyBlock half-pel fetch (MobiclipDecoder.cs:418-456).

        Half-pel filtering is `(a>>1)+(b>>1)` per the reference (lossy
        truncation before the add — NOT a rounded average).
        """
        S = self.stride
        case = (dx & 1) | ((dy & 1) << 1)
        si = src.astype(np.int32)  # cheap at these plane sizes; keeps it simple
        for i in range(h):
            pos = off + ((dy >> 1) + i) * S + (dx >> 1)
            if pos < 0:
                raise IndexError("MC read before plane start")
            if case == 0:
                row = si[pos:pos + w]
            elif case == 1:
                row = (si[pos:pos + w] >> 1) + (si[pos + 1:pos + 1 + w] >> 1)
            elif case == 2:
                row = (si[pos:pos + w] >> 1) + (si[pos + S:pos + S + w] >> 1)
            else:
                row = ((((si[pos:pos + w] >> 1)
                         + (si[pos + 1:pos + 1 + w] >> 1)) >> 1)
                       + (((si[pos + S:pos + S + w] >> 1)
                           + (si[pos + S + 1:pos + S + 1 + w] >> 1)) >> 1))
            dst[off + i * S:off + i * S + w] = row.astype(np.uint8)

    # ------------------------------------------------------------ intra MBs
    def _dec_intra_full_mb(self, off: int) -> None:
        """DecIntraFullBlockPMode (MobiclipDecoder.cs:1759-1786)."""
        cbp = int(self._t.cbp_intra[self._varint_u()])
        mode = self._r3 >> 29
        self._adv(3)
        if mode == 2:
            mode = 9
            self._exec_plane16(off, self._varint_s())
        S = self.stride
        for bit, doff in ((0, 0), (1, 8), (2, S * 8), (3, S * 8 + 8)):
            if (cbp >> bit) & 1:
                self._intra8_with_residual(self.y_planes[0], off + doff, mode)
            else:
                self._exec_intra(self.y_planes[0], off + doff, 8, mode,
                                 None, None)
        self._intra_chroma(cbp, off)

    def _dec_intra_sub_mb(self, off: int) -> None:
        """DecIntraSubBlockPMode (MobiclipDecoder.cs:1789-1807)."""
        cbp = int(self._t.cbp_intra[self._varint_u()])
        S = self.stride
        for bit, doff, r5 in ((0, 0, 9), (1, 8, 0xB),
                              (2, S * 8, 0x19), (3, S * 8 + 8, 0x1B)):
            if (cbp >> bit) & 1:
                self._intra_sub8(r5, self.y_planes[0], off + doff)
            else:
                self._intra8_predicted_mode(r5, self.y_planes[0], off + doff)
        self._intra_chroma(cbp, off)

    def _intra_chroma(self, cbp: int, off: int) -> None:
        """loc_116290 (MobiclipDecoder.cs:1864-1880)."""
        mode = self._r3 >> 29
        self._adv(3)
        S = self.stride
        uv = self.uv_planes[0]
        if mode == 2:
            mode = 9
            self._exec_intra(uv, off // 2, 8, 2, self._varint_s(), None)
            self._exec_intra(uv, off // 2 + S // 2, 8, 2,
                             self._varint_s(), None)
        for bit, coff in ((4, off // 2), (5, off // 2 + S // 2)):
            if (cbp >> bit) & 1:
                self._intra8_with_residual(uv, coff, mode)
            else:
                self._exec_intra(uv, coff, 8, mode, None, None)

    def _predicted_mode(self, r5: int, peek4: int) -> tuple[int, int]:
        """Shared most-probable-mode scheme (loc_116220 / sub_1163DC).

        Returns (mode, consumed_bits): predicted = min(above, left), 9 -> 3;
        a 4-bit peek selects an explicit mode (skipping the predicted one) or,
        if >= 9, a single flag bit confirms the predicted mode.
        """
        pred = int(self.imode[r5 - 8])
        left = int(self.imode[r5 - 1])
        if pred > left:
            pred = left
        if pred == 9:
            pred = 3
        v = peek4
        if v >= pred:
            v += 1
        if v < 9:
            return v, 4
        return pred, 1

    def _gradient_for(self, mode: int) -> int | None:
        """Plane modes (2 / 12) carry a signed gradient varint, parsed at the
        point the reference's sub_116CCC/sub_117E98 would read it."""
        if mode in (2, 12):
            return self._varint_s()
        return None

    def _intra8_predicted_mode(self, r5: int, plane: np.ndarray,
                               off: int) -> None:
        """loc_116220 (MobiclipDecoder.cs:1835-1862): 8x8, no residual."""
        mode, nbits = self._predicted_mode(r5, self._r3 >> 28)
        self.imode[[r5, r5 + 1, r5 + 8, r5 + 9]] = mode
        self._adv(nbits)
        self._exec_intra(plane, off, 8, mode, self._gradient_for(mode), None)

    def _intra_sub8(self, r5: int, plane: np.ndarray, off: int) -> None:
        """loc_116368 (MobiclipDecoder.cs:2776-2834)."""
        if self._r3 >> 31:
            self._r3 = (self._r3 << 1) & _M32
            self._nb -= 1  # note: no refill check here, per reference
            mode, nbits = self._predicted_mode(r5, self._r3 >> 28)
            self._adv(nbits)
            self.imode[[r5, r5 + 1, r5 + 8, r5 + 9]] = mode
            g = self._gradient_for(mode)
            self._exec_intra(plane, off, 8, mode, g, self._parse_dct(8))
        else:
            cbp = int(self._t.cbp_split8[self._varint_u()])
            S = self.stride
            for bit, doff, dr5 in ((0, 0, 0), (1, 4, 1),
                                   (2, S * 4, 8), (3, S * 4 + 4, 9)):
                mode, nbits = self._predicted_mode(r5 + dr5, self._r3 >> 28)
                self.imode[r5 + dr5] = mode
                self._adv(nbits)
                mode += 0xA
                g = self._gradient_for(mode)
                coefs = self._parse_dct(4) if (cbp >> bit) & 1 else None
                self._exec_intra(plane, off + doff, 4, mode, g, coefs)

    def _intra8_with_residual(self, plane: np.ndarray, off: int,
                              mode: int) -> None:
        """sub_116508 (MobiclipDecoder.cs:2869-2896)."""
        if self._r3 >> 31:
            self._r3 = (self._r3 << 1) & _M32
            self._nb -= 1
            g = self._gradient_for(mode)
            self._exec_intra(plane, off, 8, mode, g, self._parse_dct(8))
        else:
            mode4 = mode + 0xA
            cbp = int(self._t.cbp_split8[self._varint_u()])
            S = self.stride
            for bit, doff in ((0, 0), (1, 4), (2, S * 4), (3, S * 4 + 4)):
                g = self._gradient_for(mode4)
                coefs = self._parse_dct(4) if (cbp >> bit) & 1 else None
                self._exec_intra(plane, off + doff, 4, mode4, g, coefs)

    # --------------------------------------------------------- P residuals
    def _residual_mb(self, off: int) -> None:
        """loc_1161A0 (MobiclipDecoder.cs:1818-1833)."""
        cbp = int(self._t.cbp_inter[self._varint_u()])
        S = self.stride
        for bit, doff in ((0, 0), (1, 8), (2, S * 8), (3, S * 8 + 8)):
            if (cbp >> bit) & 1:
                self._residual8(self.y_planes[0], off + doff)
        if (cbp >> 4) & 1:
            self._residual8(self.uv_planes[0], off // 2)
        if (cbp >> 5) & 1:
            self._residual8(self.uv_planes[0], off // 2 + S // 2)

    def _residual8(self, plane: np.ndarray, off: int) -> None:
        """loc_11652C (MobiclipDecoder.cs:2909-2929)."""
        if self._r3 >> 31:
            self._r3 = (self._r3 << 1) & _M32
            self._nb -= 1
            self._exec_resid(plane, off, 8, self._parse_dct(8))
        else:
            cbp = int(self._t.cbp_sub4[self._varint_u()])
            S = self.stride
            for bit, doff in ((0, 0), (1, 4), (2, S * 4), (3, S * 4 + 4)):
                if (cbp >> bit) & 1:
                    self._exec_resid(plane, off + doff, 4, self._parse_dct(4))

    # ------------------------------------------------------------ residuals
    def _parse_dct(self, n: int) -> tuple[np.ndarray, int]:
        """Parse one coefficient block (loc_116540/sub_1166E8 entry): returns
        (dense dequantized coefficients as (n,n) int32, last scan cursor).
        The cursor selects the sparse IDCT variant (MobiclipDecoder.cs:
        2939-2942, 2954-2955)."""
        base = 10 if n == 8 else 74
        self.internal[90:90 + n * n] = 0
        last = self._read_dct_matrix(base)
        coefs = self.internal[90:90 + n * n].astype(np.int64) \
            .astype(np.int32).reshape(n, n)
        return coefs, last

    # ------------------------------------------- execution hooks (oracle)
    # Subclasses (the TPU frame planner) override _exec_* to record ops
    # instead of reconstructing; the parse path above is shared verbatim.
    def _exec_mc(self, w: int, h: int, ref: int, dx: int, dy: int,
                 off: int) -> None:
        S = self.stride
        self._copy_block(self.y_planes[ref], dx, dy, w, h,
                         self.y_planes[0], off)
        self._copy_block(self.uv_planes[ref], dx >> 1, dy >> 1, w >> 1, h >> 1,
                         self.uv_planes[0], off // 2)
        self._copy_block(self.uv_planes[ref], dx >> 1, dy >> 1, w >> 1, h >> 1,
                         self.uv_planes[0], off // 2 + S // 2)

    def _exec_intra(self, plane: np.ndarray, off: int, size: int, mode: int,
                    gradient: int | None,
                    coefs: tuple[np.ndarray, int] | None) -> None:
        self._predict_intra(mode, plane, off, gradient)
        if coefs is not None:
            self._apply_idct(plane, off, size, coefs)

    def _exec_resid(self, plane: np.ndarray, off: int, size: int,
                    coefs: tuple[np.ndarray, int]) -> None:
        self._apply_idct(plane, off, size, coefs)

    def _exec_plane16(self, off: int, gradient: int) -> None:
        self._plane16(self.y_planes[0], off, gradient)

    def _apply_idct(self, plane: np.ndarray, off: int, n: int,
                    coefs: tuple[np.ndarray, int]) -> None:
        """Apply the IDCT variant selected by the last scan cursor
        (loc_116540 / loc_116628)."""
        dense, last = coefs
        if n == 8:
            if last <= 11:
                self._idct1(plane, off, 8, dense)
            elif last <= 13:
                self._idct3x8(plane, off, dense)
            elif last <= 20:
                self._idct_sparse8(plane, off, dense)
            else:
                self._idct_full8(plane, off, dense)
        else:
            if last <= 75:
                self._idct1(plane, off, 4, dense)
            else:
                self._idct_full4(plane, off, dense)

    def _read_dct_matrix(self, r12: int) -> int:
        """ReadDCTMatrix (MobiclipDecoder.cs:3330-3432): run-level VLC with
        fused dequant.  Returns the final scan cursor (selects IDCT variant).
        """
        tbl = int(self.internal[218])
        ta = self._t.coef_vlc1_a if tbl == 1 else self._t.coef_vlc0_a
        tb = self._t.coef_vlc1_b if tbl == 1 else self._t.coef_vlc0_b
        inr = self.internal
        while True:
            end = 0
            if self._r3 >> 25 == 3:  # escape prefix 0000011
                self._r3 = (self._r3 << 7) & _M32
                c1 = self._r3 >> 31
                self._r3 = (self._r3 << 1) & _M32
                if not c1:
                    # escape 1: level offset from table B
                    self._nb -= 8
                    if self._nb < 0:
                        self._fill()
                    e = int(ta[self._r3 >> 20])
                    nbits = e & 0xF
                    value = ((e >> 4) & 0x1F) + int(tb[e >> 9])
                    end = (e >> 15) & 1
                    skip = (e >> 10) & 0x3F
                    self._r3 = (self._r3 << (nbits - 1)) & _M32
                    if self._r3 >> 31:
                        value = -value
                    self._r3 = (self._r3 << 1) & _M32
                    self._nb -= nbits
                    if self._nb < 0:
                        self._fill()
                else:
                    c2 = self._r3 >> 31
                    self._r3 = (self._r3 << 1) & _M32
                    if not c2:
                        # escape 2: run offset from table B[0x80..]
                        self._nb -= 9
                        if self._nb < 0:
                            self._fill()
                        e = int(ta[self._r3 >> 20])
                        nbits = e & 0xF
                        value = (e >> 4) & 0x1F
                        run = (e >> 10) & 0x3F
                        end = (e >> 15) & 1
                        skip = run + int(tb[0x80 + value + (end << 6)])
                        self._r3 = (self._r3 << (nbits - 1)) & _M32
                        if self._r3 >> 31:
                            value = -value
                        self._r3 = (self._r3 << 1) & _M32
                        self._nb -= nbits
                        if self._nb < 0:
                            self._fill()
                    else:
                        # escape 3: fully explicit {end, run6, level12}
                        self._nb -= 9
                        if self._nb < 0:
                            self._fill()
                        end = self._r3 >> 31
                        self._r3 = (self._r3 << 1) & _M32
                        skip = self._r3 >> 26
                        self._r3 = (self._r3 << 6) & _M32
                        self._nb -= 7
                        if self._nb < 0:
                            self._fill()
                        value = _s32(self._r3) >> 20  # sign-extending
                        self._r3 = (self._r3 << 12) & _M32
                        self._nb -= 12
                        if self._nb < 0:
                            self._fill()
            else:
                e = int(ta[self._r3 >> 20])
                nbits = e & 0xF
                value = (e >> 4) & 0x1F
                end = (e >> 15) & 1
                skip = (e >> 10) & 0x3F
                self._r3 = (self._r3 << (nbits - 1)) & _M32
                if self._r3 >> 31:
                    value = -value
                self._r3 = (self._r3 << 1) & _M32
                self._nb -= nbits
                if self._nb < 0:
                    self._fill()
            r12 += skip
            packed = int(inr[r12])
            r12 += 1
            pos = packed & 0xFF
            inr[90 + pos] = (_s32(packed >> 8) * value) & _M32
            if end:
                return r12

    # ---------------------------------------------------------------- IDCTs
    @staticmethod
    def _btf8(c: np.ndarray) -> np.ndarray:
        """8-point H.264-style shift-add butterfly applied to each row of an
        (N,8) int32 array (row/column pass of IDCT64Px8, :3450-3505)."""
        r0, r1, r2, r3, r4, r5, r6, r7 = (c[:, k] for k in range(8))
        a0 = r0 + r4
        a1 = r0 - r4
        b0 = r2 + (r6 >> 1)
        b1 = (r2 >> 1) - r6
        e2 = a1 + b1
        e4 = a1 - b1
        e6 = a0 - b0
        e0 = a0 + b0
        o0 = r1 + r7 - r3 - (r3 >> 1)
        o1 = r7 - r1 + r5 + (r5 >> 1)
        o2 = r5 - r7 - (r7 >> 1) - r3
        o3 = r3 + r5 + r1 + (r1 >> 1)
        f1 = o2 + (o3 >> 2)
        f7 = o3 - (o2 >> 2)
        f3 = o0 + (o1 >> 2)
        f5 = (o0 >> 2) - o1
        out = np.empty_like(c)
        out[:, 0] = e0 + f7
        out[:, 7] = e0 - f7
        out[:, 1] = e2 + f5
        out[:, 6] = e2 - f5
        out[:, 2] = e4 + f3
        out[:, 5] = e4 - f3
        out[:, 3] = e6 + f1
        out[:, 4] = e6 - f1
        return out

    @staticmethod
    def _btf48(c: np.ndarray) -> np.ndarray:
        """4-coefficient -> 8-sample half butterfly (IDCT16Px8, :3574-3616)."""
        r0, r1, r2, r3 = (c[:, k] for k in range(4))
        e2 = r0 - (r2 >> 1)
        e3 = r0 - r2
        e1 = r0 + (r2 >> 1)
        e0 = r0 + r2
        o0 = r1 - r3 - (r3 >> 1)
        o3 = r3 + r1 + (r1 >> 1)
        f1 = r1 + (o0 >> 2)
        f3 = o0 + ((-r1) >> 2)
        f5 = (-r3) + (o3 >> 2)
        f7 = o3 - ((-r3) >> 2)
        out = np.empty((c.shape[0], 8), dtype=c.dtype)
        out[:, 0] = e0 + f7
        out[:, 7] = e0 - f7
        out[:, 1] = e1 + f1
        out[:, 6] = e1 - f1
        out[:, 2] = e2 + f3
        out[:, 5] = e2 - f3
        out[:, 3] = e3 + f5
        out[:, 4] = e3 - f5
        return out

    @staticmethod
    def _btf4(c: np.ndarray) -> np.ndarray:
        """4-point butterfly (IDCT16Px4, :3738-3775)."""
        r0, r1, r2, r3 = (c[:, k] for k in range(4))
        e0 = r0 + r2
        e1 = r0 - r2
        o1 = (r1 >> 1) - r3
        o0 = r1 + (r3 >> 1)
        out = np.empty_like(c)
        out[:, 0] = e0 + o0
        out[:, 3] = e0 - o0
        out[:, 1] = e1 + o1
        out[:, 2] = e1 - o1
        return out

    def _add_clamp(self, plane: np.ndarray, off: int, res: np.ndarray) -> None:
        """Add residual and saturate: MinMaxTable[0x40 + pix + res] semantics
        (MobiclipDecoder.cs:3551-3558; table is clip(v,0,255), MobiConst:587).
        """
        S = self.stride
        h, w = res.shape
        for i in range(h):
            sl = plane[off + i * S:off + i * S + w]
            sl[:] = np.clip(sl.astype(np.int32) + res[i], 0, 255).astype(np.uint8)

    def _idct_full8(self, plane: np.ndarray, off: int,
                    dense: np.ndarray) -> None:
        """IDCT64Px8 (MobiclipDecoder.cs:3435-3561): pass1 over coefficient
        rows into a transposed temp, pass2 emits spatial rows."""
        c = dense.copy()
        c[0, 0] += 32
        d = self._btf8(self._btf8(c).T)
        self._add_clamp(plane, off, d >> 6)

    def _idct_sparse8(self, plane: np.ndarray, off: int,
                      dense: np.ndarray) -> None:
        """IDCT16Px8 (:3564-3658): coefficients confined to the 4x4 corner."""
        c = dense[:4, :4].copy()
        c[0, 0] += 32
        d = self._btf48(self._btf48(c).T.copy())
        self._add_clamp(plane, off, d >> 6)

    def _idct3x8(self, plane: np.ndarray, off: int,
                 dense: np.ndarray) -> None:
        """IDCT3Px8 (:3661-3707): DC + first two AC terms only."""
        c0, c1, c8 = int(dense[0, 0]) + 32, int(dense[0, 1]), int(dense[1, 0])

        def weights(v: int) -> list[int]:
            w3 = v + (v >> 1)
            w2 = v + (v >> 2)
            w1 = v + ((-v) >> 2)
            w0 = w3 >> 2
            return [w3, w2, w1, w0, -w0, -w1, -w2, -w3]

        rw = np.array(weights(c1), dtype=np.int32) + np.int32(c0)
        cw = np.array(weights(c8), dtype=np.int32)
        d = rw[:, None] + cw[None, :]
        self._add_clamp(plane, off, d >> 6)

    def _idct1(self, plane: np.ndarray, off: int, n: int,
               dense: np.ndarray) -> None:
        """IDCT1Px8 / IDCT1Px4 (:3710-3725, :3787-3798): DC only."""
        dc = (int(dense[0, 0]) + 32) >> 6
        res = np.full((n, n), dc, dtype=np.int32)
        self._add_clamp(plane, off, res)

    def _idct_full4(self, plane: np.ndarray, off: int,
                    dense: np.ndarray) -> None:
        """IDCT16Px4 (:3728-3784)."""
        c = dense.copy()
        c[0, 0] += 32
        d = self._btf4(self._btf4(c).T.copy())
        self._add_clamp(plane, off, d >> 6)

    # ----------------------------------------------------- intra prediction
    def _predict_intra(self, mode: int, plane: np.ndarray, off: int,
                       gradient: int | None = None) -> None:
        """PredictIntra (MobiclipDecoder.cs:1883-2773).

        Modes 0-9 are 8x8 (vertical, horizontal, plane, DC, HU, HD, VR, DDR,
        VL, none); modes 10-19 are the 4x4 variants.  The directional modes in
        the reference are ARM register transliterations; here they are the
        equivalent closed-form H.264-style pixel formulas, derived and checked
        write-by-write against the cited code.
        """
        S = self.stride
        is_v_half = (plane is self.uv_planes[0]) and (off % S) >= S // 2
        mode = int(mode)
        if mode == 9 or mode == 19:
            return
        if mode == 2:
            self._plane8(plane, off, gradient)
            return
        if mode == 12:
            self._plane4(plane, off, gradient)
            return
        n = 8 if mode < 10 else 4
        m = mode if mode < 10 else mode - 10
        if m == 3:  # DC with edge availability (:1920-2022, :2501-2580)
            left_avail = ((off - (S // 2 if is_v_half else 0)) % S) != 0
            top_avail = off >= S
            if not left_avail and not top_avail:
                val = 0x80
            elif top_avail and not left_avail:
                s = int(plane[off - S:off - S + n].astype(np.int32).sum())
                val = (s + n // 2) // n
            elif left_avail and not top_avail:
                s = sum(int(plane[off + i * S - 1]) for i in range(n))
                val = (s + n // 2) // n
            else:
                s = int(plane[off - S:off - S + n].astype(np.int32).sum())
                s += sum(int(plane[off + i * S - 1]) for i in range(n))
                val = (s + n) // (2 * n)
            for i in range(n):
                plane[off + i * S:off + i * S + n] = val
            return
        if m == 0:  # vertical
            top = plane[off - S:off - S + n].copy()
            for i in range(n):
                plane[off + i * S:off + i * S + n] = top
            return
        if m == 1:  # horizontal
            for i in range(n):
                plane[off + i * S:off + i * S + n] = plane[off + i * S - 1]
            return
        # directional modes — gather neighbors then fill
        out = np.empty((n, n), dtype=np.int32)
        if m == 4:  # horizontal-up: left column only (:2023-2090, :2581)
            l = [int(plane[off + i * S - 1]) for i in range(n)]
            for y in range(n):
                for x in range(n):
                    z = x + 2 * y
                    if z >= 2 * n - 2:
                        out[y, x] = l[n - 1]
                    else:
                        k = z >> 1
                        if z & 1:
                            out[y, x] = _avg3(l[k], l[k + 1], l[min(k + 2, n - 1)])
                        else:
                            out[y, x] = _avg2(l[k], l[k + 1])
        elif m == 5:  # horizontal-down (:2091-2196, :2620-2655)
            c = int(plane[off - S - 1])
            t = [int(v) for v in plane[off - S:off - S + n]]
            l = [int(plane[off + i * S - 1]) for i in range(n)]
            e = [c] + l  # e[k] = l[k-1], e[0] = corner

            def u(k: int) -> int:
                if k >= 0:
                    return t[k]
                return c if k == -1 else l[0]
            for y in range(n):
                for x in range(n):
                    d = 2 * y - x
                    if d >= 0:
                        if d & 1:
                            k = (d - 1) >> 1
                            out[y, x] = _avg3(e[k], e[k + 1], e[k + 2]) \
                                if d >= 3 else _avg3(t[0], c, l[0])
                        else:
                            k = d >> 1
                            out[y, x] = _avg2(e[k], e[k + 1])
                    else:
                        q = x - 2 * y
                        out[y, x] = _avg3(u(q - 3), u(q - 2), u(q - 1))
        elif m == 6:  # vertical-right (:2197-2290, :2656-2701)
            c = int(plane[off - S - 1])
            t = [int(v) for v in plane[off - S:off - S + n]]
            l = [int(plane[off + i * S - 1]) for i in range(n)]

            def v(k: int) -> int:
                return t[k] if k >= 0 else c
            for y in range(n):
                for x in range(n):
                    d = 2 * x - y
                    if d >= 0:
                        k = x - (y >> 1)
                        if d & 1:
                            out[y, x] = _avg3(v(k - 2), v(k - 1), v(k))
                        else:
                            out[y, x] = _avg2(v(k - 1), v(k))
                    elif d == -1:
                        out[y, x] = _avg3(l[0], c, t[0])
                    else:
                        mm = -d - 2
                        lo = c if mm == 0 else l[mm - 1]
                        out[y, x] = _avg3(lo, l[mm], l[mm + 1])
        elif m == 7:  # diagonal down-right (:2291-2367, :2702-2733)
            c = int(plane[off - S - 1])
            t = [int(v) for v in plane[off - S:off - S + n]]
            l = [int(plane[off + i * S - 1]) for i in range(n)]

            def tt(k: int) -> int:
                return t[k] if k >= 0 else c

            def ll(k: int) -> int:
                return l[k] if k >= 0 else c
            for y in range(n):
                for x in range(n):
                    d = x - y
                    if d > 0:
                        out[y, x] = _avg3(tt(d - 2), tt(d - 1), tt(d))
                    elif d == 0:
                        out[y, x] = _avg3(l[0], c, t[0])
                    else:
                        out[y, x] = _avg3(ll(-d - 2), ll(-d - 1), ll(-d))
        elif m == 8:  # vertical-left, reads past the block's top-right
            # (:2368-2471 reads 13 top pixels for 8x8; :2734-2768 reads 7)
            ext = 2 * n - 3 + 2
            tarr = plane[off - S:off - S + ext].astype(np.int32)
            T = [int(v) for v in tarr]
            for y in range(n):
                for x in range(n):
                    if y & 1:
                        k = x + ((y - 1) >> 1)
                        out[y, x] = _avg3(T[k], T[k + 1], T[k + 2])
                    else:
                        k = x + (y >> 1)
                        out[y, x] = _avg2(T[k], T[k + 1])
        else:
            raise ValueError(f"bad intra mode {mode}")
        for y in range(n):
            plane[off + y * S:off + y * S + n] = out[y].astype(np.uint8)

    # ------------------------------------------------------ plane predictors
    def _plane16(self, plane: np.ndarray, off: int, g: int) -> None:
        """sub_1167BC: 16x16 plane/gradient predictor (:3017-3166)."""
        S = self.stride
        t = [int(v) for v in plane[off - S:off - S + 16]]
        bl = int(plane[off + S * 15 - 1])
        tr = t[15]
        r5 = ((bl + tr + 1) >> 1) + g * 2
        r6 = r5 - bl + 1
        r4 = bl << 3
        A = [0] * 16
        B = [0] * 16
        for i in range(16):
            r4 += r6 >> 1
            A[i] = t[i] * 64
            B[i] = (r4 - t[i] * 8) + 1
        r9 = r5 - tr + 1
        r10 = tr << 3
        for row in range(16):
            r10 += r9 >> 1
            lv = int(plane[off + row * S - 1])
            r7 = (r10 - (lv << 3)) + 1
            r8 = lv << 6
            vals = []
            for i in range(16):
                A[i] += B[i] >> 1
                r8 += r7 >> 1
                vals.append((A[i] + r8 + 64) >> 7)
            self._store_pred_row(plane, off + row * S, vals)

    def _plane8(self, plane: np.ndarray, off: int, g: int) -> None:
        """sub_116CCC: 8x8 plane predictor (:3168-3251)."""
        S = self.stride
        t = [int(v) for v in plane[off - S:off - S + 8]]
        bl = int(plane[off + S * 7 - 1])
        tr = t[7]
        r5 = ((bl + tr + 1) >> 1) + g * 2
        r6 = r5 - bl
        r4 = bl * 8
        A = [0] * 8
        B = [0] * 8
        for i in range(8):
            r4 += r6
            A[i] = t[i] * 64
            B[i] = r4 - t[i] * 8
        r9 = r5 - tr
        r10 = tr << 3
        for row in range(8):
            r10 += r9
            lv = int(plane[off + row * S - 1])
            r7 = r10 - lv * 8
            r8 = lv * 64
            vals = []
            for i in range(8):
                A[i] += B[i]
                r8 += r7
                vals.append((A[i] + r8 + 64) >> 7)
            self._store_pred_row(plane, off + row * S, vals)

    def _plane4(self, plane: np.ndarray, off: int, g: int) -> None:
        """sub_117E98: 4x4 plane predictor (:3253-3327)."""
        S = self.stride
        t = [int(v) for v in plane[off - S:off - S + 4]]
        bl = int(plane[off + S * 3 - 1])
        tr = t[3]
        r5 = ((bl + tr + 1) >> 1) + g * 2
        r6 = r5 - bl
        r4 = bl << 2
        A = [0] * 4
        B = [0] * 4
        for i in range(4):
            r4 += r6
            A[i] = t[i] << 4
            B[i] = r4 - (t[i] << 2)
        r9 = r5 - tr
        r10 = tr << 2
        for row in range(4):
            r10 += r9
            lv = int(plane[off + row * S - 1])
            r7 = r10 - (lv << 2)
            r8 = lv << 4
            vals = []
            for i in range(4):
                A[i] += B[i]
                r8 += r7
                vals.append((A[i] + r8 + 16) >> 5)
            self._store_pred_row(plane, off + row * S, vals)

    @staticmethod
    def _store_pred_row(plane: np.ndarray, off: int, vals: list[int]) -> None:
        """Write predictor outputs through the reference's u32 word composition
        (`v0 | v1<<8 | v2<<16 | v3<<24` then LE store), so out-of-range values
        alias between byte lanes exactly as in the C#."""
        for base in range(0, len(vals), 4):
            word = (vals[base] & _M32) \
                | ((vals[base + 1] << 8) & _M32) \
                | ((vals[base + 2] << 16) & _M32) \
                | ((vals[base + 3] << 24) & _M32)
            word &= _M32
            plane[off + base + 0] = word & 0xFF
            plane[off + base + 1] = (word >> 8) & 0xFF
            plane[off + base + 2] = (word >> 16) & 0xFF
            plane[off + base + 3] = (word >> 24) & 0xFF

    # ------------------------------------------------------------ quantizer
    def _setup_quant(self, quantizer: int) -> None:
        """SetupQuantizationTables (MobiclipDecoder.cs:3884-3925)."""
        quantizer = int(quantizer) & _M32
        if self.version == MobiclipVersion.MOFLEX_3DS:
            quantizer = min(max(quantizer, 0xC), 0x34)
        self.quantizer = quantizer
        shift4 = int(self._t.qp_div6[quantizer]) + 8
        mod = int(self._t.qp_mod6[quantizer])
        sc4 = self._t.qscale4[mod].astype(np.int64)
        z4 = self._t.scan_to_raster4.astype(np.int64)
        self.internal[74:90] = ((z4 | (sc4 << shift4)) & _M32).astype(np.uint32)
        shift8 = shift4 - 2
        sc8 = self._t.qscale8[mod].astype(np.int64)
        z8 = self._t.scan_to_raster8.astype(np.int64)
        self.internal[10:74] = ((z8 | (sc8 << shift8)) & _M32).astype(np.uint32)
        # intra-mode cache borders -> "unavailable" (:3913-3924)
        self.imode[[1, 2, 3, 4, 8, 0x10, 0x18, 0x20]] = 9

    # ------------------------------------------------------------- RGB/YUV
    def to_rgb(self) -> np.ndarray:
        """YUV->RGB epilogue (MobiclipDecoder.cs:260-323): chroma upsample by
        pixel parity, then Moflex YCbCr (float) or MODS pseudo-YUV (int)."""
        S, W, H = self.stride, self.width, self.height
        y = self.y_planes[0].reshape(-1, S)[:H, :W].astype(np.float32)
        # Chroma is fetched with flat-plane index arithmetic exactly like the
        # reference (UV[y/2*S + x/2] etc.), so the U/V half-plane boundary
        # aliasing at x/2+1 == S/2 behaves identically.
        flat = self.uv_planes[0].astype(np.float32) - np.float32(128.0)
        yy, xx = np.mgrid[0:H, 0:W]
        base = (yy // 2) * S + xx // 2
        u0 = flat[base]
        v0 = flat[base + S // 2]
        interior = (xx != W - 1) & (yy != H - 1)
        case = np.where(interior, (xx & 1) | ((yy & 1) << 1), 0)
        U, V = u0.copy(), v0.copy()
        m1 = case == 1
        U[m1] = (u0[m1] + flat[base[m1] + 1]) / np.float32(2)
        V[m1] = (v0[m1] + flat[base[m1] + 1 + S // 2]) / np.float32(2)
        m2 = case == 2
        U[m2] = (u0[m2] + flat[base[m2] + S]) / np.float32(2)
        V[m2] = (v0[m2] + flat[base[m2] + S + S // 2]) / np.float32(2)
        m3 = case == 3
        b3 = base[m3]
        U[m3] = (((u0[m3] + flat[b3 + 1]) + flat[b3 + S])
                 + flat[b3 + 1 + S]) / np.float32(4)
        V[m3] = (((v0[m3] + flat[b3 + 1 + S // 2]) + flat[b3 + S + S // 2])
                 + flat[b3 + 1 + S + S // 2]) / np.float32(4)
        if self.version == MobiclipVersion.MOFLEX_3DS:
            R = y + np.float32(1.420) * V
            G = y - np.float32(0.344) * U - np.float32(0.714) * V
            B = y + np.float32(1.772) * U
            R = (R - 16) * np.float32(255) / np.float32(255 - 16)
            G = (G - 16) * np.float32(255) / np.float32(255 - 16)
            B = (B - 16) * np.float32(255) / np.float32(255 - 16)
        else:
            yi = y.astype(np.int32)
            ui = U.astype(np.int32)
            vi = V.astype(np.int32)
            R = (yi + ui - vi).astype(np.float32)
            G = (yi + vi).astype(np.float32)
            B = (yi - ui - vi).astype(np.float32)
        rgb = np.stack([R, G, B], axis=-1)
        return np.clip(rgb, 0, 255).astype(np.uint8)

    def cropped_yuv(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Return (Y, U, V) cropped to (H,W)/(H/2,W/2) for comparisons."""
        S, W, H = self.stride, self.width, self.height
        y = self.y_planes[0].reshape(-1, S)[:H, :W]
        uvp = self.uv_planes[0].reshape(-1, S)
        u = uvp[:H // 2, :W // 2]
        v = uvp[:H // 2, S // 2:S // 2 + W // 2]
        return y, u, v
