"""Bitstream synthesizer: generates valid Mobiclip video streams for testing.

There is no test suite, no fixtures and no golden data in the reference
(SURVEY.md §4), and no .NET runtime in this image, so test vectors are
*synthesized*: this module emits structurally valid bitstreams (every header,
partition code, intra mode, CBP and coefficient is a legal encoding per the
format rules implemented in models/oracle_video.py), with controllable
randomness.  The oracle decodes them to define golden YUV planes; the TPU
pipeline must match bit-for-bit.

It is deliberately NOT an encoder: predictions don't try to match any source
image — any legal stream decodes to *some* deterministic YUV, which is all
cross-validation needs.  (The rate-distortion encoder is a separate component,
mirroring reference MobiEncoder.cs.)
"""
from __future__ import annotations

import collections

import numpy as np

from .coefvlc import codec_for
from ..reference.oracle_video import MobiclipVersion, _PB_SPLIT
from ..reference.tables import TABLES
from .bitio import BitWriter


def _inv_lut(lut: np.ndarray, value: int, min_idx: int = 0) -> int:
    idx = np.nonzero(lut[min_idx:] == value)[0]
    if len(idx) == 0:
        raise ValueError(f"value {value} not in LUT")
    return int(idx[0]) + min_idx


def _pb_code(w: int, h: int, profile: str, mode: int) -> tuple[int, int]:
    """Return (code, nbits) emitting partition ``mode`` for block size (w,h).

    The decoder peeks N bits into the mode LUT then consumes bits[mode]
    (MobiclipDecoder.cs:458-1746); we pick the canonical prefix and verify
    every peek value sharing it maps to the same mode.
    """
    mode_lut = TABLES[f"pb{w}x{h}_mode_{profile}"]
    bits_lut = TABLES[f"pb{w}x{h}_bits_{profile}"]
    peek = int(TABLES[f"pb{w}x{h}_peek_{profile}"])
    nbits = int(bits_lut[mode])
    if nbits == 0:
        raise ValueError(f"mode {mode} not encodable for {w}x{h} {profile}")
    hits = np.nonzero(mode_lut == mode)[0]
    code = int(hits[0]) >> (peek - nbits)
    span = np.arange(code << (peek - nbits), (code + 1) << (peek - nbits))
    assert (mode_lut[span] == mode).all(), (w, h, profile, mode)
    return code, nbits


class StreamSynthesizer:
    """Emits a sequence of frame packets for one synthetic video."""

    def __init__(self, width: int, height: int,
                 version: MobiclipVersion = MobiclipVersion.MODS_DS,
                 seed: int = 0, big_levels: float = 0.0):
        # big_levels: per-coefficient probability of a large (300..2047)
        # escape-3 level whose dequantized value overflows int16 — forces
        # the engines' dense coefficient fallback paths (opt-in: real
        # streams rarely carry such levels, and the sparse upload format
        # is the representative hot path)
        self.big_levels = big_levels
        self.w = width
        self.h = height
        self.version = MobiclipVersion(version)
        self.profile = ("moflex" if self.version == MobiclipVersion.MOFLEX_3DS
                        else "mods")
        self.rng = np.random.default_rng(seed)
        self.frame_idx = 0
        self.quantizer = 0
        self.table = 0  # coefficient VLC table select (I-frame header bit)
        # coverage counters (tested by tests/test_format_surface.py):
        # coefficient kinds per table, half-pel MV components, intra modes
        self.stats: collections.Counter = collections.Counter()
        # mirror of the decoder's intra-mode prediction cache (bytes 0..36 of
        # Internal; borders stay 9 forever, cells persist across MBs)
        self.imode = np.zeros(40, dtype=np.uint8)
        self.imode[[1, 2, 3, 4, 8, 0x10, 0x18, 0x20]] = 9

    # ------------------------------------------------------------ coefficents
    def _emit_block_coefs(self, bw: BitWriter, n: int) -> None:
        """Emit a random sparse coefficient block for an n*n DCT (n=4 or 8),
        cycling through every encoding branch of ReadDCTMatrix
        (MobiclipDecoder.cs:3330-3432): plain 12-bit table hits, escape 1
        (+level offset from table B), escape 2 (+run offset from
        table B[0x80..]) and escape 3 (fully explicit)."""
        codec = codec_for(self.table)
        ncoef = int(self.rng.integers(1, 5))
        positions = sorted(self.rng.choice(n * n, size=ncoef, replace=False))
        prev = -1
        for i, pos in enumerate(positions):
            run = pos - prev - 1
            prev = pos
            end = int(i == ncoef - 1)
            kinds = ["esc3"] + [k for k in ("plain", "esc1", "esc2")
                                if (end, run) in codec.mags[k]]
            kind = str(self.rng.choice(kinds))
            if kind == "esc3":
                # 12-bit signed level (see big_levels in __init__)
                if self.rng.random() < self.big_levels:
                    level = int(self.rng.integers(300, 2048))
                else:
                    level = int(self.rng.integers(1, 40))
            else:
                level = int(self.rng.choice(codec.mags[kind][(end, run)]))
            if self.rng.random() < 0.5:
                level = -level
            codec.emit(bw, end, run, level, kind=kind)
            self.stats[f"coef_{kind}_t{self.table}"] += 1

    # --------------------------------------------------------------- intra
    def _predicted_mode_bits(self, bw: BitWriter, r5: int, mode: int) -> None:
        """Emit the most-probable-mode code for ``mode`` at cache slot r5
        (inverse of loc_116220/sub_1163DC, MobiclipDecoder.cs:1835,2836)."""
        pred = int(self.imode[r5 - 8])
        left = int(self.imode[r5 - 1])
        if pred > left:
            pred = left
        if pred == 9:
            pred = 3
        if mode == pred:
            bw.write_bits(1, 1)
        else:
            v = mode - 1 if mode > pred else mode
            assert 0 <= v <= 7
            bw.write_bits(v, 4)

    def _rand_mode8(self, top: bool, left: bool, ar: bool = False) -> int:
        """Pick a legal 8x8 intra mode given neighbor availability.

        ``ar``: the 7 above-right pixels (vertical-left mode 8 reads up to
        15 top pixels, MobiclipDecoder.cs:2368-2471) lie inside the frame
        width — beyond it, flat-plane reads wrap to the next row, which the
        synthesizer conservatively avoids."""
        cand = [3]
        if top:
            cand += [0]
        if left:
            cand += [1, 4]
        if top and left:
            cand += [5, 6, 7]
        if top and ar:
            cand += [8]
        return int(self.rng.choice(cand))

    def _emit_intra_full_mb(self, bw: BitWriter, mbx: int, mby: int) -> None:
        """Inverse of DecIntraFullBlockPMode (MobiclipDecoder.cs:1759)."""
        top, left = mby > 0, mbx > 0
        cbp = int(self.rng.integers(0, 64))
        bw.write_varint_u(_inv_lut(TABLES["cbp_intra"], cbp))
        use_plane = top and left and self.rng.random() < 0.3
        if use_plane:
            bw.write_bits(2, 3)
            bw.write_varint_s(int(self.rng.integers(-8, 9)))  # Y gradient
        else:
            # the full-MB mode is 3 bits (0..7; MobiclipDecoder.cs:1762):
            # mode 8 is only reachable via the sub-MB predicted-mode scheme
            mode = self._rand_mode8(top, left)
            bw.write_bits(mode, 3)
        for bit in range(4):
            if (cbp >> bit) & 1:
                self._emit_intra8_residual(bw)
        # chroma (loc_116290): also a 3-bit mode
        if use_plane:
            bw.write_bits(2, 3)
            bw.write_varint_s(int(self.rng.integers(-8, 9)))  # U gradient
            bw.write_varint_s(int(self.rng.integers(-8, 9)))  # V gradient
        else:
            bw.write_bits(self._rand_mode8(top, left), 3)
        for bit in (4, 5):
            if (cbp >> bit) & 1:
                self._emit_intra8_residual(bw)

    def _emit_intra8_residual(self, bw: BitWriter) -> None:
        """Inverse of sub_116508 (MobiclipDecoder.cs:2869)."""
        if self.rng.random() < 0.6:
            bw.write_bits(1, 1)  # whole 8x8 DCT
            self._emit_block_coefs(bw, 8)
        else:
            mask = int(self.rng.integers(0, 16))
            bw.write_varint_u(_inv_lut(TABLES["cbp_split8"], mask, min_idx=1))
            for bit in range(4):
                if (mask >> bit) & 1:
                    self._emit_block_coefs(bw, 4)

    def _emit_intra_sub_mb(self, bw: BitWriter, mbx: int, mby: int) -> None:
        """Inverse of DecIntraSubBlockPMode (MobiclipDecoder.cs:1789)."""
        top, left = mby > 0, mbx > 0
        # mode 8 (vertical-left) taps above-right pixels: legal for left-half
        # 8x8s/quads always (taps stay inside this MB's 16 columns), for
        # right-edge quads only when the frame extends another MB to the
        # right (taps out to mb_x*16+22 must not wrap past the frame width)
        right_ok = (mbx + 2) * 16 <= self.w
        cbp = int(self.rng.integers(0, 64))
        bw.write_varint_u(_inv_lut(TABLES["cbp_intra"], cbp))
        for bit, r5, btop, bleft in ((0, 9, top, left), (1, 0xB, top, True),
                                     (2, 0x19, True, left), (3, 0x1B, True, True)):
            x8 = mbx * 16 + (8 if bit & 1 else 0)
            if (cbp >> bit) & 1:
                # loc_116368
                if self.rng.random() < 0.5:
                    bw.write_bits(1, 1)
                    mode = self._rand_mode8(btop, bleft,
                                            right_ok if bit & 1 else True)
                    if btop and bleft and self.rng.random() < 0.15:
                        mode = 2            # 8x8 plane (sub_116CCC)
                    self._predicted_mode_bits(bw, r5, mode)
                    self.stats[f"mode8_{mode}"] += 1
                    self.imode[[r5, r5 + 1, r5 + 8, r5 + 9]] = mode
                    if mode == 2:
                        bw.write_varint_s(int(self.rng.integers(-8, 9)))
                    self._emit_block_coefs(bw, 8)
                else:
                    # no explicit flag: the varint's leading zero IS the
                    # "not whole-8x8" signal (loc_116368 else-branch)
                    mask = int(self.rng.integers(0, 16))
                    bw.write_varint_u(
                        _inv_lut(TABLES["cbp_split8"], mask, min_idx=1))
                    # 4x4 quadrants: TL, TR, BL, BR — inner edges always avail
                    for b4, dr5, b4top, b4left in (
                            (0, 0, btop, bleft), (1, 1, btop, True),
                            (2, 8, True, bleft), (3, 9, True, True)):
                        qx = x8 + (4 if b4 & 1 else 0)
                        mode = self._rand_mode4(b4top, b4left,
                                                qx + 8 <= self.w)
                        if b4top and b4left and self.rng.random() < 0.15:
                            mode = 2        # 4x4 plane (sub_117E98 -> 12)
                        self._predicted_mode_bits(bw, r5 + dr5, mode)
                        self.stats[f"mode4_{mode}"] += 1
                        self.imode[r5 + dr5] = mode
                        if mode == 2:
                            bw.write_varint_s(
                                int(self.rng.integers(-8, 9)))
                        if (mask >> b4) & 1:
                            self._emit_block_coefs(bw, 4)
            else:
                # loc_116220: whole 8x8, predicted mode, no residual
                mode = self._rand_mode8(btop, bleft,
                                        right_ok if bit & 1 else True)
                if btop and bleft and self.rng.random() < 0.15:
                    mode = 2                # 8x8 plane, no residual
                self._predicted_mode_bits(bw, r5, mode)
                self.stats[f"mode8_{mode}"] += 1
                self.imode[[r5, r5 + 1, r5 + 8, r5 + 9]] = mode
                if mode == 2:
                    bw.write_varint_s(int(self.rng.integers(-8, 9)))
        # chroma
        bw.write_bits(self._rand_mode8(top, left), 3)
        for bit in (4, 5):
            if (cbp >> bit) & 1:
                self._emit_intra8_residual(bw)

    def _rand_mode4(self, top: bool, left: bool, ar: bool = False) -> int:
        """Legal 4x4 intra mode (0-8 space; +10 applied by the decoder).
        ``ar``: the above-right taps of mode 8 (decoder mode 18, reading 7
        top pixels, MobiclipDecoder.cs:2734-2768) are inside the frame."""
        cand = [3]
        if top:
            cand += [0]
        if left:
            cand += [1, 4]
        if top and left:
            cand += [5, 6, 7]
        if top and ar:
            cand += [8]
        return int(self.rng.choice(cand))

    # ------------------------------------------------------------------ MC
    def _mv_range(self, bx: int, by: int, w: int, h: int) -> tuple[int, int, int, int]:
        """Conservative legal half-pel MV box for a block at (bx, by)."""
        dx_lo = -2 * bx
        dx_hi = max(dx_lo, 2 * (self.w - w - bx) - 2)
        dy_lo = -2 * by
        dy_hi = max(dy_lo, 2 * (self.h - h - by) - 2)
        return dx_lo, dx_hi, dy_lo, dy_hi

    def _emit_pblock(self, bw: BitWriter, w: int, h: int, bx: int, by: int,
                     pred: tuple[int, int], nrefs: int,
                     depth: int = 0) -> tuple[int, int]:
        """Emit one partition-tree node; returns the MV stored in the cache
        slot (i.e. of the last leaf, matching loc_1147B0's store order)."""
        can_split = bool(_PB_SPLIT[(w, h)]) and depth < 3
        r = self.rng.random()
        if can_split and r < 0.3:
            cases = list(_PB_SPLIT[(w, h)].keys())
            case = int(self.rng.choice(cases))
            code, nbits = _pb_code(w, h, self.profile, case)
            bw.write_bits(code, nbits)
            (sw, sh), dmul, dpix = _PB_SPLIT[(w, h)][case]
            mv = self._emit_pblock(bw, sw, sh, bx, by, pred, nrefs, depth + 1)
            bx2 = bx + dpix
            by2 = by + dmul
            mv = self._emit_pblock(bw, sw, sh, bx2, by2, pred, nrefs,
                                   depth + 1)
            return mv
        if r < 0.45 or nrefs == 0:
            # mode 0: predicted MV, ref 1 — only legal when pred is in range
            # and at least one reference frame exists
            dx_lo, dx_hi, dy_lo, dy_hi = self._mv_range(bx, by, w, h)
            if nrefs > 0 and dx_lo <= pred[0] <= dx_hi \
                    and dy_lo <= pred[1] <= dy_hi:
                code, nbits = _pb_code(w, h, self.profile, 0)
                bw.write_bits(code, nbits)
                return pred
            # fall through to explicit MV (or intra if no refs)
        if nrefs == 0:
            raise RuntimeError("P-frame requires at least one reference")
        ref = int(self.rng.integers(1, min(nrefs, 5) + 1))
        code, nbits = _pb_code(w, h, self.profile, ref)
        bw.write_bits(code, nbits)
        dx_lo, dx_hi, dy_lo, dy_hi = self._mv_range(bx, by, w, h)
        # Any-parity half-pel deltas: odd dx/dy exercise CopyBlock's four
        # `>>1`-truncating interpolation cases (MobiclipDecoder.cs:418-456)
        # on luma AND the derived chroma cases at (dx>>1, dy>>1).
        # |delta| <= 100 keeps varints within the 15-bit refill-safe limit;
        # the intersection with the legal box is never empty because the
        # predictor comes from neighboring blocks (<= 34 half-pels away).
        # _mv_range leaves a 1-full-pel margin at the high edge, so the
        # half-pel taps' extra +1 pixel/row reads stay inside the frame.
        xlo, xhi = max(dx_lo, pred[0] - 100), min(dx_hi, pred[0] + 100)
        ylo, yhi = max(dy_lo, pred[1] - 100), min(dy_hi, pred[1] + 100)
        dx = int(self.rng.integers(xlo, xhi + 1))
        dy = int(self.rng.integers(ylo, yhi + 1))
        self.stats["mv_halfpel"] += (dx & 1) + (dy & 1)
        bw.write_varint_s(dx - pred[0])
        bw.write_varint_s(dy - pred[1])
        return dx, dy

    # --------------------------------------------------------------- frames
    def iframe(self, quantizer: int = 0x18, table: int = 0,
               yuv_format: int = 1, pad: bool = True) -> bytes:
        """Emit one I-frame packet (header per MobiclipDecoder.cs:222-236)."""
        bw = BitWriter()
        bw.write_bits(1, 1)  # I
        bw.write_bits(yuv_format, 1)
        bw.write_bits(table, 1)
        bw.write_bits(quantizer, 6)
        self.table = table  # coefficient VLC table for this frame's coefs
        self.quantizer = quantizer
        if self.profile == "moflex":
            # mirror the decoder's QP clamp (MobiclipDecoder.cs:3886-3890)
            self.quantizer = min(max(self.quantizer, 0xC), 0x34)
        for mby in range(0, self.h // 16):
            for mbx in range(0, self.w // 16):
                sub = self.rng.random() < 0.4
                bw.write_bits(1 if sub else 0, 1)
                if sub:
                    self._emit_intra_sub_mb(bw, mbx, mby)
                else:
                    self._emit_intra_full_mb(bw, mbx, mby)
        self.frame_idx += 1
        return bw.to_bytes() + (b"\x00\x00" if pad else b"")

    def pframe(self, dq: int = 0, pad: bool = True) -> bytes:
        """Emit one P-frame packet (header per MobiclipDecoder.cs:115-143)."""
        assert self.frame_idx > 0, "P-frame needs a prior frame"
        bw = BitWriter()
        bw.write_bits(0, 1)  # not I
        bw.write_varint_s(dq)
        self.table = 0  # P-frames always use table 0 (MobiclipDecoder.cs:144)
        if dq != 0:
            self.quantizer += dq
            if self.profile == "moflex":
                self.quantizer = min(max(self.quantizer, 0xC), 0x34)
        nrefs = min(self.frame_idx, 5)
        # mirror of the decoder's rolling MV cache (Internal[221..])
        ncols = (self.w + 0x20 + 15) // 16
        cache = [(0, 0)] * (ncols * 2)
        for mby in range(0, self.h // 16):
            io = 0
            for mbx in range(0, self.w // 16):
                vals = [cache[io], cache[io + 1], cache[io + 2]]
                px = sorted(v[0] for v in vals)[1]
                py = sorted(v[1] for v in vals)[1]
                io += 1
                cache[io] = (0, 0)
                # intra-in-P occasionally (modes 6/7 at 16x16 level)
                r = self.rng.random()
                if r < 0.08:
                    code, nbits = _pb_code(16, 16, self.profile, 6)
                    bw.write_bits(code, nbits)
                    self._emit_intra_full_mb(bw, mbx, mby)
                elif r < 0.12:
                    code, nbits = _pb_code(16, 16, self.profile, 7)
                    bw.write_bits(code, nbits)
                    self._emit_intra_sub_mb(bw, mbx, mby)
                else:
                    mv = self._emit_pblock(bw, 16, 16, mbx * 16, mby * 16,
                                           (px, py), nrefs)
                    cache[io] = mv
                    # inter MBs carry a residual CBP (loc_1161A0)
                    mask = int(self.rng.integers(0, 64))
                    bw.write_varint_u(_inv_lut(TABLES["cbp_inter"], mask))
                    for _ in range(bin(mask & 0xF).count("1") + bin(mask >> 4).count("1")):
                        self._emit_residual8(bw)
        self.frame_idx += 1
        return bw.to_bytes() + (b"\x00\x00" if pad else b"")

    def _emit_residual8(self, bw: BitWriter) -> None:
        """Inverse of loc_11652C (MobiclipDecoder.cs:2909)."""
        if self.rng.random() < 0.6:
            bw.write_bits(1, 1)
            self._emit_block_coefs(bw, 8)
        else:
            mask = int(self.rng.integers(1, 16))  # mask 0 unreachable here
            bw.write_varint_u(_inv_lut(TABLES["cbp_sub4"], mask, min_idx=1))
            for bit in range(4):
                if (mask >> bit) & 1:
                    self._emit_block_coefs(bw, 4)
