"""Mobiclip video encoder — reference-parity feature set.

Role of the reference's MobiEncoder/MacroBlock/Analyzer stack
(LibMobiclip/Codec/Mobiclip/Encoder/*, ~4.4 kLoC), rebuilt around a key
structural idea the reference only approximates: the encoder keeps a
*decoder twin* — an OracleDecoder instance whose prediction / dequant / IDCT
methods ARE the decode implementation — and reconstructs through it, so
encoder recon and any decoder's output agree bit-for-bit by construction
(the reference hand-mirrors its decoder, MacroBlock.cs:224-509).

Feature parity with the reference encoder stack:

* multi-reference motion search over past frames 1..5 (Analyzer.cs:608-679
  searches 5 refs) — diamond/log descent at full-pel plus half-pel
  refinement against the exact `>>1`-truncating interpolation;
* recursive partition-tree RD over the 16x16..2x2 split lattice
  (PBlock.Partitionize, Analyzer.cs:79-302) with per-size Huffman rates;
* rate-distortion decisions, cost = SAD + lambda*bits with
  lambda = 0.85 * 2^((QP-12)/3) (Analyzer.cs:706,1070);
* intra full-block and sub-block macroblocks with per-8x8/per-4x4
  predicted-mode coding, plane modes with gradient search
  (MacroBlock.cs:630-1793) — including sub-block intra emission inside
  P-frames, which the reference left TODO (MobiEncoder.cs:614-625);
* per-residual whole-8x8-DCT vs 4x4-quad selection by bits
  (sub_116508/loc_11652C inverses);
* run-level coefficient coding through the shortest of the plain table
  code and all three escape fallbacks (EncodeDCT, MobiEncoder.cs:675-765);
* iterative rate control: re-encode at QP+-1 within [12, 40] until the
  frame fits `bits_per_frame` (MobiEncoder.cs:216-248,468-500);
* P->I fallback when fewer than 1/3 of macroblocks choose inter
  (MobiEncoder.cs:249-257).

A copy of the JAX package's ``models/encoder.py`` apart from the motion
search's SAD volume: the port's ``ops/mesearch.SadVolume`` runs on the
encoder's ``device``, and a volume that fails raises (the JAX package falls
back to the host descent there, which would change what is emitted).
"""
from __future__ import annotations

import numpy as np

from ..ops.mesearch import SadVolume
from ..tables import TABLES
from .coefvlc import CoefCodec as _CoefCodec
from ..testing.synth import _inv_lut, _pb_code
from ..utils.bitio import BitWriter, varint_s_nbits, varint_u_nbits
from ..utils.device import check_device
from .oracle_video import _PB_SPLIT, MobiclipVersion, OracleDecoder

_M32 = 0xFFFFFFFF


# --------------------------------------------------------------------- DCT
def _probe_inverse(n: int) -> np.ndarray:
    """Probe the oracle IDCT with unit coefficients to get the (linearized)
    inverse transform matrix M (residual = M @ coefs); returns inv(M) for
    quantization targeting."""
    dec = OracleDecoder(16, 16, MobiclipVersion.MODS_DS)
    M = np.zeros((n * n, n * n))
    base = np.full(256 * 16, 128, dtype=np.uint8)
    for k in range(n * n):
        dense = np.zeros((n, n), np.int32)
        dense[k // n, k % n] = 64  # large enough to dominate rounding
        plane = base.copy()
        dec.y_planes[0] = plane
        dec._apply_idct(plane, 0, n, (dense, 74 if n == 8 else 90))
        block = plane.reshape(16, 256)[:n, :n].astype(np.float64) - 128
        M[:, k] = block.ravel() / 64.0
    return np.linalg.inv(M)


_FWD: dict[int, np.ndarray] = {}


def _forward(block: np.ndarray) -> np.ndarray:
    """Float forward transform of an (n,n) residual into IDCT coef space."""
    n = block.shape[0]
    if n not in _FWD:
        _FWD[n] = _probe_inverse(n)
    return (_FWD[n] @ block.astype(np.float64).ravel()).reshape(n, n)


# -------------------------------------------------------------- token plans
# Planning appends bit tokens while mutating the twin in decode order;
# emission then writes them out.  Tokens: ("b", value, nbits),
# ("vu", value), ("vs", value), ("coef", end, run, level).
def _tok_bits(tokens, coefc: _CoefCodec) -> int:
    n = 0
    for t in tokens:
        if t[0] == "b":
            n += t[2]
        elif t[0] == "vu":
            n += varint_u_nbits(t[1])
        elif t[0] == "vs":
            n += varint_s_nbits(t[1])
        else:
            n += coefc.bits(t[1], t[2], t[3])
    return n


class MobiclipEncoder:
    """Drop-in role of MobiEncoder.EncodeFrame (MobiEncoder.cs:117-147):
    YUV in, frame packet out, I-frame every `gop` frames.

    ``bits_per_frame`` enables the reference's iterative rate control
    (re-encode at QP+-1 in [12, 40] until the frame fits).  ``refs`` bounds
    the motion-search reference window (the reference searches 5).
    ``min_part`` bounds partition-tree leaves (8 = splits down to 8x8,
    4/2 = deeper lattice, 16 = no splitting).  ``device`` is where the
    SAD volume runs (required; a CUDA device that is not there raises)."""

    def __init__(self, width: int, height: int,
                 version: MobiclipVersion = MobiclipVersion.MOFLEX_3DS,
                 quantizer: int = 0x16, gop: int = 30,
                 bits_per_frame: int | None = None, refs: int = 5,
                 min_part: int = 8, me_range: int = 16, *, device):
        self.device = check_device(device)
        self.w, self.h = width, height
        self.version = MobiclipVersion(version)
        self.profile = ("moflex" if self.version == MobiclipVersion.MOFLEX_3DS
                        else "mods")
        self.qp = quantizer
        self.gop = gop
        self.bits_per_frame = bits_per_frame
        self.max_refs = refs
        self.min_part = min_part
        self.me_range = me_range
        self.frame_idx = 0
        self.twin = OracleDecoder(width, height, version)
        self.S = self.twin.stride
        self.coefc = _CoefCodec(0)
        self.last_frame_bits = 0
        self.last_frame_was_i = True
        self._qcache: dict[tuple, tuple] = {}
        self._sadvol = None

    # ------------------------------------------------------------ twin state
    def _snapshot(self):
        t = self.twin
        return ([None if p is None else p.copy() for p in t.y_planes],
                [None if p is None else p.copy() for p in t.uv_planes],
                t.internal.copy(), t.imode.copy(), t.quantizer)

    def _restore(self, snap) -> None:
        t = self.twin
        t.y_planes = [None if p is None else p.copy() for p in snap[0]]
        t.uv_planes = [None if p is None else p.copy() for p in snap[1]]
        t.internal = snap[2].copy()
        t.imode = snap[3].copy()
        t.quantizer = snap[4]

    @property
    def _lambda(self) -> float:
        """RD lambda (Analyzer.cs:706,1070)."""
        return 0.85 * 2.0 ** ((self.qp - 12) / 3.0)

    # ------------------------------------------------------------ transforms
    def _qtables(self, n: int):
        """Per-(QP, n) vectorized views of the twin's packed dequant
        entries: (raster positions in scan order, scales in scan order,
        per-raster-position scale)."""
        key = (self.twin.quantizer, n)
        cached = self._qcache.get(key)
        if cached is None:
            base = 10 if n == 8 else 74
            packed = self.twin.internal[base:base + n * n].astype(np.int64)
            pos = (packed & 0xFF).astype(np.int64)
            scale = (packed & 0xFFFFFFFF) >> 8
            scale_by_pos = np.zeros(n * n, np.int64)
            scale_by_pos[pos] = scale
            cached = (pos, scale, scale_by_pos)
            self._qcache[key] = cached
        return cached

    def _quant_block(self, resid: np.ndarray, n: int) -> np.ndarray:
        """Quantize a residual into VLC levels via the twin's packed dequant
        entries (scale per scan position)."""
        coefs = _forward(resid)
        pos, scale, _ = self._qtables(n)
        vals = coefs.ravel()[pos]
        lv = np.round(vals / np.where(scale == 0, 1, scale))
        lv = np.where(scale == 0, 0, np.clip(lv, -2047, 2047))
        levels = np.zeros(n * n, np.int64)
        levels[pos] = lv.astype(np.int64)
        return levels.reshape(n, n)

    def _coef_tokens(self, levels: np.ndarray, n: int) -> list | None:
        """Run-level tokens in scan order, or None when all-zero."""
        scan = TABLES.scan_to_raster8 if n == 8 else TABLES.scan_to_raster4
        seq = [int(levels[p // n, p % n]) for p in scan[:n * n]]
        nz = [i for i, v in enumerate(seq) if v != 0]
        if not nz:
            return None
        toks = []
        prev = -1
        for j, i in enumerate(nz):
            toks.append(("coef", int(j == len(nz) - 1), i - prev - 1, seq[i]))
            prev = i
        return toks

    def _ctb(self, toks) -> int:
        return sum(self.coefc.bits(t[1], t[2], t[3]) for t in toks)

    def _apply_levels(self, plane: np.ndarray, off: int, n: int,
                      levels: np.ndarray) -> None:
        """Reconstruct through the twin: dequantize the emitted levels with
        the packed tables and run the real IDCT add-saturate."""
        _, _, scale_by_pos = self._qtables(n)
        dense = (levels.ravel() * scale_by_pos).astype(np.int32).reshape(n, n)
        self.twin._apply_idct(plane, off, n, (dense, 74 if n == 8 else 90))

    # --------------------------------------------------------------- helpers
    def _plane2d(self, plane: np.ndarray) -> np.ndarray:
        return plane.reshape(-1, self.S)

    @staticmethod
    def _sad(a: np.ndarray, b: np.ndarray) -> int:
        return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).sum())

    @staticmethod
    def _sse(a: np.ndarray, b: np.ndarray) -> int:
        d = a.astype(np.int64) - b.astype(np.int64)
        return int((d * d).sum())

    # ============================================================ top level
    def encode_frame(self, y: np.ndarray, u: np.ndarray,
                     v: np.ndarray) -> bytes:
        """y: (H, W) uint8; u, v: (H/2, W/2) uint8.  Returns the packet
        (byte-aligned, no padding — containers add their own framing)."""
        want_i = (self.frame_idx % self.gop) == 0
        snap = self._snapshot()
        pkt = self._encode_managed(y, u, v, want_i, snap)
        if self.bits_per_frame is not None:
            # iterative rate control (MobiEncoder.cs:216-248): overshoot
            # raises QP, deep undershoot lowers it; twin state always
            # corresponds to the returned packet
            target = self.bits_per_frame
            for _ in range(8):
                bits = len(pkt) * 8
                if bits > target and self.qp < 40:
                    self.qp += 1
                elif bits < target * 3 // 4 and self.qp > 12:
                    self.qp -= 1
                else:
                    break
                self._restore(snap)
                pkt2 = self._encode_managed(y, u, v, want_i, snap)
                if len(pkt2) * 8 > target and len(pkt) * 8 <= target:
                    # the lower-QP probe overshot: go back
                    self.qp += 1
                    self._restore(snap)
                    pkt = self._encode_managed(y, u, v, want_i, snap)
                    break
                pkt = pkt2
        self.last_frame_bits = len(pkt) * 8
        self.frame_idx += 1
        return pkt

    def _encode_managed(self, y, u, v, want_i: bool, snap) -> bytes:
        """One frame emission at self.qp, including the P->I fallback
        (< 1/3 inter MBs re-encodes as intra, MobiEncoder.cs:249-257)."""
        pkt, n_inter, n_mbs = self._encode_once(y, u, v, want_i)
        if not want_i and n_inter * 3 < n_mbs:
            self._restore(snap)
            pkt, _, _ = self._encode_once(y, u, v, True)
            self.last_frame_was_i = True
        else:
            self.last_frame_was_i = want_i
        return pkt

    def _encode_once(self, y, u, v, is_i: bool):
        """One full frame emission at self.qp.  Twin must be at the
        pre-frame state.  Returns (packet, n_inter_mbs, n_mbs)."""
        t = self.twin
        # ring shift + fresh planes (decoder side of the same step)
        for i in range(5, 0, -1):
            t.y_planes[i] = t.y_planes[i - 1]
            t.uv_planes[i] = t.uv_planes[i - 1]
        t.y_planes[0] = np.zeros(self.S * self.h, np.uint8)
        t.uv_planes[0] = np.zeros(self.S * self.h // 2, np.uint8)
        bw = BitWriter()
        if is_i:
            self._encode_iframe(bw, y, u, v)
            n_inter, n_mbs = 0, (self.h // 16) * (self.w // 16)
        else:
            n_inter, n_mbs = self._encode_pframe(bw, y, u, v)
        return bw.to_bytes(), n_inter, n_mbs

    def _emit_tokens(self, bw: BitWriter, tokens) -> None:
        for tk in tokens:
            if tk[0] == "b":
                bw.write_bits(tk[1], tk[2])
            elif tk[0] == "vu":
                bw.write_varint_u(tk[1])
            elif tk[0] == "vs":
                bw.write_varint_s(tk[1])
            else:
                self.coefc.emit(bw, tk[1], tk[2], tk[3])

    # ================================================================ intra
    def _mode_candidates(self, top: bool, left: bool, px: int, n: int,
                         three_bit: bool = False) -> list[int]:
        """Legal intra modes by neighbor availability (the format doesn't
        gate modes; legality means the reads stay inside the plane and on
        already-deterministic pixels).  ``three_bit`` restricts to the
        0..7 space of the full-block/chroma mode field (2 = plane there)."""
        cand = [3]
        if top:
            cand.append(0)
        if left:
            cand += [1, 4]
        if top and left:
            cand += [5, 6, 7]
        if not three_bit and top and px + 2 * n <= self.S:
            cand.append(8)  # reads the above-right row segment
        return cand

    def _pred_mode_tokens(self, r5: int, mode: int) -> list:
        """Most-probable-mode tokens (inverse of loc_116220/sub_1163DC)."""
        pred = int(self.twin.imode[r5 - 8])
        left = int(self.twin.imode[r5 - 1])
        if pred > left:
            pred = left
        if pred == 9:
            pred = 3
        if mode == pred:
            return [("b", 1, 1)]
        v = mode - 1 if mode > pred else mode
        assert 0 <= v <= 7
        return [("b", v, 4)]

    def _best_mode(self, flat, target, py, px, cand, n,
                   allow_plane: bool):
        """Try modes on the twin plane (restoring after each), RD-scored by
        SAD + lambda*rate.  ``flat`` must be the canonical 1-D plane object
        (the oracle's V-half fix tests identity against uv_planes[0]).
        Returns (mode, sad, gradient)."""
        plane2d = self._plane2d(flat)
        off = py * self.S + px
        region = plane2d[py:py + n, px:px + n].copy()
        lam = self._lambda
        best = (3, 1 << 62, None, float(1 << 62))
        for m in cand:
            self.twin._predict_intra(m if n == 8 else m + 10, flat, off, None)
            sad = self._sad(plane2d[py:py + n, px:px + n], target)
            plane2d[py:py + n, px:px + n] = region
            cost = sad + lam * 4
            if cost < best[3]:
                best = (m, sad, None, cost)
        # plane mode (2/12): search the gradient varint
        if allow_plane and py > 0 and px > 0:
            for g in (-4, -2, -1, 0, 1, 2, 4):
                self.twin._predict_intra(2 if n == 8 else 12, flat, off, g)
                sad = self._sad(plane2d[py:py + n, px:px + n], target)
                plane2d[py:py + n, px:px + n] = region
                cost = sad + lam * (4 + varint_s_nbits(g))
                if cost < best[3]:
                    best = (2, sad, g, cost)
        return best[0], best[1], best[2]

    def _intra8_residual_tokens(self, flat, target, py, px, mode,
                                gradient) -> tuple[list, bool]:
        """Predict (committing to the twin), quantize, apply; returns
        (tokens, coded).  Mirrors sub_116508 (_intra8_with_residual)
        exactly: the whole-8x8-DCT path predicts once with ``mode``; the
        4x4-quad path re-predicts EACH quad with mode+10 in decode order,
        so later quads see earlier quads' residuals.  ``mode`` is the
        effective 8x8 mode (9 after a plane16/plane8 header)."""
        S = self.S
        plane2d = self._plane2d(flat)
        off = py * S + px
        region0 = plane2d[py:py + 8, px:px + 8].copy()
        tgt = target.astype(np.int64)
        # ---- path A: one 8x8 prediction + whole-8x8 DCT
        self.twin._predict_intra(mode, flat, off, gradient)
        resid = tgt - plane2d[py:py + 8, px:px + 8].astype(np.int64)
        lv8 = self._quant_block(resid, 8)
        t8 = self._coef_tokens(lv8, 8)
        if t8 is not None:
            self._apply_levels(flat, off, 8, lv8)
        recon_a = plane2d[py:py + 8, px:px + 8].copy()
        sse_a = self._sse(recon_a, target)
        bits8 = (1 + self._ctb(t8)) if t8 else 0
        plane2d[py:py + 8, px:px + 8] = region0
        # ---- path B: per-quad mode+10 prediction, sequential residuals
        mode4 = mode + 10
        lv4s, t4s, mask = [], [], 0
        for b, (dy, dx) in enumerate(((0, 0), (0, 4), (4, 0), (4, 4))):
            qoff = off + dy * S + dx
            self.twin._predict_intra(mode4, flat, qoff, None)
            residq = tgt[dy:dy + 4, dx:dx + 4] \
                - plane2d[py + dy:py + dy + 4,
                          px + dx:px + dx + 4].astype(np.int64)
            lv4 = self._quant_block(residq, 4)
            tt = self._coef_tokens(lv4, 4)
            lv4s.append(lv4)
            t4s.append(tt)
            if tt:
                mask |= 1 << b
                self._apply_levels(flat, qoff, 4, lv4)
        recon_b = plane2d[py:py + 8, px:px + 8].copy()
        sse_b = self._sse(recon_b, target)
        if mask:
            quad_idx = _inv_lut(TABLES.cbp_split8, mask, min_idx=1)
            bits4 = varint_u_nbits(quad_idx) \
                + sum(self._ctb(tt) for tt in t4s if tt)
        else:
            bits4 = 1 << 30
        lam = self._lambda
        use_b = mask and (sse_b + lam * bits4 < sse_a + lam * bits8)
        if use_b:
            toks = [("vu", quad_idx)]
            for b in range(4):
                if (mask >> b) & 1:
                    toks += t4s[b]
            return toks, True
        plane2d[py:py + 8, px:px + 8] = recon_a
        if t8 is None:
            return [], False  # no residual at all -> cbp bit 0
        return [("b", 1, 1)] + t8, True

    def _search_plane_gradient(self, predict, region_get, target,
                               grads=(-4, -2, -1, 0, 1, 2, 4)):
        """Generic gradient search: `predict(g)` commits a trial prediction,
        `region_get()` reads it back.  Restores nothing — caller passes
        restorable closures.  Returns (best_sad, best_g)."""
        best = (1 << 62, 0)
        for g in grads:
            predict(g)
            sad = self._sad(region_get(), target)
            if sad < best[0]:
                best = (sad, g)
        return best

    def _plan_intra_full_mb(self, mbx: int, mby: int, y, u, v) -> list:
        """Full-block intra MB (DecIntraFullBlockPMode inverse,
        MobiclipDecoder.cs:1759-1786).  Commits recon to the twin and
        returns bit tokens (cbp varint onward, selector excluded)."""
        t = self.twin
        S = self.S
        ty = self._plane2d(t.y_planes[0])
        tuv = self._plane2d(t.uv_planes[0])
        py, px = mby * 16, mbx * 16
        top, left = mby > 0, mbx > 0
        flat = t.y_planes[0]
        # luma mode: pick by the top-left 8x8 (the 3-bit field applies to
        # all four); mode 2 in this field means plane16, handled below
        cand = self._mode_candidates(top, left, px, 8, three_bit=True)
        mode, sad_m, _ = self._best_mode(flat, y[py:py + 8, px:px + 8],
                                         py, px, cand, 8,
                                         allow_plane=False)
        grad = None
        if top and left:
            region = ty[py:py + 16, px:px + 16].copy()
            tgt16 = y[py:py + 16, px:px + 16]

            def pred16(g):
                t._plane16(flat, py * S + px, g)

            def get16():
                r = ty[py:py + 16, px:px + 16].copy()
                ty[py:py + 16, px:px + 16] = region
                return r

            sad_p, best_g = self._search_plane_gradient(pred16, get16, tgt16)
            # compare plane16 against the chosen mode over the full MB
            for dy, dx in ((0, 0), (0, 8), (8, 0), (8, 8)):
                t._predict_intra(mode, flat, (py + dy) * S + px + dx, None)
            sad_m16 = self._sad(ty[py:py + 16, px:px + 16], tgt16)
            ty[py:py + 16, px:px + 16] = region
            if sad_p < sad_m16:
                grad = best_g
        if grad is not None:
            t._plane16(flat, py * S + px, grad)
            hdr = [("b", 2, 3), ("vs", grad)]
            mode_eff = 9
        else:
            hdr = [("b", mode, 3)]
            mode_eff = mode
        # per-8x8 in decode order: predict + quantize; honest cbp
        cbp = 0
        body: list = []
        for bit, (dy, dx) in enumerate(((0, 0), (0, 8), (8, 0), (8, 8))):
            toks, coded = self._intra8_residual_tokens(
                flat, y[py + dy:py + dy + 8, px + dx:px + dx + 8],
                py + dy, px + dx, mode_eff, None)
            if coded:
                cbp |= 1 << bit
                body += toks
        # chroma: one 3-bit mode for both halves (loc_116290), or plane
        # with per-half gradients
        cy, cx = py // 2, px // 2
        uvflat = t.uv_planes[0]
        ccand = self._mode_candidates(top, left, cx, 8, three_bit=True)
        cmode, csad, _ = self._best_mode(uvflat, u[cy:cy + 8, cx:cx + 8],
                                         cy, cx, ccand, 8, allow_plane=False)
        cgrads = None
        if top and left:
            regu = tuv[cy:cy + 8, cx:cx + 8].copy()

            def predu(g):
                t._predict_intra(2, uvflat, cy * S + cx, g)

            def getu():
                r = tuv[cy:cy + 8, cx:cx + 8].copy()
                tuv[cy:cy + 8, cx:cx + 8] = regu
                return r

            sad_u, gu = self._search_plane_gradient(
                predu, getu, u[cy:cy + 8, cx:cx + 8], grads=(-2, -1, 0, 1, 2))
            if sad_u < csad:
                vx0 = cx + S // 2
                regv = tuv[cy:cy + 8, vx0:vx0 + 8].copy()

                def predv(g):
                    t._predict_intra(2, uvflat, cy * S + vx0, g)

                def getv():
                    r = tuv[cy:cy + 8, vx0:vx0 + 8].copy()
                    tuv[cy:cy + 8, vx0:vx0 + 8] = regv
                    return r

                _, gv = self._search_plane_gradient(
                    predv, getv, v[cy:cy + 8, cx:cx + 8],
                    grads=(-2, -1, 0, 1, 2))
                cgrads = (gu, gv)
        if cgrads is not None:
            chdr = [("b", 2, 3), ("vs", cgrads[0]), ("vs", cgrads[1])]
            t._predict_intra(2, uvflat, cy * S + cx, cgrads[0])
            t._predict_intra(2, uvflat, cy * S + cx + S // 2, cgrads[1])
            cmode_eff = 9
        else:
            chdr = [("b", cmode, 3)]
            cmode_eff = cmode
        cbody: list = []
        for bit, coff, src in ((4, cx, u), (5, cx + S // 2, v)):
            toks, coded = self._intra8_residual_tokens(
                uvflat, src[cy:cy + 8, cx:cx + 8], cy, coff, cmode_eff, None)
            if coded:
                cbp |= 1 << bit
                cbody += toks
        return ([("vu", _inv_lut(TABLES.cbp_intra, cbp))] + hdr + body
                + chdr + cbody)

    def _plan_intra_sub_mb(self, mbx: int, mby: int, y, u, v) -> list:
        """Sub-block intra MB (DecIntraSubBlockPMode inverse,
        MobiclipDecoder.cs:1789-1807): per-8x8 predicted-mode coding with
        optional 4x4-quad modes.  The reference encoder never implemented
        this emission path (MobiEncoder.cs:614-625 TODO)."""
        t = self.twin
        S = self.S
        ty = self._plane2d(t.y_planes[0])
        tuv = self._plane2d(t.uv_planes[0])
        py, px = mby * 16, mbx * 16
        top, left = mby > 0, mbx > 0
        flat = t.y_planes[0]
        lam = self._lambda
        cbp = 0
        parts: list = []
        quads_geo = ((0, (0, 0), 0), (1, (0, 4), 1),
                     (2, (4, 0), 8), (3, (4, 4), 9))
        for bit, (dy, dx), r5, btop, bleft in (
                (0, (0, 0), 9, top, left), (1, (0, 8), 0xB, top, True),
                (2, (8, 0), 0x19, True, left), (3, (8, 8), 0x1B, True, True)):
            bpy, bpx = py + dy, px + dx
            target = y[bpy:bpy + 8, bpx:bpx + 8]
            cand = self._mode_candidates(btop, bleft, bpx, 8)
            mode, sad8, grad = self._best_mode(flat, target, bpy, bpx,
                                               cand, 8, allow_plane=True)
            # probe the 4x4-quad alternative by prediction SAD
            probe4 = []
            sad4 = 0
            for b4, (qy, qx), dr5 in quads_geo:
                qpy, qpx = bpy + qy, bpx + qx
                c4 = self._mode_candidates(btop or qy > 0, bleft or qx > 0,
                                           qpx, 4)
                m4, s4, g4 = self._best_mode(flat,
                                             y[qpy:qpy + 4, qpx:qpx + 4],
                                             qpy, qpx, c4, 4,
                                             allow_plane=True)
                probe4.append((m4, g4))
                sad4 += s4
            if sad4 + lam * 12 < sad8:
                # quad path (cbp bit 1, leading varint >= 1 signals it)
                cbp |= 1 << bit
                mask = 0
                qparts: list = []
                for b4, (qy, qx), dr5 in quads_geo:
                    qpy, qpx = bpy + qy, bpx + qx
                    off4 = qpy * S + qpx
                    # re-pick with true recon state (left/top quads applied)
                    c4 = self._mode_candidates(btop or qy > 0,
                                               bleft or qx > 0, qpx, 4)
                    m4, _, g4 = self._best_mode(flat,
                                                y[qpy:qpy + 4, qpx:qpx + 4],
                                                qpy, qpx, c4, 4,
                                                allow_plane=True)
                    ptoks = self._pred_mode_tokens(r5 + dr5, m4)
                    t.imode[r5 + dr5] = m4
                    t._predict_intra(m4 + 10, flat, off4, g4)
                    if g4 is not None:
                        ptoks.append(("vs", g4))
                    resid = y[qpy:qpy + 4, qpx:qpx + 4].astype(np.int64) \
                        - ty[qpy:qpy + 4, qpx:qpx + 4].astype(np.int64)
                    lv = self._quant_block(resid, 4)
                    ct = self._coef_tokens(lv, 4)
                    if ct:
                        mask |= 1 << b4
                        ptoks += ct
                        self._apply_levels(flat, off4, 4, lv)
                    qparts.append(ptoks)
                parts.append([("vu", _inv_lut(TABLES.cbp_split8, mask,
                                              min_idx=1))])
                for ptoks in qparts:
                    parts.append(ptoks)
                continue
            # whole-8x8 path: predict, then residual presence decides cbp
            ptoks = self._pred_mode_tokens(r5, mode)
            t.imode[[r5, r5 + 1, r5 + 8, r5 + 9]] = mode
            t._predict_intra(mode, flat, bpy * S + bpx, grad)
            if grad is not None:
                ptoks.append(("vs", grad))
            resid = target.astype(np.int64) \
                - ty[bpy:bpy + 8, bpx:bpx + 8].astype(np.int64)
            lv8 = self._quant_block(resid, 8)
            ct = self._coef_tokens(lv8, 8)
            if ct:
                cbp |= 1 << bit
                self._apply_levels(flat, bpy * S + bpx, 8, lv8)
                parts.append([("b", 1, 1)] + ptoks + ct)
            else:
                parts.append(ptoks)
        # chroma — same scheme as the full-block path, no plane option
        cy, cx = py // 2, px // 2
        ccand = self._mode_candidates(top, left, cx, 8, three_bit=True)
        cmode, _, _ = self._best_mode(t.uv_planes[0],
                                      u[cy:cy + 8, cx:cx + 8], cy, cx,
                                      ccand, 8, allow_plane=False)
        cbody: list = []
        for bit, coff, src in ((4, cx, u), (5, cx + S // 2, v)):
            toks, coded = self._intra8_residual_tokens(
                t.uv_planes[0], src[cy:cy + 8, cx:cx + 8], cy, coff,
                cmode, None)
            if coded:
                cbp |= 1 << bit
                cbody += toks
        out = [("vu", _inv_lut(TABLES.cbp_intra, cbp))]
        for ptoks in parts:
            out += ptoks
        out += [("b", cmode, 3)] + cbody
        return out

    def _encode_iframe(self, bw: BitWriter, y, u, v) -> None:
        bw.write_bits(1, 1)            # I
        bw.write_bits(1, 1)            # yuv format
        bw.write_bits(0, 1)            # coefficient table 0
        bw.write_bits(self.qp, 6)
        if self.twin.quantizer != self.qp:
            self.twin._setup_quant(self.qp)
        for mby in range(self.h // 16):
            for mbx in range(self.w // 16):
                toks = self._plan_intra_mb_rd(mbx, mby, y, u, v)
                self._emit_tokens(bw, toks)

    def _plan_intra_mb_rd(self, mbx: int, mby: int, y, u, v,
                          in_p: bool = False) -> list:
        """RD-choose full-block vs sub-block intra; returns tokens including
        the leading selector (1-bit sub flag in I-frames, pb16 partition
        code 6/7 in P-frames).  Commits the winner's recon to the twin."""
        t = self.twin
        S = self.S
        py, px = mby * 16, mbx * 16
        snap = (t.y_planes[0].copy(), t.uv_planes[0].copy(), t.imode.copy())
        t_full = self._plan_intra_full_mb(mbx, mby, y, u, v)
        ty = self._plane2d(t.y_planes[0])
        sse_full = self._sse(ty[py:py + 16, px:px + 16],
                             y[py:py + 16, px:px + 16])
        recon_full = (t.y_planes[0].copy(), t.uv_planes[0].copy(),
                      t.imode.copy())
        t.y_planes[0], t.uv_planes[0], t.imode = \
            snap[0].copy(), snap[1].copy(), snap[2].copy()
        t_sub = self._plan_intra_sub_mb(mbx, mby, y, u, v)
        ty = self._plane2d(t.y_planes[0])
        sse_sub = self._sse(ty[py:py + 16, px:px + 16],
                            y[py:py + 16, px:px + 16])
        lam = self._lambda
        cost_full = sse_full + lam * _tok_bits(t_full, self.coefc)
        cost_sub = sse_sub + lam * _tok_bits(t_sub, self.coefc)
        if in_p:
            c6, n6 = _pb_code(16, 16, self.profile, 6)
            c7, n7 = _pb_code(16, 16, self.profile, 7)
            sel_full, sel_sub = [("b", c6, n6)], [("b", c7, n7)]
        else:
            sel_full, sel_sub = [("b", 0, 1)], [("b", 1, 1)]
        if cost_full <= cost_sub:
            t.y_planes[0], t.uv_planes[0], t.imode = recon_full
            return sel_full + t_full
        return sel_sub + t_sub

    # ================================================================ inter
    def _mv_range(self, bx, by, w, h):
        """Conservative legal half-pel MV box (keeps every filter tap of
        CopyBlock, luma and chroma, inside the frame)."""
        dx_lo = -2 * bx
        dx_hi = max(dx_lo, 2 * (self.w - w - bx) - 2)
        dy_lo = -2 * by
        dy_hi = max(dy_lo, 2 * (self.h - h - by) - 2)
        return dx_lo, dx_hi, dy_lo, dy_hi

    def _fetch_pred(self, ref2d, bx, by, w, h, dx, dy) -> np.ndarray:
        """Exact half-pel fetch (CopyBlock semantics: truncating >>1 per
        operand, MobiclipDecoder.cs:433-449)."""
        x0, y0 = bx + (dx >> 1), by + (dy >> 1)
        case = (dx & 1) | ((dy & 1) << 1)
        if case == 0:
            return ref2d[y0:y0 + h, x0:x0 + w].astype(np.int32)
        a = ref2d[y0:y0 + h + 1, x0:x0 + w + 1].astype(np.int32)
        if case == 1:
            return (a[:h, :w] >> 1) + (a[:h, 1:w + 1] >> 1)
        if case == 2:
            return (a[:h, :w] >> 1) + (a[1:h + 1, :w] >> 1)
        return ((((a[:h, :w] >> 1) + (a[:h, 1:w + 1] >> 1)) >> 1)
                + (((a[1:h + 1, :w] >> 1) + (a[1:h + 1, 1:w + 1] >> 1)) >> 1))

    def _search_block(self, target, bx, by, w, h, pred, nrefs):
        """Full-pel motion search + half-pel refinement per reference
        frame.  8-aligned leaves use the device-computed full-search SAD
        volume (ops/mesearch.py) — strictly stronger than the reference's
        log descent (Analyzer.cs:608-679) and far cheaper on host; other
        geometries fall back to the descent.  Returns (cost, mode, mv):
        mode 0 = predicted-MV on ref 1, else the 1-based ref index."""
        lam = self._lambda
        lo_x, hi_x, lo_y, hi_y = self._mv_range(bx, by, w, h)
        vol = self._sadvol
        if (vol is not None and vol.vol is not None
                and w % 8 == 0 and h % 8 == 0
                and bx % 8 == 0 and by % 8 == 0):
            return self._search_block_vol(
                target, bx, by, w, h, pred, nrefs,
                (lo_x, hi_x, lo_y, hi_y))
        best = None
        for ref in range(1, min(nrefs, self.max_refs) + 1):
            rplane = self.twin.y_planes[ref]
            if rplane is None:
                break
            ref2d = self._plane2d(rplane)
            code_bits = _pb_code(w, h, self.profile, ref)[1]

            def sad_at(dx, dy):
                if not (lo_x <= dx <= hi_x and lo_y <= dy <= hi_y):
                    return 1 << 60
                return self._sad(
                    self._fetch_pred(ref2d, bx, by, w, h, dx, dy), target)

            # start at the clamped, full-pel-rounded predictor
            cx = min(max(pred[0] & ~1, lo_x), hi_x & ~1)
            cy = min(max(pred[1] & ~1, lo_y), hi_y & ~1)
            csad = sad_at(cx, cy)
            step = 1 << max(1, self.me_range.bit_length() - 1)
            while step >= 2:
                moved = True
                while moved:
                    moved = False
                    for ddx, ddy in ((step, 0), (-step, 0),
                                     (0, step), (0, -step)):
                        s = sad_at(cx + ddx, cy + ddy)
                        if s < csad:
                            cx, cy, csad = cx + ddx, cy + ddy, s
                            moved = True
                step >>= 1
            for ddx in (-1, 0, 1):  # half-pel refinement
                for ddy in (-1, 0, 1):
                    if ddx or ddy:
                        s = sad_at(cx + ddx, cy + ddy)
                        if s < csad:
                            cx, cy, csad = cx + ddx, cy + ddy, s
            rate = code_bits + varint_s_nbits(cx - pred[0]) \
                + varint_s_nbits(cy - pred[1])
            cost = csad + lam * rate
            if best is None or cost < best[0]:
                best = (cost, ref, (cx, cy))
            if ref == 1 and lo_x <= pred[0] <= hi_x \
                    and lo_y <= pred[1] <= hi_y:
                # mode 0: exact predicted MV, no delta
                s = sad_at(pred[0], pred[1])
                c0 = s + lam * _pb_code(w, h, self.profile, 0)[1]
                if c0 < best[0]:
                    best = (c0, 0, pred)
        return best

    def _search_block_vol(self, target, bx, by, w, h, pred, nrefs, box):
        """Volume-backed search: full-pel best per ref from the device SAD
        volume, rate + 3x3 half-pel refinement on host for the top
        candidates, plus the mode-0 predicted-MV option."""
        lam = self._lambda
        lo_x, hi_x, lo_y, hi_y = box
        cands = self._sadvol.leaf_best(bx, by, w, h, lo_x, hi_x, lo_y,
                                       hi_y, min(nrefs, self.max_refs))
        best = None
        for sad_fp, ref, (cx, cy) in cands[:2]:
            if self.twin.y_planes[ref] is None:
                continue
            ref2d = self._plane2d(self.twin.y_planes[ref])
            code_bits = _pb_code(w, h, self.profile, ref)[1]

            def sad_at(dx, dy):
                if not (lo_x <= dx <= hi_x and lo_y <= dy <= hi_y):
                    return 1 << 60
                return self._sad(
                    self._fetch_pred(ref2d, bx, by, w, h, dx, dy), target)

            csad = sad_fp
            for ddx in (-1, 0, 1):
                for ddy in (-1, 0, 1):
                    if ddx or ddy:
                        s = sad_at(cx + ddx, cy + ddy)
                        if s < csad:
                            cx, cy, csad = cx + ddx, cy + ddy, s
            rate = code_bits + varint_s_nbits(cx - pred[0]) \
                + varint_s_nbits(cy - pred[1])
            cost = csad + lam * rate
            if best is None or cost < best[0]:
                best = (cost, ref, (cx, cy))
        if self.twin.y_planes[1] is not None \
                and lo_x <= pred[0] <= hi_x and lo_y <= pred[1] <= hi_y:
            ref2d = self._plane2d(self.twin.y_planes[1])
            s = self._sad(self._fetch_pred(ref2d, bx, by, w, h,
                                           pred[0], pred[1]), target)
            c0 = s + lam * _pb_code(w, h, self.profile, 0)[1]
            if best is None or c0 < best[0]:
                best = (c0, 0, pred)
        return best

    def _plan_ptree(self, bx, by, w, h, pred, nrefs):
        """Recursive partition RD (PBlock.Partitionize analog,
        Analyzer.cs:79-302).  Returns (cost, tree); tree is
        ("leaf", mode_or_ref, mv) or ("split", case, sub1, sub2)."""
        lam = self._lambda
        cost, mode_or_ref, mv = self._search_block(
            self._tgt[by:by + h, bx:bx + w], bx, by, w, h, pred, nrefs)
        node = (cost, ("leaf", mode_or_ref, mv))
        for case, ((sw, sh), dmul, dpix) in _PB_SPLIT[(w, h)].items():
            if min(sw, sh) < self.min_part:
                continue
            split_bits = _pb_code(w, h, self.profile, case)[1]
            c1, t1 = self._plan_ptree(bx, by, sw, sh, pred, nrefs)
            c2, t2 = self._plan_ptree(bx + dpix, by + dmul, sw, sh,
                                      pred, nrefs)
            c = lam * split_bits + c1 + c2
            if c < node[0]:
                node = (c, ("split", case, t1, t2))
        return node

    def _emit_ptree(self, bw: BitWriter, tree, bx, by, w, h, io) -> None:
        """Walk the decided tree in decode order: emit codes and run twin MC
        (which stores each leaf's MV in the cache slot, loc_1147B0)."""
        t = self.twin
        if tree[0] == "leaf":
            _, ref_or_mode, mv = tree
            off = by * self.S + bx
            if ref_or_mode == 0:
                code, nbits = _pb_code(w, h, self.profile, 0)
                bw.write_bits(code, nbits)
                t._mc(w, h, io, 1, mv[0], mv[1], off)
            else:
                ref = ref_or_mode
                code, nbits = _pb_code(w, h, self.profile, ref)
                bw.write_bits(code, nbits)
                pmx = int(np.int32(np.uint32(t.internal[219])))
                pmy = int(np.int32(np.uint32(t.internal[220])))
                bw.write_varint_s(mv[0] - pmx)
                bw.write_varint_s(mv[1] - pmy)
                t._mc(w, h, io, ref, mv[0], mv[1], off)
            return
        _, case, t1, t2 = tree
        code, nbits = _pb_code(w, h, self.profile, case)
        bw.write_bits(code, nbits)
        (sw, sh), dmul, dpix = _PB_SPLIT[(w, h)][case]
        self._emit_ptree(bw, t1, bx, by, sw, sh, io)
        self._emit_ptree(bw, t2, bx + dpix, by + dmul, sw, sh, io)

    def _encode_pframe(self, bw: BitWriter, y, u, v) -> tuple[int, int]:
        t = self.twin
        bw.write_bits(0, 1)
        dq = self.qp - t.quantizer
        bw.write_varint_s(dq)
        if dq != 0:
            t._setup_quant((t.quantizer + dq) & _M32)
        t.internal[218] = 0  # P-frames always use table 0
        nrefs = min(self.frame_idx, 5)
        self._tgt = y  # bound for _plan_ptree leaf SADs
        # device full-search SAD volume over the available references
        refs = []
        for r in range(1, min(nrefs, self.max_refs) + 1):
            pl = t.y_planes[r]
            if pl is None:
                break
            refs.append(pl.reshape(-1, self.S)[:self.h, :self.w])
        self._sadvol = SadVolume(y, refs, range_=self.me_range,
                                 device=self.device) if refs else None
        # MV cache init, mirroring _decode_pframe exactly
        inr = t.internal
        io = 221
        wleft = self.w + 0x20
        while True:
            inr[io] = 0
            inr[io + 1] = 0
            io += 2
            wleft -= 16
            if wleft <= 0:
                break
        n_inter = 0
        n_mbs = 0
        lam = self._lambda
        for mby in range(self.h // 16):
            io = 221
            for mbx in range(self.w // 16):
                vals = [int(np.int32(np.uint32(inr[io + k])))
                        for k in range(6)]
                io += 2
                pmx = sorted((vals[0], vals[2], vals[4]))[1]
                pmy = sorted((vals[1], vals[3], vals[5]))[1]
                inr[219] = pmx & _M32
                inr[220] = pmy & _M32
                inr[io] = 0
                inr[io + 1] = 0
                n_mbs += 1
                py, px = mby * 16, mbx * 16
                cost_inter, tree = self._plan_ptree(px, py, 16, 16,
                                                    (pmx, pmy), nrefs)
                # cheap intra screen: top-left 8x8 best-mode SAD scaled to
                # the MB (full intra evaluation only when competitive)
                ty = self._plane2d(t.y_planes[0])
                cand = self._mode_candidates(mby > 0, mbx > 0, px, 8)
                _, sad_i, _ = self._best_mode(t.y_planes[0],
                                              y[py:py + 8, px:px + 8],
                                              py, px, cand, 8,
                                              allow_plane=False)
                est_intra = sad_i * 4 + lam * 40
                if est_intra < cost_inter:
                    toks = self._plan_intra_mb_rd(mbx, mby, y, u, v,
                                                  in_p=True)
                    self._emit_tokens(bw, toks)
                    continue
                n_inter += 1
                self._emit_ptree(bw, tree, px, py, 16, 16, io)
                # MB residual (loc_1161A0): honest CBP over MC recon
                self._emit_residual_mb(bw, mbx, mby, y, u, v)
        return n_inter, n_mbs

    def _emit_residual_mb(self, bw: BitWriter, mbx, mby, y, u, v) -> None:
        t = self.twin
        S = self.S
        ty = self._plane2d(t.y_planes[0])
        tuv = self._plane2d(t.uv_planes[0])
        py, px = mby * 16, mbx * 16
        plans = []  # (plane, base_off, tokens, [(rel_off, n, levels)...])
        cbp = 0
        for bit, (dy, dx) in enumerate(((0, 0), (0, 8), (8, 0), (8, 8))):
            bpy, bpx = py + dy, px + dx
            resid = y[bpy:bpy + 8, bpx:bpx + 8].astype(np.int64) \
                - ty[bpy:bpy + 8, bpx:bpx + 8].astype(np.int64)
            toks, apply = self._residual8_plan(resid)
            if toks is not None:
                cbp |= 1 << bit
                plans.append((t.y_planes[0], bpy * S + bpx, toks, apply))
        cy, cx = py // 2, px // 2
        for bit, half, src in ((4, 0, u), (5, S // 2, v)):
            resid = src[cy:cy + 8, cx:cx + 8].astype(np.int64) \
                - tuv[cy:cy + 8, cx + half:cx + half + 8].astype(np.int64)
            toks, apply = self._residual8_plan(resid)
            if toks is not None:
                cbp |= 1 << bit
                plans.append((t.uv_planes[0], cy * S + cx + half, toks,
                              apply))
        bw.write_varint_u(_inv_lut(TABLES.cbp_inter, cbp))
        for plane, off, toks, apply in plans:
            self._emit_tokens(bw, toks)
            for doff, n, lv in apply:
                self._apply_levels(plane, off + doff, n, lv)

    def _residual8_plan(self, resid):
        """Plan one coded-8x8 residual (loc_11652C inverse): whole-8x8 DCT
        vs 4x4 quads by bits; returns (tokens | None, apply_list)."""
        S = self.S
        lv8 = self._quant_block(resid, 8)
        t8 = self._coef_tokens(lv8, 8)
        lv4s, t4s, mask = [], [], 0
        for b, (dy, dx) in enumerate(((0, 0), (0, 4), (4, 0), (4, 4))):
            lv4 = self._quant_block(resid[dy:dy + 4, dx:dx + 4], 4)
            tt = self._coef_tokens(lv4, 4)
            lv4s.append(lv4)
            t4s.append(tt)
            if tt:
                mask |= 1 << b
        if t8 is None and mask == 0:
            return None, []
        bits8 = (1 + self._ctb(t8)) if t8 else (1 << 30)
        if mask:
            quad_idx = _inv_lut(TABLES.cbp_sub4, mask, min_idx=1)
            bits4 = varint_u_nbits(quad_idx) \
                + sum(self._ctb(tt) for tt in t4s if tt)
        else:
            bits4 = 1 << 30
        if bits8 <= bits4:
            return [("b", 1, 1)] + t8, [(0, 8, lv8)]
        toks = [("vu", quad_idx)]
        apply = []
        for b, (dy, dx) in enumerate(((0, 0), (0, 4), (4, 0), (4, 4))):
            if (mask >> b) & 1:
                toks += t4s[b]
                apply.append((dy * S + dx, 4, lv4s[b]))
        return toks, apply
