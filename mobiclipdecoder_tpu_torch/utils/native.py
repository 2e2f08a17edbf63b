"""ctypes bridge to the native C++ scanner/planner (native/scanner.cpp).

Builds the repository's native/scanner.cpp with g++ on first use into
this package's git-ignored csrc/build/ (utils/build.py), packs the codec tables into the blob layout the C++ side expects, and wraps
scans into FramePlan objects identical to the Python planner's output.

A copy of the JAX package's ``utils/native.py`` apart from the build
directory and the row caps of ``scan``'s outputs: the JAX package's are a
fixed 8,192 rows, which a 640x480 I-frame's intra ops overflow (the scan
then fails); here they grow with the frame to bounds no frame can pass.
"""
from __future__ import annotations

import ctypes
import struct
import time
from pathlib import Path

import numpy as np

from ..models.plan import FramePlan
from ..tables import TABLES
from . import build

# the scanner's source is the repository's, shared by both packages
_SRC = Path(__file__).resolve().parents[2] / "native" / "scanner.cpp"

_SIZES = [(16, 16), (8, 16), (4, 16), (2, 16), (16, 8), (16, 4), (16, 2),
          (8, 8), (8, 4), (8, 2), (4, 8), (4, 4), (4, 2), (2, 8), (2, 4),
          (2, 2)]


def _arr(a) -> bytes:
    a = np.asarray(a, dtype=np.int32).ravel()
    return struct.pack("<i", len(a)) + a.tobytes()


def _tables_blob() -> bytes:
    t = TABLES
    parts = [
        _arr(t.coef_vlc0_a), _arr(t.coef_vlc0_b),
        _arr(t.coef_vlc1_a), _arr(t.coef_vlc1_b),
        _arr(t.scan_to_raster8), _arr(t.scan_to_raster4),
        _arr(t.qscale8), _arr(t.qscale4),
        _arr(t.qp_div6), _arr(t.qp_mod6),
        _arr(t.cbp_intra), _arr(t.cbp_inter),
        _arr(t.cbp_split8), _arr(t.cbp_sub4),
    ]
    for (w, h) in _SIZES:
        for prof in ("moflex", "mods"):
            parts.append(_arr([int(t[f"pb{w}x{h}_peek_{prof}"])]))
            parts.append(_arr(t[f"pb{w}x{h}_mode_{prof}"]))
            parts.append(_arr(t[f"pb{w}x{h}_bits_{prof}"]))
    return b"".join(parts)


_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = build.load("mobiscan", [_SRC], "g++", "host")
    lib.scanner_create.restype = ctypes.c_void_p
    lib.scanner_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_char_p, ctypes.c_int]
    lib.scanner_destroy.argtypes = [ctypes.c_void_p]
    lib.scanner_scan.restype = ctypes.c_int
    lib.scanner_scan.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.scanner_scan_unified.restype = ctypes.c_int
    lib.scanner_scan_unified.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p]
    lib.scanner_checkpoint.argtypes = [ctypes.c_void_p]
    lib.scanner_rollback.argtypes = [ctypes.c_void_p]
    lib.scanner_scan_gop.restype = ctypes.c_int
    lib.scanner_scan_gop.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    _lib = lib
    return lib


class NativePlanner:
    """Drop-in for PlanningDecoder's scan+plan (decode_frame() + plan()),
    ~20x faster.  Holds the persistent cross-frame state (quantizer, intra
    mode cache, MV cache) inside the C++ context."""

    MC_CAP = 8192
    RES_CAP = 8192
    INTRA_CAP = 8192

    def __init__(self, width: int, height: int, version: int):
        self.width, self.height = int(width), int(height)
        self.version = int(version)
        if width <= 256:
            self.stride = 256
        elif width <= 512:
            self.stride = 512
        else:
            self.stride = 1024
        # scan()'s row caps: a luma MC leaf covers at least 2x2 pixels, a
        # residual or intra op at least 4x4 of the Y+UV plane (twice that
        # allows for pass-through ops over written blocks)
        blocks = (self.height + self.height // 2) * self.stride // 16
        self.mc_cap = max(self.MC_CAP, self.height * self.stride // 4)
        self.res_cap = max(self.RES_CAP, 2 * blocks)
        self.intra_cap = max(self.INTRA_CAP, 2 * blocks)
        blob = _tables_blob()
        self._lib = _load()
        self._ctx = self._lib.scanner_create(
            self.width, self.height, self.version, blob, len(blob))
        self.offset = 0

    def __del__(self):
        try:
            if getattr(self, "_ctx", None):
                self._lib.scanner_destroy(self._ctx)
        except Exception:
            pass

    UOPS_CAP = 16384
    UCOEF_CAP = 16384

    def scan_unified(self, packet: bytes) -> dict:
        """Unified decode-order op stream (models/plan.py pack_unified
        layout) for the VMEM engine; bit-identical to
        PlanningDecoder.unified_plan()."""
        # np.empty is safe: the C++ side fully writes every op row it emits
        # and memsets each used coefficient row (scanner.cpp emit paths);
        # only [:n] / [:k] are read back.
        uops = np.empty((self.UOPS_CAP, 4), np.int32)
        ucoef = np.empty((self.UCOEF_CAP, 64), np.int32)
        usize = np.empty(self.UCOEF_CAP, np.int32)
        meta = np.zeros(3, np.int32)

        def p(a):
            return a.ctypes.data_as(ctypes.c_void_p)

        consumed = self._lib.scanner_scan_unified(
            self._ctx, packet, len(packet),
            p(uops), self.UOPS_CAP, p(ucoef), p(usize), self.UCOEF_CAP,
            p(meta))
        if consumed < 0 or meta[2]:
            raise ValueError("native unified scan failed")
        self.offset = int(consumed)
        n, k = int(meta[0]), int(meta[1])
        ops = np.zeros((n + 1, 4), np.int32)
        ops[0, 0] = n
        ops[1:] = uops[:n]
        if k == 0:
            # no coefficient rows: mirror pack_unified's zero placeholder
            # (the buffers are np.empty — row 0 would be garbage)
            ucoef[0] = 0
            usize[0] = 0
            k = 1
        return dict(ops=ops, coefs=ucoef[:k].copy(),
                    sizes=usize[:k].copy())

    def checkpoint(self) -> None:
        """Snapshot the cross-frame decoder state inside the C++ context
        (see rollback)."""
        self._lib.scanner_checkpoint(self._ctx)

    def rollback(self) -> None:
        """Rewind to the last checkpoint() — undoes any scans since, so the
        same packets can be re-scanned through a different path."""
        self._lib.scanner_rollback(self._ctx)

    # Whole-GOP packed scan caps (one call's output buffers).  GOP_NCT_CAP
    # is deliberately larger than the dispatch bucket ladder's top —
    # oversized GOPs are split at frame boundaries AFTER scanning (the
    # per-frame counts make that a pure slicing operation), never rescanned.
    GOP_NCT_CAP = 4096          # 256-row op chunks  (12 MiB buffer)
    GOP_NNZ_CAP = 1 << 20       # sparse coefficient entries (6 MiB)

    def scan_gop_packed(self, packets: list[bytes]) -> dict:
        """Scan consecutive frame packets of ONE stream into the fused-GOP
        sparse upload layout (ops/vmem_engine.py _pack_gop_chunks +
        _pack_gop_blob_sparse equivalents), entirely in C++.

        Returns a dict with:
          ops3  (nct, 256, 3) int32   packed op chunks (prefix [:nct] valid)
          szw   (nct*8,) int32        size==4 bitmask words
          idx   (nnz,) int32          ascending flat coef indices
          val   (nnz,) int16          coef values
          frame_nct / frame_nnz (done,) int32   per-frame footprints
          consumed (done,) int32      per-frame bitstream end offsets
          done  int                   frames scanned
          err   bool                  frame ``done`` was malformed
          val_overflow bool           a |coef| > int16 was clipped (caller
                                      must fall back to a dense path)
          seconds float               this call's own time, in its thread
          native_seconds float        the part of it in scanner_scan_gop
        done < len(packets) with err=False means an output cap was hit;
        call again with packets[done:] (state rewound to the frame edge).
        """
        t0 = time.perf_counter()
        n = len(packets)
        if n >= 4096:
            raise ValueError("GOP too long for 12-bit frame ids")
        data = b"".join(packets)
        offs = np.zeros(n + 1, np.int32)
        offs[1:] = np.cumsum([len(pk) for pk in packets])
        # fresh output buffers per call — np.empty is lazy (pages are
        # only touched as written), and returning views into REUSED
        # buffers would alias consecutive scans' results (callers may
        # hold a result across a later scan, e.g. split-compare flows)
        ops3 = np.empty((self.GOP_NCT_CAP, 256, 3), np.int32)
        szw = np.empty(self.GOP_NCT_CAP * 8, np.int32)
        idx = np.empty(self.GOP_NNZ_CAP, np.int32)
        val = np.empty(self.GOP_NNZ_CAP, np.int16)
        consumed = np.zeros(n, np.int32)
        frame_nct = np.zeros(n, np.int32)
        frame_nnz = np.zeros(n, np.int32)
        meta = np.zeros(5, np.int32)

        def p(a):
            return a.ctypes.data_as(ctypes.c_void_p)

        t1 = time.perf_counter()
        self._lib.scanner_scan_gop(
            self._ctx, data, p(offs), n,
            p(ops3), self.GOP_NCT_CAP,
            p(idx), p(val), self.GOP_NNZ_CAP,
            p(szw), p(consumed), p(frame_nct), p(frame_nnz), p(meta))
        t2 = time.perf_counter()
        nct, nnz, done, err, vov = (int(meta[k]) for k in range(5))
        if done:
            self.offset = int(consumed[done - 1])
        return dict(ops3=ops3, nct=nct, szw=szw, idx=idx, val=val, nnz=nnz,
                    frame_nct=frame_nct[:done], frame_nnz=frame_nnz[:done],
                    consumed=consumed[:done], done=done, err=bool(err),
                    val_overflow=bool(vov), native_seconds=t2 - t1,
                    seconds=time.perf_counter() - t0)

    def scan(self, packet: bytes) -> FramePlan:
        H, S = self.height, self.stride
        mc = np.zeros((self.mc_cap, 7), np.int32)
        resid = np.zeros((self.res_cap, 4), np.int32)
        resid_coef = np.zeros((self.res_cap, 64), np.int32)
        intra = np.zeros((self.intra_cap, 11), np.int32)
        intra_coef = np.zeros((self.intra_cap, 64), np.int32)
        seq_y = np.zeros((H // 4, S // 4), np.int32)
        seq_uv = np.zeros((H // 8, S // 4), np.int32)
        meta = np.zeros(5, np.int32)

        def p(a):
            return a.ctypes.data_as(ctypes.c_void_p)

        consumed = self._lib.scanner_scan(
            self._ctx, packet, len(packet),
            p(mc), self.mc_cap,
            p(resid), p(resid_coef), self.res_cap,
            p(intra), p(intra_coef), self.intra_cap,
            p(seq_y), p(seq_uv), p(meta))
        if consumed < 0 or meta[4]:
            raise ValueError("native scan failed (malformed stream or "
                             "capacity overflow)")
        self.offset = int(consumed)
        nm, nr, ni, nl = (int(meta[k]) for k in range(4))
        return FramePlan(
            width=self.width, height=H, stride=S,
            mc=mc[:nm].astype(np.int64),
            resid=resid[:nr].astype(np.int64),
            resid_coef=resid_coef[:nr],
            intra=intra[:ni].astype(np.int64),
            intra_coef=intra_coef[:ni],
            seq_y=seq_y.astype(np.int64), seq_uv=seq_uv.astype(np.int64),
            n_levels=nl)
