"""Host-side (numpy) packing of scanned op streams for the whole-GOP executor.

These are copies of the JAX package's numpy helpers in
``mobiclipdecoder_tpu/ops/vmem_engine.py`` (same names, same layouts, same
results): that module imports JAX at its top, and the port must run where
JAX is absent.  ``tests/test_torch_packing.py`` holds each copy equal to its
original.

Layouts (shared with the C++ scanner, native/scanner.cpp):

* an op row is ``[w0, w1 = rr | cc << 16, w2, w3]`` (models/plan.py
  ``pack_unified``); the executor reads op rows in 256-row chunks whose
  header row is ``[count, frame, first, last]``;
* ``w3`` indexes the chunk's own 256 coefficient rows;
* the upload blob is ``[ops3 | size bits | idx (B, nnzb) | val16 pairs]``.
"""
from __future__ import annotations

import numpy as np

from ..models.plan import OP_INTRA, OP_MC, OP_RESID

MR = 8       # top margin rows (taps at row -1 read zeros, like fresh planes)
MCOL = 8     # left margin columns
CHUNK = 256  # op rows per chunk, header row included
# Whole-GOP chunk buckets: chunks per stream per GOP.
NCT_BUCKETS = (16, 64, 76, 88, 112, 136, 160, 256, 512, 1024)
# Per-stream nonzero-coefficient buckets of the sparse upload.
NNZ_PS_BUCKETS = (16384, 65536, 131072, 262144)


def _geom(height: int, stride: int) -> tuple[int, int, int]:
    hh = height + height // 2
    hhp = hh + 32            # 8 top margin + >=17 bottom slack, 8-aligned
    return hh, hhp // 8, stride + 128     # (HH, G8, SP)


def _bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"size {n} exceeds largest bucket {buckets[-1]}")


def _op_nrows(w0: int) -> int:
    """Coefficient rows referenced by one op row: plain resid/intra-with-
    coef reference one; a fused MC references popcount of its residual
    mask (w0 bits 3..8); batched residuals (size_log 4 masked-16x16 /
    size_log 5 U+V pair) popcount of their masks (w0 bits 5..)."""
    typ = w0 & 3
    if typ == OP_RESID:
        sl = (w0 >> 2) & 7
        if sl == 4:
            return bin((w0 >> 5) & 0xF).count("1")
        if sl == 5:
            return bin((w0 >> 5) & 0x3).count("1")
        return 1
    if typ == OP_INTRA:
        sl = (w0 >> 2) & 7
        if sl in (5, 6):                       # luma quad batch
            return bin((w0 >> 21) & 0xF).count("1")
        if sl == 7:                            # chroma U+V pair
            return bin((w0 >> 10) & 0x3).count("1")
        return (w0 >> 10) & 1
    if typ == OP_MC:
        return bin((w0 >> 3) & 0x3F).count("1")
    return 0


def _frame_chunk_spans(rows: np.ndarray) -> list[tuple[int, int]]:
    """Greedy chunk partition of one frame's op rows: a chunk holds at most
    CHUNK-1 op rows AND at most CHUNK coefficient rows (fused MC ops carry
    up to 6 rows each, so the coefficient block can fill first).  The C++
    scanner's chunk-close rule (native/scanner.cpp) splits identically."""
    n = rows.shape[0]
    spans = []
    i = 0
    cap = CHUNK - 1
    while i < n or not spans:
        j = i
        crow = 0
        while j < n and (j - i) < cap:
            nr = _op_nrows(int(rows[j, 0]))
            if crow + nr > CHUNK:
                break
            crow += nr
            j += 1
        spans.append((i, j))
        i = j
        if i >= n:
            break
    return spans


def _pack_gop_chunks(plans_fb: list[list[dict]], B: int) -> tuple:
    """Pack per-frame scan plans into the packed-chunk-stream GOP layout.

    plans_fb[f][b] = scan_unified dict.  Returns (ops (B, NCT, CHUNK, 4),
    coefs (B, NCT, CHUNK, 64), sizes (B, NCT, CHUNK)).  Chunk headers
    carry [count, frame_idx, first_flag, last_flag]; chunk spans follow
    _frame_chunk_spans.  Coefficient rows are re-partitioned per chunk
    (w3 references become chunk-local)."""
    F = len(plans_fb)
    spans_fb = [[_frame_chunk_spans(
        plans_fb[f][b]["ops"][1:1 + int(plans_fb[f][b]["ops"][0, 0])])
        for f in range(F)] for b in range(B)]
    nct = _bucket(max(sum(len(s) for s in spans_fb[b]) for b in range(B)),
                  NCT_BUCKETS)
    ops = np.zeros((B, nct, CHUNK, 4), np.int32)
    coefs = np.zeros((B, nct, CHUNK, 64), np.int32)
    sizes = np.full((B, nct, CHUNK), 8, np.int32)
    for b in range(B):
        k = 0
        for f in range(F):
            p = plans_fb[f][b]
            n = int(p["ops"][0, 0])
            rows = p["ops"][1:1 + n]
            spans = spans_fb[b][f]
            for c, (i0, i1) in enumerate(spans):
                m = i1 - i0
                dst = ops[b, k, 1:1 + m]
                dst[:] = rows[i0:i1]
                crow = 0
                for r in range(m):
                    nr = _op_nrows(int(dst[r, 0]))
                    if nr:
                        w3 = int(dst[r, 3])
                        coefs[b, k, crow:crow + nr] = \
                            p["coefs"][w3:w3 + nr]
                        sizes[b, k, crow:crow + nr] = \
                            p["sizes"][w3:w3 + nr]
                        dst[r, 3] = crow
                        crow += nr
                    else:
                        dst[r, 3] = 0
                ops[b, k, 0] = (m, f,
                                1 if c == 0 else 0,
                                1 if c == len(spans) - 1 else 0)
                k += 1
    return ops, coefs, sizes


def _gop_part(r: dict) -> dict:
    """Normalize a NativePlanner.scan_gop_packed result into a sliceable
    'part': a frame range over the scan's packed chunk stream.  Parts are
    cheap views into the scan buffers; slicing at frame boundaries (see
    _split_gop_part) re-bases frame ids and coefficient indices at assembly
    time, so oversized GOPs split WITHOUT rescanning."""
    return dict(ops3=r["ops3"], szw=r["szw"],
                idx=r["idx"][:r["nnz"]], val=r["val"][:r["nnz"]],
                fnct=r["frame_nct"], fnnz=r["frame_nnz"],
                c0=0, c1=r["nct"], fbase=0)


def _split_gop_part(q: dict, f0: int, f1: int) -> dict:
    """Sub-part covering the part's local frames [f0, f1)."""
    cn = np.concatenate([[0], np.cumsum(q["fnct"])]).astype(np.int64)
    zn = np.concatenate([[0], np.cumsum(q["fnnz"])]).astype(np.int64)
    return dict(ops3=q["ops3"], szw=q["szw"],
                idx=q["idx"][zn[f0]:zn[f1]], val=q["val"][zn[f0]:zn[f1]],
                fnct=q["fnct"][f0:f1], fnnz=q["fnnz"][f0:f1],
                c0=q["c0"] + int(cn[f0]), c1=q["c0"] + int(cn[f1]),
                fbase=q["fbase"] + f0)


def _part_dense_arrays(parts: list[dict]) -> tuple:
    """Host-side dense reconstruction of per-stream parts: the fallback
    when a SINGLE frame's sparse footprint exceeds the nnz bucket ladder.
    Returns (ops4 (B,nct,CHUNK,4), coefs, sizes)."""
    B = len(parts)
    nct = _bucket(max(q["c1"] - q["c0"] for q in parts), NCT_BUCKETS)
    ops = np.zeros((B, nct, CHUNK, 4), np.int32)
    coefs = np.zeros((B, nct * CHUNK, 64), np.int32)
    sizes = np.full((B, nct * CHUNK), 8, np.int32)
    for b, q in enumerate(parts):
        c0, c1 = q["c0"], q["c1"]
        n = c1 - c0
        p3 = np.ascontiguousarray(q["ops3"][c0:c1]).view(np.uint32)
        a, bw = p3[..., 0], p3[..., 1]
        w0 = a & np.uint32(0x03FFFFFF)
        w3 = (((a >> np.uint32(26)) & np.uint32(0x3F)) << np.uint32(8)) \
            | ((bw >> np.uint32(24)) & np.uint32(0xFF))
        w1 = (bw & np.uint32(0xFFF)) | (((bw >> np.uint32(12))
                                         & np.uint32(0xFFF))
                                        << np.uint32(16))
        o4 = np.stack([w0, w1, p3[..., 2], w3],
                      axis=-1).view(np.int32)
        ops[b, :n] = o4
        if q["fbase"]:
            ops[b, :n, 0, 1] -= q["fbase"]
        idx = q["idx"] - c0 * CHUNK * 64
        coefs[b].reshape(-1)[idx] = q["val"].astype(np.int32)
        spc = CHUNK // 32
        bits = np.unpackbits(
            q["szw"][c0 * spc:c1 * spc].view(np.uint8), bitorder="little")
        sizes[b, :n * CHUNK][bits[:n * CHUNK] == 1] = 4
    return ops, coefs.reshape(B, nct, CHUNK, 64), sizes


def _assemble_gop_parts(parts: list[dict]) -> tuple:
    """Assemble B per-stream parts into the sparse upload blob (identical
    layout to _pack_gop_chunks + _pack_gop_blob_sparse).  Caller guarantees
    every part fits the bucket ladders.  Returns (blob, nct, nnzb)."""
    B = len(parts)
    nct = _bucket(max(q["c1"] - q["c0"] for q in parts), NCT_BUCKETS)
    nnzb = _bucket(max(max(q["idx"].size for q in parts), 2),
                   NNZ_PS_BUCKETS)
    rows = nct * CHUNK
    spc = CHUNK // 32                      # size-bit words per chunk
    ops3 = np.zeros((B, nct, CHUNK, 3), np.int32)
    swords = np.zeros((B, nct * spc), np.int32)
    idx = np.full((B, nnzb), rows * 64, np.int32)
    val = np.zeros((B, nnzb), np.int16)
    for b, q in enumerate(parts):
        c0, c1 = q["c0"], q["c1"]
        n = c1 - c0
        ops3[b, :n] = q["ops3"][c0:c1]
        if q["fbase"]:
            # chunk header word B carries the frame id in its low 12 bits
            ops3[b, :n, 0, 1] -= q["fbase"]
        swords[b, :n * spc] = q["szw"][c0 * spc:c1 * spc]
        k = q["idx"].size
        idx[b, :k] = q["idx"]
        if c0:
            idx[b, :k] -= c0 * CHUNK * 64
        val[b, :k] = q["val"]
    val_words = val.reshape(-1).astype('<i2').view('<i4').astype(np.int32)
    blob = np.concatenate([ops3.reshape(-1), swords.reshape(-1),
                           idx.reshape(-1), val_words])
    return blob, nct, nnzb


def _pack_gop_blob_sparse(ops, coefs, sizes):
    """Host-side sparse pack for the fused whole-GOP path, or None when
    the GOP must take the dense path.  Coefficient indices are PER STREAM
    (local to stream b's (nct*CHUNK, 64) rows, padded to a common
    per-stream bucket).

    Blob (int32): [ops3 | size_bits | idx (B, nnzb) | val16 (B, nnzb/2)].
    """
    B = sizes.shape[0]
    rows = coefs.reshape(B, -1, 64).shape[1]
    if rows * 64 > (1 << 31) - 1:
        return None
    per = []
    for b in range(B):
        fb = coefs[b].reshape(-1)
        idx = np.flatnonzero(fb)
        val = fb[idx]
        if val.size and (int(val.min()) < -32768 or int(val.max()) > 32767):
            return None
        per.append((idx, val))
    nnz_max = max(max((int(i.size) for i, _ in per), default=0), 2)
    if nnz_max > NNZ_PS_BUCKETS[-1]:
        return None
    ops3 = _pack_ops3(ops)
    if ops3 is None:
        return None
    nnzb = _bucket(nnz_max, NNZ_PS_BUCKETS)
    idx_a = np.full((B, nnzb), rows * 64, np.int32)
    val_a = np.zeros((B, nnzb), np.int16)
    for b, (idx, val) in enumerate(per):
        idx_a[b, :idx.size] = idx
        val_a[b, :idx.size] = val.astype(np.int16)
    nsb = (B * rows + 31) // 32
    sbits = np.zeros(nsb * 32, np.uint32)
    sbits[:B * rows] = (sizes.reshape(-1) == 4)
    swords = (sbits.reshape(-1, 32)
              << np.arange(32, dtype=np.uint32)).sum(
                  axis=1, dtype=np.uint32).view(np.int32)
    val_words = val_a.reshape(-1).astype('<i2').view('<i4').astype(np.int32)
    blob = np.concatenate([ops3.ravel(), swords, idx_a.ravel(), val_words])
    return blob, nnzb


def _pack_ops3(ops: np.ndarray):
    """Pack (..., 4) int32 op rows into (..., 3) for upload, or None when a
    field exceeds its packed width (caller falls back to the 4-word form).

    Packed: A = w0 | (w3>>8)<<26;  B = rr | cc<<12 | (w3&0xFF)<<24;  C = w2.
    Chunk header rows [count, frame, first, last] round-trip too.
    """
    u = np.ascontiguousarray(ops).view(np.uint32)
    w0, w1, w3 = u[..., 0], u[..., 1], u[..., 3]
    rr = w1 & np.uint32(0xFFFF)
    cc = w1 >> np.uint32(16)
    # negative fields view as huge unsigned values, so the max-checks also
    # reject them
    if int(w0.max(initial=0)) >= 1 << 26:
        return None
    if int(rr.max(initial=0)) >= 1 << 12 or int(cc.max(initial=0)) >= 1 << 12:
        return None
    if int(w3.max(initial=0)) >= 1 << 14:
        return None
    packed = np.empty(ops.shape[:-1] + (3,), np.uint32)
    packed[..., 0] = w0 | (w3 >> np.uint32(8)) << np.uint32(26)
    packed[..., 1] = (rr | cc << np.uint32(12)
                      | (w3 & np.uint32(0xFF)) << np.uint32(24))
    packed[..., 2] = u[..., 2]
    return packed.view(np.int32)
