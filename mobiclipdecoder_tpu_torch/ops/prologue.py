"""Device prologue and epilogue of a whole-GOP decode.

Ports of ``_unpack_ops3`` and the unpack part of ``_decode_gop_fused_sblob``
(blob -> ops, coefs, sizes), the ring renormalization and the crops of
``_decode_gop_fused`` / ``_crop_gop_yuv`` in
``mobiclipdecoder_tpu/ops/vmem_engine.py``.

``unpack_residuals_sblob`` is the prologue the decode runs: blob -> (ops,
resid), the executor's inputs.  On a CUDA blob it launches one kernel
(``ops/prologue_kernels.py`` ``prologue_sblob``, K5: the gather of each
block's nonzeros, the row transform and the op widening); on a CPU blob it
runs the plain versions, ``unpack_gop_blob`` and ``ops/residuals.py``
``_residuals``.  The other functions here are plain torch and run on the
device their input lies on.
"""
from __future__ import annotations

import torch

from . import prologue_kernels
from .packing import CHUNK, MCOL, MR, _geom
from .residuals import _residuals


def _unpack_ops3(p3: torch.Tensor) -> torch.Tensor:
    """Inverse of packing._pack_ops3: (..., 3) -> (..., 4) int32.  The
    masks make the arithmetic shifts act as logical ones."""
    a = p3[..., 0]
    b = p3[..., 1]
    w0 = a & 0x03FFFFFF
    w3 = (((a >> 26) & 0x3F) << 8) | ((b >> 24) & 0xFF)
    rr = b & 0xFFF
    cc = (b >> 12) & 0xFFF
    w1 = rr | (cc << 16)
    return torch.stack([w0, w1, p3[..., 2], w3], dim=-1)


def blob_sections(blob: torch.Tensor, B: int, nct: int, nnzb: int) -> tuple:
    """Views of the sparse upload blob's sections: (ops3 (B*nct*CHUNK, 3),
    size-bit words, idx (B, nnzb), v32 (B, nnzb / 2)).  Raises unless the
    blob is a 1-D contiguous int32 tensor that holds them all."""
    nrows = B * nct * CHUNK
    a = nrows * 3
    b = a + (nrows + 31) // 32
    c = b + B * nnzb
    if (blob.dtype != torch.int32 or blob.dim() != 1
            or not blob.is_contiguous() or nnzb % 2 or B < 1 or nct < 1
            or blob.numel() < c + B * nnzb // 2):
        raise ValueError(f"blob {blob.dtype} {tuple(blob.shape)} (contiguous "
                         f"{blob.is_contiguous()}) does not hold the sections "
                         f"of B={B}, nct={nct}, nnzb={nnzb} (nnzb even)")
    return (blob[:a].view(nrows, 3), blob[a:b], blob[b:c].view(B, nnzb),
            blob[c:c + B * nnzb // 2].view(B, nnzb // 2))


def unpack_gop_blob(blob: torch.Tensor, B: int, nct: int,
                    nnzb: int) -> tuple:
    """Sparse upload blob [ops3 | size bits | idx (B, nnzb) | val16 pairs]
    -> (ops (B, nct, CHUNK, 4), coefs (B, nct, CHUNK, 64),
    sizes (B, nct, CHUNK)), all int32 on the blob's device."""
    nrows = B * nct * CHUNK
    rows = nct * CHUNK
    ops3, sbits, idx, v32 = blob_sections(blob, B, nct, nnzb)
    ops = _unpack_ops3(ops3.view(B, nct, CHUNK, 3))
    idx = idx.long()
    # two little-endian int16 values per int32 word
    lo = ((v32 & 0xFFFF) ^ 0x8000) - 0x8000
    hi = v32 >> 16
    val = torch.stack([lo, hi], dim=2).view(B, nnzb)
    # one scatter per stream; padded (and any out-of-range) indices land in
    # a spare slot past the end that is then dropped
    idx = torch.where((idx < 0) | (idx > rows * 64), rows * 64, idx)
    dense = torch.zeros((B, rows * 64 + 1), dtype=torch.int32,
                        device=blob.device)
    dense.scatter_(1, idx, val)
    coefs = dense[:, :rows * 64].reshape(B, nct, CHUNK, 64)
    ar = torch.arange(nrows, device=blob.device)
    bit = (sbits[ar // 32] >> (ar % 32)) & 1
    sizes = torch.where(bit == 1, 4, 8).to(torch.int32).view(B, nct, CHUNK)
    return ops, coefs, sizes


def unpack_residuals_sblob(blob: torch.Tensor, B: int, nct: int,
                           nnzb: int) -> tuple:
    """Sparse upload blob -> (ops (B, nct, CHUNK, 4), resid (B, nct, CHUNK,
    64)) int32 on the blob's device: ``unpack_gop_blob`` followed by
    ``_residuals``.  A CUDA blob takes one launch of K5 (every row of
    ops and resid written once, so both are allocated unfilled), or
    raises; a CPU blob takes the plain versions."""
    ops3, sbits, idx, v32 = blob_sections(blob, B, nct, nnzb)
    if blob.device.type == "cpu":
        ops, coefs, sizes = unpack_gop_blob(blob, B, nct, nnzb)
        resid = _residuals(coefs.reshape(-1, 64), sizes.reshape(-1))
        return ops, resid.view(B, nct, CHUNK, 64)
    if blob.device.type != "cuda":
        raise ValueError(f"no prologue for device {blob.device}")
    resid = torch.empty((B, nct, CHUNK, 64), dtype=torch.int32,
                        device=blob.device)
    ops = torch.empty((B, nct, CHUNK, 4), dtype=torch.int32,
                      device=blob.device)
    prologue_kernels.prologue_sblob(ops3, sbits, idx, v32, ops.view(-1, 4),
                                    resid.view(-1, 64))
    return ops, resid


def renormalize_ring(ring: torch.Tensor, F: int) -> torch.Tensor:
    """Roll the modular ring back to slot 0 = newest: frame F-1 wrote slot
    (5 - (F-1)) mod 6."""
    w_last = (5 - (F - 1)) % 6
    return torch.roll(ring, -w_last, dims=1).contiguous()


def crop_frames(frames: torch.Tensor, H: int, S: int) -> torch.Tensor:
    """(F, B, R, SP) planes -> (F, B, HH, S) without the margins."""
    HH, _G8, _SP = _geom(H, S)
    return frames[:, :, MR:MR + HH, MCOL:MCOL + S]


def crop_gop_yuv(yuv: torch.Tensor, H: int, W: int, S: int) -> torch.Tensor:
    """(..., H+H/2, S) -> (..., H+H/2, W): Y columns [0, W); the packed UV
    rows keep U from [0, W/2) and V from [S/2, S/2+W/2), repacked
    adjacent."""
    y = yuv[..., :H, :W]
    u = yuv[..., H:, :W // 2]
    v = yuv[..., H:, S // 2:S // 2 + W // 2]
    return torch.cat([y, torch.cat([u, v], dim=-1)], dim=-2)
