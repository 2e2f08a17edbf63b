"""IDCT pre-pass: coefficient rows -> spatial residual rows.

Port of ``_btf8_ax0`` / ``_btf4_ax0`` / ``_residuals`` in
``mobiclipdecoder_tpu/ops/vmem_engine.py``, which the JAX package runs as
XLA code outside its Pallas kernel.  ``residuals`` is the pre-pass the
decode runs: on CUDA tensors it launches the row-transform kernel
(``ops/prologue_kernels.py`` ``residual_rows``, csrc/prologue.cu) or
raises; on CPU tensors it runs ``_residuals``, the plain int32 tensor
version, which runs on whatever device its input lies on.  Integer shifts
on int32 tensors are arithmetic, as in the reference (MobiclipDecoder.cs
:3450-3505 and :3728-3784).
"""
from __future__ import annotations

import torch

from . import prologue_kernels


def _btf8_ax0(c: torch.Tensor) -> torch.Tensor:
    """8-point butterfly along axis 0 of (8, ..., N) int32."""
    r0, r1, r2, r3, r4, r5, r6, r7 = (c[k] for k in range(8))
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
    return torch.stack([e0 + f7, e2 + f5, e4 + f3, e6 + f1,
                        e6 - f1, e4 - f3, e2 - f5, e0 - f7], dim=0)


def _btf4_ax0(c: torch.Tensor) -> torch.Tensor:
    """4-point butterfly along axis 0 (IDCT16Px4)."""
    r0, r1, r2, r3 = (c[k] for k in range(4))
    e0 = r0 + r2
    e1 = r0 - r2
    o1 = (r1 >> 1) - r3
    o0 = r1 + (r3 >> 1)
    return torch.stack([e0 + o0, e1 + o1, e1 - o1, e0 - o0], dim=0)


def _residuals(flat: torch.Tensor, sizes_flat: torch.Tensor) -> torch.Tensor:
    """(N, 64) int32 coefficient rows + (N,) sizes in {4, 8} -> (N, 64)
    int32 rows whose (8, 8) row-major view is the spatial residual.

    Size-8 rows hold one 8x8 block.  Size-4 rows hold up to four 4x4
    blocks in quadrant slots [q0|q1|q2|q3]; each quad gets the +32 DC
    rounding, and each quad's output keeps idct4's transposed orientation
    ([transformed_coef, transformed_row])."""
    N = flat.shape[0]
    xT = flat.to(torch.int32).t()                     # (64, N)
    # 8x8: (8r, 8c, N); butterfly over coef columns, then rows, >> 6
    c8 = xT.reshape(8, 8, N).clone()
    c8[0, 0] += 32
    t8 = _btf8_ax0(c8.transpose(0, 1))
    d8 = _btf8_ax0(t8.transpose(0, 1))
    r8 = d8.transpose(0, 1) >> 6                      # (8r, 8c, N)
    # 4x4 quads: (4q, 4r, 4c, N); +32 on every quad's [0, 0]
    c4 = xT.reshape(4, 4, 4, N).clone()
    c4[:, 0, 0] += 32
    tq = _btf4_ax0(torch.movedim(c4, 2, 0))           # (4oc, 4q, 4r, N)
    dq = _btf4_ax0(torch.movedim(tq, 2, 0))           # (4or, 4oc, 4q, N)
    rq4 = torch.movedim(dq, 2, 0).transpose(1, 2) >> 6   # (q, oc, or, N)
    # spatial row = (q >> 1) * 4 + out_c, col = (q & 1) * 4 + out_r
    rq = rq4.reshape(2, 2, 4, 4, N).permute(0, 2, 1, 3, 4).reshape(8, 8, N)
    resid = torch.where((sizes_flat == 4)[None, None, :], rq, r8)
    return resid.permute(2, 0, 1).reshape(N, 64).contiguous()


def residuals(coefs: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """coefs (..., 64) int32 and sizes int32 in {4, 8}, one per row of
    coefs in any shape ((B, nct, CHUNK) or (B, nct * CHUNK)), contiguous
    and on one device -> resid of coefs' shape: ``_residuals`` of the
    rows.  CUDA tensors take the kernel, or the call raises; CPU tensors
    take the plain version."""
    for name, t in (("coefs", coefs), ("sizes", sizes)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous int32 tensor, "
                             f"got {t.dtype} (contiguous "
                             f"{t.is_contiguous()})")
    if (coefs.dim() < 1 or coefs.shape[-1] != 64
            or sizes.numel() * 64 != coefs.numel()):
        raise ValueError(f"coefs {tuple(coefs.shape)}, sizes "
                         f"{tuple(sizes.shape)}: expected (..., 64) and one "
                         f"size per row")
    if sizes.device != coefs.device:
        raise ValueError(f"sizes on {sizes.device}, coefs on {coefs.device}")
    flat, sizes_flat = coefs.view(-1, 64), sizes.view(-1)
    if coefs.device.type == "cpu":
        return _residuals(flat, sizes_flat).view(coefs.shape)
    if coefs.device.type != "cuda":
        raise ValueError(f"no IDCT pre-pass for device {coefs.device}")
    resid = torch.empty_like(coefs)
    prologue_kernels.residual_rows(flat, sizes_flat, resid.view(-1, 64))
    return resid
