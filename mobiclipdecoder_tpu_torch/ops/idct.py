"""Batched integer IDCTs (plain torch, int32-exact).

Port of ``mobiclipdecoder_tpu/ops/idct.py``.  The reference's sparse IDCT
variants (MobiclipDecoder.cs:3435-3798) are the full shift-add butterfly
restricted to their coefficient support, so only the full 8x8 and 4x4
transforms are needed.  The butterflies are the IDCT pre-pass's
(ops/residuals.py); all arithmetic is int32, and ``>>`` on int32 tensors
is arithmetic, as in C#.
"""
from __future__ import annotations

import torch

from .residuals import _btf4_ax0, _btf8_ax0


def _along_last(btf, c: torch.Tensor) -> torch.Tensor:
    """A pre-pass butterfly (which runs along axis 0) along the last axis."""
    return torch.movedim(btf(torch.movedim(c, -1, 0)), 0, -1)


def _idct(btf, coefs: torch.Tensor) -> torch.Tensor:
    """+32 DC rounding, a butterfly pass over coefficient rows, transpose,
    a second pass, >> 6, on (..., n, n) int32."""
    c = coefs.to(torch.int32).clone()
    c[..., 0, 0] += 32
    t = _along_last(btf, c)
    return _along_last(btf, t.transpose(-1, -2)) >> 6


def idct8(coefs: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) int32 coefficients -> (..., 8, 8) int32 residual
    (IDCT64Px8's dataflow, MobiclipDecoder.cs:3435-3561)."""
    return _idct(_btf8_ax0, coefs)


def idct4(coefs: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) int32 coefficients -> (..., 4, 4) int32 residual
    (IDCT16Px4, MobiclipDecoder.cs:3728-3784)."""
    return _idct(_btf4_ax0, coefs)
