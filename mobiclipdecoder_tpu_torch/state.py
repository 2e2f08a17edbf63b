"""State carried across GOPs, and the constant tables the executor reads.

The reference ring is the decoder's carried state: the 6 most recent
decoded frames of every stream, slot 0 the newest between dispatches.  The
JAX package keeps it as ``(B, 6, G8, 8, SP)`` int32 (ops/vmem_engine.py,
``VmemBatchDecoder.__init__``); the port keeps the same pixels as
``(B, 6, G8 * 8, SP)`` uint8, since every stored value is a clipped pixel.
Only the unpacked ring layout of strides <= 256 exists in the port.
"""
from __future__ import annotations

import numpy as np
import torch

from .shared.ops.intra_tables import KIND, TAPS

from .ops.packing import _geom


def ring_shape(batch: int, height: int, stride: int) -> tuple:
    _hh, G8, SP = _geom(height, stride)
    return (batch, 6, G8 * 8, SP)


def ring_from_jax(np_ring: np.ndarray, height: int,
                  stride: int) -> torch.Tensor:
    """JAX ring (B, 6, G8, 8, SPX) int32 -> port ring (B, 6, G8*8, SP)
    uint8 on the CPU.  Raises for the byte-packed layout (SPX != SP), which only
    strides above 256 use."""
    _hh, G8, SP = _geom(height, stride)
    a = np.asarray(np_ring)
    if a.ndim != 5 or a.shape[1:4] != (6, G8, 8) or a.shape[4] != SP:
        raise NotImplementedError(
            f"ring layout {a.shape} is not the unpacked (B, 6, {G8}, 8, "
            f"{SP}) layout")
    if a.size and (a.min() < 0 or a.max() > 255):
        raise ValueError("ring holds values outside 0..255")
    out = a.astype(np.uint8).reshape(a.shape[0], 6, G8 * 8, SP)
    return torch.from_numpy(np.ascontiguousarray(out))


def ring_to_jax(ring: torch.Tensor, height: int, stride: int) -> np.ndarray:
    """Port ring -> JAX ring (B, 6, G8, 8, SP) int32 (host numpy)."""
    _hh, G8, SP = _geom(height, stride)
    a = ring.detach().cpu().numpy().astype(np.int32)
    return a.reshape(a.shape[0], 6, G8, 8, SP)


_TABLES: dict[str, torch.Tensor] = {}


def kernel_tables(device) -> torch.Tensor:
    """(20, 256, 4) uint8 [kind, tap0, tap1, tap2] per (mode, pixel r*16+c)
    from ops/intra_tables.py, on ``device`` (cached per device)."""
    key = str(torch.device(device))
    t = _TABLES.get(key)
    if t is None:
        tab = np.zeros((20, 256, 4), np.uint8)
        tab[..., 0] = KIND
        tab[..., 1:] = TAPS
        t = torch.from_numpy(tab).to(device)
        _TABLES[key] = t
    return t
