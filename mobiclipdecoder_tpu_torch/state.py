"""State carried across GOPs, and the constant tables the executor reads.

The reference ring is the decoder's carried state: the 6 most recent
decoded frames of every stream, slot 0 the newest between dispatches.  The
port keeps it as ``(B, 6, G8 * 8, SP)`` uint8 at every stride, since every
stored value is a clipped pixel.  The JAX package keeps the same pixels in
one of the layouts its ``_ring_mode`` picks (ops/vmem_engine.py):

* modes 1 and 0: ``(B, 6, G8, 8, SP)`` int32, one pixel per word;
* mode 2 (the Wii 640x480 size): ``(B, 6, G8, 8, SPX)`` int32, four pixels
  per little-endian word, ``SPX = ceil(SP / 4 / 128) * 128`` words of
  which the ones past ``SP / 4`` are zero padding.

``ring_from_jax`` and ``ring_to_jax`` move a ring between the two packages
in any of these layouts, so a stream decoded so far by one continues
exactly in the other.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.intra_tables import KIND, TAPS
from .ops.packing import _geom
from .utils.device import indexed


def ring_shape(batch: int, height: int, stride: int) -> tuple:
    _hh, G8, SP = _geom(height, stride)
    return (batch, 6, G8 * 8, SP)


def packed_words(height: int, stride: int) -> int:
    """SPX: the stored word width of the JAX package's byte-packed ring
    (its ``_ring_spx`` in mode 2)."""
    _hh, _G8, SP = _geom(height, stride)
    return -(-(SP // 4) // 128) * 128


def ring_from_jax(np_ring: np.ndarray, height: int,
                  stride: int) -> torch.Tensor:
    """JAX ring -> port ring (B, 6, G8*8, SP) uint8 on the CPU.

    Takes the unpacked layout (B, 6, G8, 8, SP) of modes 1 and 0 and the
    byte-packed layout (B, 6, G8, 8, SPX) of mode 2; the last axis tells
    them apart (SPX < SP at every stride).  Packed words are unpacked as
    little-endian bytes after their pad words are dropped, as the JAX
    ``ring_frame_np`` does."""
    _hh, G8, SP = _geom(height, stride)
    a = np.asarray(np_ring)
    spx = packed_words(height, stride)
    if a.ndim != 5 or a.shape[1:4] != (6, G8, 8) or a.shape[4] not in (SP,
                                                                       spx):
        raise ValueError(
            f"ring {a.shape} is neither the unpacked (B, 6, {G8}, 8, {SP}) "
            f"nor the byte-packed (B, 6, {G8}, 8, {spx}) layout")
    if a.shape[4] == spx:
        a = np.ascontiguousarray(a[..., :SP // 4]).astype("<i4").view(
            np.uint8)
    elif a.size and (a.min() < 0 or a.max() > 255):
        raise ValueError("ring holds values outside 0..255")
    out = a.astype(np.uint8).reshape(a.shape[0], 6, G8 * 8, SP)
    return torch.from_numpy(np.ascontiguousarray(out))


def ring_to_jax(ring: torch.Tensor, height: int, stride: int,
                packed: bool = False) -> np.ndarray:
    """Port ring -> JAX ring (host numpy int32): the unpacked layout
    (B, 6, G8, 8, SP) of modes 1 and 0, or with ``packed`` the byte-packed
    layout (B, 6, G8, 8, SPX) of mode 2, pad words zero."""
    _hh, G8, SP = _geom(height, stride)
    a = ring.detach().cpu().numpy().reshape(-1, 6, G8, 8, SP)
    if not packed:
        return a.astype(np.int32)
    out = np.zeros(a.shape[:4] + (packed_words(height, stride),), np.int32)
    out[..., :SP // 4] = np.ascontiguousarray(a).view("<i4")
    return out


_TABLES: dict[str, torch.Tensor] = {}


def kernel_tables(device) -> torch.Tensor:
    """(20, 256, 4) uint8 [kind, tap0, tap1, tap2] per (mode, pixel r*16+c)
    from ops/intra_tables.py, on ``device`` (cached per indexed device)."""
    device = indexed(device)
    key = str(device)
    t = _TABLES.get(key)
    if t is None:
        tab = np.zeros((20, 256, 4), np.uint8)
        tab[..., 0] = KIND
        tab[..., 1:] = TAPS
        t = torch.from_numpy(tab).to(device)
        _TABLES[key] = t
    return t
