"""Wrapper of the encoder's SAD-volume kernel (csrc/sad.cu).

The JAX package computes the motion search's full-search SAD volume as one
XLA program (``_sad8_volume`` in ``mobiclipdecoder_tpu/ops/mesearch.py``, a
jitted ``lax.scan`` over the offsets); the port runs it as one hand-written
CUDA kernel, built with nvcc at first use:

* K7 ``sad_volume``: the whole ((2r+1)^2, R, H/8, W/8) volume in one
  launch, one block per (tile row, vertical offset, reference), the
  reference's shifted rows staged in shared memory.

``sad_volume`` takes CUDA tensors only, launches K7 on the current stream
of the tensors' device, and raises if the launch is refused.
``sad_launches`` counts its launches.  The wrapper that picks the plain
version for CPU tensors is ``ops/mesearch.py`` ``_sad8_volume``.

``sad_volume_host`` runs the kernel's code (csrc/sad_ops.cuh) built for the
host with g++, block by block; it exists for the CPU tests only.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import build
from ..utils.device import launch, on_one_card

sad_launches = 0

_lib = None
_host_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGS = [_P, _P, _P, _L, _L, _L, _L]


def _load():
    global _lib
    if _lib is None:
        lib = build.load("sad", ["sad.cu"], "nvcc")
        lib.mobi_sad8_volume_launch.restype = _I
        lib.mobi_sad8_volume_launch.argtypes = _ARGS + [_I, _P]
        _lib = lib
    return _lib


def _load_host():
    global _host_lib
    if _host_lib is None:
        lib = build.load("sad_host", ["sad_host.cpp"], "g++", "host")
        lib.mobi_sad8_volume_host.restype = _I
        lib.mobi_sad8_volume_host.argtypes = _ARGS
        _host_lib = lib
    return _host_lib


def volume_shape(cur, refs, range_: int) -> tuple[int, ...]:
    """((2r+1)^2, R, H/8, W/8) of K7's output, or ValueError unless cur
    (H, W) and refs (R, H, W) with H and W multiples of 8, W at most 2048,
    R >= 1 and range_ >= 0 (the sizes K7 takes)."""
    H, W = cur.shape if cur.ndim == 2 else (0, 0)
    R = refs.shape[0] if refs.ndim == 3 else 0
    side = 2 * range_ + 1
    if (H < 8 or W < 8 or H % 8 or W % 8 or W > 2048 or R < 1
            or tuple(refs.shape) != (R, H, W) or range_ < 0
            or 64 * ((W + 2 * range_ + 7) // 8) * 4 > 232448):
        raise ValueError(f"cur {tuple(cur.shape)}, refs {tuple(refs.shape)}, "
                         f"range {range_}: expected (H, W) and (R, H, W) "
                         f"with H, W multiples of 8, W <= 2048, R >= 1, "
                         f"range >= 0 and the staged rows in shared memory")
    return side * side, R, H // 8, W // 8


def sad_volume(cur: torch.Tensor, refs: torch.Tensor,
               range_: int) -> torch.Tensor:
    """K7: cur (H, W), refs (R, H, W), contiguous int32 CUDA tensors on
    one device -> the ((2r+1)^2, R, H/8, W/8) int32 SAD volume of
    ``_sad8_volume`` on the tensors' card."""
    global sad_launches
    dev = on_one_card(cur=cur, refs=refs)
    shape = volume_shape(cur, refs, range_)
    vol = torch.empty(shape, dtype=torch.int32, device=dev)
    launch(_load().mobi_sad8_volume_launch, dev, cur.data_ptr(),
           refs.data_ptr(), vol.data_ptr(), *cur.shape, refs.shape[0], range_)
    sad_launches += 1
    return vol


def sad_volume_host(cur, refs, range_: int) -> np.ndarray:
    """K7's code on the host (g++ build), block by block: numpy cur (H, W)
    and refs (R, H, W) -> the volume, int32 numpy."""
    cur = np.ascontiguousarray(np.asarray(cur), np.int32)
    refs = np.ascontiguousarray(np.asarray(refs), np.int32)
    vol = np.empty(volume_shape(cur, refs, range_), np.int32)
    rc = _load_host().mobi_sad8_volume_host(
        cur.ctypes.data, refs.ctypes.data, vol.ctypes.data, *cur.shape,
        refs.shape[0], range_)
    if rc != 0:
        raise ValueError(f"K7 refuses cur {cur.shape}, refs {refs.shape}, "
                         f"range {range_}")
    return vol
