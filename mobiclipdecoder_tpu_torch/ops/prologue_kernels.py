"""Wrappers of the device prologue's kernels (csrc/prologue.cu).

The JAX package runs its whole-GOP prologue as XLA code outside its Pallas
kernel (``_decode_gop_fused_sblob`` and ``_residuals`` in
``mobiclipdecoder_tpu/ops/vmem_engine.py``); the port runs it as
hand-written CUDA kernels, built with nvcc at first use:

* K5 ``prologue_sblob``: the whole sparse-blob prologue in one launch,
  blob sections -> (ops, resid): each block of 128 rows gathers its
  nonzeros from the stream's sorted index list into a zeroed tile in
  shared memory, transforms the rows there (the IDCT pre-pass, sizes from
  the blob's size bits), widens the packed op rows and writes every row
  once;
* K4 ``residual_rows``: the IDCT pre-pass of dense coefficient rows, one
  thread per row.

Each launch function takes CUDA tensors only, launches its kernel on the
current stream of the tensors' device, and raises if the launch is refused.
``prologue_launches`` and ``residual_launches`` count the launches of K5
and K4.  The wrappers that pick the plain version for CPU tensors are
``ops/prologue.py`` ``unpack_residuals_sblob`` and ``ops/residuals.py``
``residuals``.

``prologue_sblob_host`` and ``residual_rows_host`` run the kernels' code
(csrc/prologue_ops.cuh: K5's per-block function, K4's per-row one) built
for the host with g++; they exist for the CPU tests only.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import build
from ..utils.device import launch, on_one_card

prologue_launches = 0
residual_launches = 0

_lib = None
_host_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _load():
    global _lib
    if _lib is None:
        lib = build.load("prologue", ["prologue.cu"], "nvcc")
        lib.mobi_prologue_sblob_launch.restype = _I
        lib.mobi_prologue_sblob_launch.argtypes = [_P, _P, _P, _P, _P, _P, _L,
                                                   _L, _L, _I, _P]
        lib.mobi_residual_rows_launch.restype = _I
        lib.mobi_residual_rows_launch.argtypes = [_P, _P, _P, _L, _I, _P]
        _lib = lib
    return _lib


def _load_host():
    global _host_lib
    if _host_lib is None:
        lib = build.load("prologue_host", ["prologue_host.cpp"], "g++",
                         "host")
        lib.mobi_prologue_sblob_host.restype = _I
        lib.mobi_prologue_sblob_host.argtypes = [_P, _P, _P, _P, _L, _L, _L,
                                                 _P, _P]
        lib.mobi_residual_rows_host.restype = None
        lib.mobi_residual_rows_host.argtypes = [_P, _P, _P, _L]
        _host_lib = lib
    return _host_lib


def _sblob_shapes(ops3, sbits, idx, v32, ops, resid) -> tuple:
    """(N, B, nnzb) of K5's operands, or ValueError unless ops3 (N, 3),
    sbits (ceil(N / 32),), idx (B, nnzb), v32 (B, nnzb / 2), ops (N, 4)
    and resid (N, 64) with nnzb even and N / B rows per stream a multiple
    of 128 (the layout's nct * 256 always is)."""
    n = ops3.shape[0] if ops3.ndim else 0
    B, nnzb = idx.shape if idx.ndim == 2 else (0, 0)
    if (tuple(ops3.shape) != (n, 3) or n < 1 or B < 1
            or n % B or (n // B) % 128 or nnzb < 2 or nnzb % 2
            or tuple(sbits.shape) != ((n + 31) // 32,)
            or tuple(v32.shape) != (B, nnzb // 2)
            or tuple(ops.shape) != (n, 4) or tuple(resid.shape) != (n, 64)):
        raise ValueError(f"ops3 {tuple(ops3.shape)}, sbits "
                         f"{tuple(sbits.shape)}, idx {tuple(idx.shape)}, "
                         f"v32 {tuple(v32.shape)}, ops {tuple(ops.shape)}, "
                         f"resid {tuple(resid.shape)}: expected (N, 3), "
                         f"(ceil(N / 32),), (B, nnzb), (B, nnzb / 2), "
                         f"(N, 4), (N, 64) with nnzb even and N / B a "
                         f"multiple of 128")
    return n, B, nnzb


def prologue_sblob(ops3: torch.Tensor, sbits: torch.Tensor,
                   idx: torch.Tensor, v32: torch.Tensor, ops: torch.Tensor,
                   resid: torch.Tensor) -> None:
    """K5: the sparse blob's sections (``ops/prologue.py``
    ``blob_sections``) -> ops (N, 4), the widened op rows, and resid (N,
    64), the IDCT pre-pass of the coefficients scattered per stream
    (stream b's rows b * N / B onward; indices outside [0, N / B * 64)
    dropped); row r's size is bit r of sbits.  Every row of ops and resid
    is written: neither needs a fill.  Each stream's in-range indices
    must ascend, unique (the JAX package's contract)."""
    global prologue_launches
    dev = on_one_card(ops3=ops3, sbits=sbits, idx=idx, v32=v32, ops=ops,
                      resid=resid)
    n, B, nnzb = _sblob_shapes(ops3, sbits, idx, v32, ops, resid)
    launch(_load().mobi_prologue_sblob_launch, dev, ops3.data_ptr(),
           sbits.data_ptr(), idx.data_ptr(), v32.data_ptr(), ops.data_ptr(),
           resid.data_ptr(), B, nnzb, n)
    prologue_launches += 1


def residual_rows(coefs: torch.Tensor, sizes: torch.Tensor,
                  resid: torch.Tensor) -> None:
    """K4, dense form: coefs (N, 64), sizes (N,) in {4, 8} -> resid
    (N, 64)."""
    global residual_launches
    dev = on_one_card(coefs=coefs, sizes=sizes, resid=resid)
    n = coefs.shape[0]
    if (coefs.dim() != 2 or coefs.shape[1] != 64 or n < 1
            or tuple(sizes.shape) != (n,) or resid.shape != coefs.shape):
        raise ValueError(f"coefs {tuple(coefs.shape)}, sizes "
                         f"{tuple(sizes.shape)}, resid {tuple(resid.shape)}: "
                         f"expected (N, 64), (N,), (N, 64)")
    launch(_load().mobi_residual_rows_launch, dev, coefs.data_ptr(),
           sizes.data_ptr(), resid.data_ptr(), n)
    residual_launches += 1


def _np32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), np.int32)


def prologue_sblob_host(ops3, sbits, idx, v32) -> tuple:
    """K5's per-block code on the host (g++ build), block by block:
    ops3 (N, 3), sbits, idx (B, nnzb), v32 (B, nnzb / 2) -> (ops (N, 4),
    resid (N, 64)) int32 numpy."""
    ops3, sbits, idx, v32 = map(_np32, (ops3, sbits, idx, v32))
    n = ops3.shape[0]
    ops = np.empty((n, 4), np.int32)
    resid = np.empty((n, 64), np.int32)
    _n, B, nnzb = _sblob_shapes(ops3, sbits, idx, v32, ops, resid)
    rc = _load_host().mobi_prologue_sblob_host(
        ops3.ctypes.data, sbits.ctypes.data, idx.ctypes.data,
        v32.ctypes.data, B, nnzb, n, ops.ctypes.data, resid.ctypes.data)
    if rc != 0:
        raise ValueError(f"K5 refuses B={B}, nnzb={nnzb}, {n} rows")
    return ops, resid


def residual_rows_host(coefs, sizes) -> np.ndarray:
    """The dense form on the host: coefs (N, 64), sizes (N,) -> resid
    (N, 64) int32 numpy."""
    coefs, sizes = _np32(coefs), _np32(sizes)
    if coefs.ndim != 2 or coefs.shape[1] != 64 or sizes.shape != (
            coefs.shape[0],):
        raise ValueError(f"coefs {coefs.shape}, sizes {sizes.shape}")
    resid = np.empty_like(coefs)
    _load_host().mobi_residual_rows_host(coefs.ctypes.data,
                                         sizes.ctypes.data,
                                         resid.ctypes.data, coefs.shape[0])
    return resid
