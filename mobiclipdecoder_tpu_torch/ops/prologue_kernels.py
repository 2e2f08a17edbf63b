"""Wrappers of the device prologue's kernels (csrc/prologue.cu).

The JAX package runs its whole-GOP prologue as XLA code outside its Pallas
kernel (``_decode_gop_fused_sblob`` and ``_residuals`` in
``mobiclipdecoder_tpu/ops/vmem_engine.py``); the port runs it as two
hand-written CUDA kernels, built with nvcc at first use:

* K3 ``scatter_coefs``: the sparse blob's int16 nonzeros into a dense
  int32 buffer zeroed beforehand, one thread per nonzero, order-free;
* K4 ``residual_rows`` / ``residual_rows_sblob``: the IDCT pre-pass, one
  thread per row; its sparse-blob form runs in place on the scattered
  buffer, reads the sizes from the blob's size bits and widens the packed
  op rows.

Each launch function takes CUDA tensors only, launches its kernel on the
current stream of the tensors' device, and raises if the launch is refused.
``scatter_launches`` and ``residual_launches`` count the launches of K3 and
K4 (both forms).  The wrappers that pick the plain version for CPU tensors
are ``ops/prologue.py`` ``unpack_residuals_sblob`` and ``ops/residuals.py``
``residuals``.

``prologue_sblob_host`` and ``residual_rows_host`` run the kernels'
per-row code (csrc/prologue_ops.cuh) built for the host with g++; they
exist for the CPU tests only.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import build

scatter_launches = 0
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
        lib.mobi_scatter_coefs_launch.restype = _I
        lib.mobi_scatter_coefs_launch.argtypes = [_P, _P, _P, _L, _L, _L, _I,
                                                  _P]
        lib.mobi_residual_rows_launch.restype = _I
        lib.mobi_residual_rows_launch.argtypes = [_P, _P, _P, _L, _I, _P]
        lib.mobi_residual_rows_sblob_launch.restype = _I
        lib.mobi_residual_rows_sblob_launch.argtypes = [_P, _P, _P, _P, _L,
                                                        _I, _P]
        _lib = lib
    return _lib


def _load_host():
    global _host_lib
    if _host_lib is None:
        lib = build.load("prologue_host", ["prologue_host.cpp"], "g++",
                         "host")
        lib.mobi_prologue_sblob_host.restype = None
        lib.mobi_prologue_sblob_host.argtypes = [_P, _P, _P, _P, _L, _L, _L,
                                                 _P, _P]
        lib.mobi_residual_rows_host.restype = None
        lib.mobi_residual_rows_host.argtypes = [_P, _P, _P, _L]
        _host_lib = lib
    return _host_lib


def _on_one_card(**tensors) -> torch.device:
    """Every tensor int32, contiguous and on one CUDA device; returns it."""
    dev = None
    for name, t in tensors.items():
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous int32 tensor, "
                             f"got {t.dtype} (contiguous "
                             f"{t.is_contiguous()})")
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}: the prologue "
                             f"kernels take CUDA tensors")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not {dev}")
        dev = t.device
    return dev


def _launch(fn, dev: torch.device, *args) -> None:
    # the library's runtime launches on the device current on this thread;
    # the launch checks that it is the tensors' device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*args, dev.index, stream)
    if rc != 0:
        raise RuntimeError(f"prologue kernel launch on {dev} failed: CUDA "
                           f"error {rc}")


def scatter_coefs(idx: torch.Tensor, v32: torch.Tensor,
                  dense: torch.Tensor) -> None:
    """K3: the nonzeros idx (B, nnzb) with their int16 values in pairs
    v32 (B, nnzb / 2) into dense (B, rows * 64), which holds zeros where
    nothing is written; indices outside [0, rows * 64) are dropped."""
    global scatter_launches
    dev = _on_one_card(idx=idx, v32=v32, dense=dense)
    B, nnzb = idx.shape
    if nnzb % 2 or tuple(v32.shape) != (B, nnzb // 2) or dense.dim() != 2 \
            or dense.shape[0] != B or dense.shape[1] % 64:
        raise ValueError(f"idx {tuple(idx.shape)}, v32 {tuple(v32.shape)}, "
                         f"dense {tuple(dense.shape)}: expected (B, nnzb), "
                         f"(B, nnzb / 2) with nnzb even, (B, rows * 64)")
    _launch(_load().mobi_scatter_coefs_launch, dev, idx.data_ptr(),
            v32.data_ptr(), dense.data_ptr(), B, nnzb, dense.shape[1])
    scatter_launches += 1


def residual_rows(coefs: torch.Tensor, sizes: torch.Tensor,
                  resid: torch.Tensor) -> None:
    """K4, dense form: coefs (N, 64), sizes (N,) in {4, 8} -> resid
    (N, 64)."""
    global residual_launches
    dev = _on_one_card(coefs=coefs, sizes=sizes, resid=resid)
    n = coefs.shape[0]
    if (coefs.dim() != 2 or coefs.shape[1] != 64 or n < 1
            or tuple(sizes.shape) != (n,) or resid.shape != coefs.shape):
        raise ValueError(f"coefs {tuple(coefs.shape)}, sizes "
                         f"{tuple(sizes.shape)}, resid {tuple(resid.shape)}: "
                         f"expected (N, 64), (N,), (N, 64)")
    _launch(_load().mobi_residual_rows_launch, dev, coefs.data_ptr(),
            sizes.data_ptr(), resid.data_ptr(), n)
    residual_launches += 1


def residual_rows_sblob(resid: torch.Tensor, ops3: torch.Tensor,
                        sbits: torch.Tensor, ops: torch.Tensor) -> None:
    """K4, sparse-blob form: resid (N, 64) scattered coefficients ->
    spatial rows in place; row r's size is bit r of the words sbits
    (ceil(N / 32),); the packed op rows ops3 (N, 3) -> ops (N, 4)."""
    global residual_launches
    dev = _on_one_card(resid=resid, ops3=ops3, sbits=sbits, ops=ops)
    n = resid.shape[0]
    if (resid.dim() != 2 or resid.shape[1] != 64 or n < 1
            or tuple(ops3.shape) != (n, 3) or tuple(ops.shape) != (n, 4)
            or tuple(sbits.shape) != ((n + 31) // 32,)):
        raise ValueError(f"resid {tuple(resid.shape)}, ops3 "
                         f"{tuple(ops3.shape)}, sbits {tuple(sbits.shape)}, "
                         f"ops {tuple(ops.shape)}: expected (N, 64), (N, 3), "
                         f"(ceil(N / 32),), (N, 4)")
    _launch(_load().mobi_residual_rows_sblob_launch, dev, resid.data_ptr(),
            ops3.data_ptr(), sbits.data_ptr(), ops.data_ptr(), n)
    residual_launches += 1


def _np32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), np.int32)


def prologue_sblob_host(ops3, sbits, idx, v32) -> tuple:
    """The sparse-blob form on the host (g++ build of the kernels' code):
    ops3 (N, 3), sbits, idx (B, nnzb), v32 (B, nnzb / 2) -> (ops (N, 4),
    resid (N, 64)) int32 numpy."""
    ops3, sbits, idx, v32 = map(_np32, (ops3, sbits, idx, v32))
    n = ops3.shape[0]
    B, nnzb = idx.shape
    if nnzb % 2 or v32.shape != (B, nnzb // 2) or n % B:
        raise ValueError(f"idx {idx.shape}, v32 {v32.shape}, {n} rows")
    ops = np.empty((n, 4), np.int32)
    resid = np.empty((n, 64), np.int32)
    _load_host().mobi_prologue_sblob_host(
        ops3.ctypes.data, sbits.ctypes.data, idx.ctypes.data,
        v32.ctypes.data, B, nnzb, n, ops.ctypes.data, resid.ctypes.data)
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
