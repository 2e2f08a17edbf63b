"""Wrapper of the wavefront engine's kernel (csrc/wavefront.cu).

The JAX package runs a frame round of its wavefront engine as one XLA
program (``decode_frame_core`` under ``_decode_batch_jit`` in
``mobiclipdecoder_tpu/models/pipeline.py``, its intra levels a
``fori_loop``); the port runs it as one hand-written CUDA kernel, built
with nvcc at first use:

* K6 ``wavefront_frame``: one frame round of B streams in one launch, one
  block per stream: MC from the ring, the inter residuals, then the
  stream's own intra levels looped inside the block, each level's pixels
  staged and written back after a barrier.

``wavefront_frame`` takes CUDA tensors only, launches K6 on the current
stream of the tensors' device, and raises if the launch is refused.
``wavefront_launches`` counts its launches.  The wrapper that picks the
plain version for CPU tensors is ``models/pipeline.py``
``decode_frame_core``.

``wavefront_frame_host`` runs the kernel's code (csrc/wavefront_ops.cuh,
K6's per-stream function) built for the host with g++; it exists for the
CPU tests only.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import build
from ..utils.device import launch, on_one_card
from .intra_tables import KIND, TAPS

wavefront_launches = 0

_lib = None
_host_lib = None
_TABLES: dict[str, torch.Tensor] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGS = [_P] * 11 + [_L] + [_I] * 7

# KIND (20, 256) then TAPS (20, 256, 3), as K6 reads them
TABLES = np.concatenate([KIND.ravel(), TAPS.ravel()]).astype(np.uint8)


def _load():
    global _lib
    if _lib is None:
        lib = build.load("wavefront", ["wavefront.cu"], "nvcc")
        lib.mobi_wavefront_frame_launch.restype = _I
        lib.mobi_wavefront_frame_launch.argtypes = _ARGS + [_I, _P]
        _lib = lib
    return _lib


def _load_host():
    global _host_lib
    if _host_lib is None:
        lib = build.load("wavefront_host", ["wavefront_host.cpp"], "g++",
                         "host")
        lib.mobi_wavefront_frame_host.restype = _I
        lib.mobi_wavefront_frame_host.argtypes = _ARGS
        _host_lib = lib
    return _host_lib


def frame_sizes(ring, mc, resid, resid_coef, iops, icoef, seqmap, n_levels,
                H: int, S: int) -> tuple[int, ...]:
    """(B, M, N, L, K, SR) of K6's operands, or ValueError unless ring
    (B, 6, H + H/2, S), mc (B, M, 7), resid (B, N, 4), resid_coef (B, N,
    64), iops (B, L, K, 11), icoef (B, L, K, 64), seqmap (B, SR, S / 4)
    and n_levels (B,)."""
    B = ring.shape[0] if ring.ndim == 4 else 0
    M = mc.shape[1] if mc.ndim == 3 else 0
    N = resid.shape[1] if resid.ndim == 3 else 0
    L, K = (iops.shape[1:3] if iops.ndim == 4 else (0, 0))
    SR = seqmap.shape[1] if seqmap.ndim == 3 else 0
    want = {"ring": (B, 6, H + H // 2, S), "mc": (B, M, 7),
            "resid": (B, N, 4), "resid_coef": (B, N, 64),
            "iops": (B, L, K, 11), "icoef": (B, L, K, 64),
            "seqmap": (B, SR, S // 4), "n_levels": (B,)}
    got = {"ring": ring, "mc": mc, "resid": resid, "resid_coef": resid_coef,
           "iops": iops, "icoef": icoef, "seqmap": seqmap,
           "n_levels": n_levels}
    bad = [k for k, v in got.items() if tuple(v.shape) != want[k]]
    if bad or min(B, M, N, L, K, SR) < 1 or S % 4 or H < 2:
        raise ValueError(
            "K6 operands: " + ", ".join(f"{k} {tuple(v.shape)}"
                                         for k, v in got.items())
            + f", H={H}, S={S}: expected ring (B, 6, H + H/2, S), mc (B, "
            f"M, 7), resid (B, N, 4), resid_coef (B, N, 64), iops (B, L, "
            f"K, 11), icoef (B, L, K, 64), seqmap (B, SR, S / 4), n_levels "
            f"(B,), every count at least 1")
    return B, M, N, L, K, SR


def _tables(dev: torch.device) -> torch.Tensor:
    key = str(dev)
    if key not in _TABLES:
        _TABLES[key] = torch.from_numpy(TABLES).to(dev)
    return _TABLES[key]


def wavefront_frame(ring: torch.Tensor, mc: torch.Tensor,
                    resid: torch.Tensor, resid_coef: torch.Tensor,
                    iops: torch.Tensor, icoef: torch.Tensor,
                    seqmap: torch.Tensor, n_levels: torch.Tensor,
                    H: int, S: int) -> torch.Tensor:
    """K6: one frame round of B streams -> (B, H + H/2, S) int32 on the
    tensors' card.  Operands as ``decode_frame_core``'s, every one a
    contiguous int32 CUDA tensor on one device, ``n_levels`` (B,) too:
    stream b runs levels 0 to min(n_levels[b], L) - 1."""
    global wavefront_launches
    tensors = dict(ring=ring, mc=mc, resid=resid, resid_coef=resid_coef,
                   iops=iops, icoef=icoef, seqmap=seqmap, n_levels=n_levels)
    dev = on_one_card(**tensors)
    B, M, N, L, K, SR = frame_sizes(*tensors.values(), H, S)
    lib = _load()
    out = torch.empty((B, H + H // 2, S), dtype=torch.int32, device=dev)
    stage = torch.empty((B, max(N, K) * 256), dtype=torch.int32, device=dev)
    launch(lib.mobi_wavefront_frame_launch, dev,
           *(t.data_ptr() for t in tensors.values()), _tables(dev).data_ptr(),
           out.data_ptr(), stage.data_ptr(), B, H, S, M, N, L, K, SR)
    wavefront_launches += 1
    return out


def wavefront_frame_host(ring, mc, resid, resid_coef, iops, icoef, seqmap,
                         n_levels, H: int, S: int) -> np.ndarray:
    """K6's per-stream code on the host (g++ build), stream by stream:
    numpy operands as ``wavefront_frame``'s -> (B, H + H/2, S) int32."""
    arrs = [np.ascontiguousarray(np.asarray(a), np.int32)
            for a in (ring, mc, resid, resid_coef, iops, icoef, seqmap,
                      n_levels)]
    B, M, N, L, K, SR = frame_sizes(*arrs, H, S)
    out = np.empty((B, H + H // 2, S), np.int32)
    stage = np.empty((B, max(N, K) * 256), np.int32)
    rc = _load_host().mobi_wavefront_frame_host(
        *(a.ctypes.data for a in arrs), TABLES.ctypes.data, out.ctypes.data,
        stage.ctypes.data, B, H, S, M, N, L, K, SR)
    if rc != 0:
        raise ValueError(f"K6 refuses B={B}, H={H}, S={S}, M={M}, N={N}, "
                         f"L={L}, K={K}, SR={SR}")
    return out
