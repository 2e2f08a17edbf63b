"""Wrappers of the batched audio ops' kernels (csrc/audio.cu).

The JAX package runs each batched audio op as one XLA program
(``fastaudio_synth`` in ``mobiclipdecoder_tpu/ops/audio_lpc.py``, a
``lax.scan`` over samples; ``decode_nibbles`` in
``mobiclipdecoder_tpu/ops/adpcm.py``, two ``associative_scan``s); the
port runs each as one hand-written CUDA kernel, built with nvcc at first
use:

* K8 ``fastaudio_synth``: the FastAudio lattice and de-emphasis of B
  channels over N samples, one thread per channel holding its state in
  registers.  The coefficients are one set per channel, or one per packet
  (coef (B, P, 8), each set over N / P samples); given each row's packet
  count, it returns the state after that many packets, so that rows
  padded to one width can carry their own state on;
* K9 ``ima_scan``: the IMA ADPCM step-index and sample chains of M rows,
  one block per row: each thread composes its segment's clamped-add maps,
  a block scan gives each segment's starting state, and the segment is
  replayed.  Given each row's length, it also returns the state (step
  index, sample) after that many nibbles, so that rows padded to one width
  can carry their own state on.

Each launch function takes CUDA tensors only, launches its kernel on the
current stream of the tensors' device, and raises if the launch is refused.
``fastaudio_launches`` and ``ima_launches`` count the launches of K8 and
K9.  The wrappers that pick the plain version for CPU tensors are
``ops/audio_lpc.py`` ``fastaudio_synth`` and ``ops/adpcm.py``
``decode_nibbles``.

``fastaudio_synth_host`` and ``ima_scan_host`` run the kernels' code
(csrc/audio_ops.cuh: K8's per-channel function, K9's block with its
threads taken in turn) built for the host with g++; they exist for the CPU
tests only.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..models.audio_ima import INDEX_TABLE, STEP_TABLE
from ..utils import build
from ..utils.device import launch, on_one_card

fastaudio_launches = 0
ima_launches = 0

_lib = None
_host_lib = None
_TABLES: dict[str, torch.Tensor] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_FA_ARGS = [_P] * 8 + [_L, _L, _L]
_IMA_ARGS = [_P] * 8 + [_L, _L]

# the index table, then the step table, as K9 reads them
IMA_TABLES = np.concatenate([INDEX_TABLE, STEP_TABLE]).astype(np.int32)


def _load():
    global _lib
    if _lib is None:
        lib = build.load("audio", ["audio.cu"], "nvcc")
        lib.mobi_fastaudio_synth_launch.restype = _I
        lib.mobi_fastaudio_synth_launch.argtypes = _FA_ARGS + [_I, _P]
        lib.mobi_ima_scan_launch.restype = _I
        lib.mobi_ima_scan_launch.argtypes = _IMA_ARGS + [_I, _P]
        _lib = lib
    return _lib


def _load_host():
    global _host_lib
    if _host_lib is None:
        lib = build.load("audio_host", ["audio_host.cpp"], "g++", "host")
        lib.mobi_fastaudio_synth_host.restype = None
        lib.mobi_fastaudio_synth_host.argtypes = _FA_ARGS
        lib.mobi_ima_scan_host.restype = None
        lib.mobi_ima_scan_host.argtypes = _IMA_ARGS
        _host_lib = lib
    return _host_lib


def synth_sizes(excit, coef, hist0, r9_0, lengths=None) -> tuple[int, int,
                                                                   int]:
    """(B, P, L) of K8's operands: P coefficient sets a channel, each over
    L samples.  ValueError unless excit (B, N), coef (B, 8) (P = 1, L = N)
    or (B, P, 8) with P >= 1 dividing N (L = N / P), hist0 (B, 8), r9_0
    (B,) and any lengths (B,), with B >= 1."""
    B, N = excit.shape if excit.ndim == 2 else (0, 0)
    P = coef.shape[1] if coef.ndim == 3 else 1
    if (B < 1 or P < 1 or N % P
            or tuple(coef.shape) not in ((B, 8), (B, P, 8))
            or tuple(hist0.shape) != (B, 8) or tuple(r9_0.shape) != (B,)
            or (lengths is not None and tuple(lengths.shape) != (B,))):
        raise ValueError(f"excit {tuple(excit.shape)}, coef "
                         f"{tuple(coef.shape)}, hist0 {tuple(hist0.shape)}, "
                         f"r9_0 {tuple(r9_0.shape)}, lengths "
                         f"{None if lengths is None else tuple(lengths.shape)}"
                         f": expected (B, N), (B, 8) or (B, P, 8) with P "
                         f"dividing N, (B, 8), (B,), (B,) with B >= 1")
    return B, P, N // P


def scan_sizes(nibbles, index0, last0, lengths=None) -> tuple[int, int]:
    """(M, N) of K9's operands, the leading axes of nibbles (..., N)
    flattened to M rows, or ValueError unless index0, last0 and any
    lengths have nibbles' leading shape."""
    lead = tuple(nibbles.shape[:-1])
    states = (index0, last0) + (() if lengths is None else (lengths,))
    if nibbles.ndim < 1 or any(tuple(a.shape) != lead for a in states):
        raise ValueError(f"nibbles {tuple(nibbles.shape)}, index0 "
                         f"{tuple(index0.shape)}, last0 "
                         f"{tuple(last0.shape)}, lengths "
                         f"{None if lengths is None else tuple(lengths.shape)}"
                         f": expected (..., N) and the leading shape (...) "
                         f"for each of the others")
    return int(np.prod(lead, dtype=np.int64)), nibbles.shape[-1]


def _tables(dev: torch.device) -> torch.Tensor:
    key = str(dev)
    if key not in _TABLES:
        _TABLES[key] = torch.from_numpy(IMA_TABLES).to(dev)
    return _TABLES[key]


def fastaudio_synth(excit: torch.Tensor, coef: torch.Tensor,
                    hist0: torch.Tensor, r9_0: torch.Tensor,
                    lengths: torch.Tensor | None = None) -> tuple:
    """K8: excit (B, N), coef (B, 8) or (B, P, 8) (``synth_sizes``), hist0
    (B, 8), r9_0 (B,) and any lengths (B,), contiguous int32 CUDA tensors
    on one device -> (pcm (B, N) int16, hist (B, 8), r9 (B,) int32) on the
    tensors' card.  Given lengths, hist and r9 are each row's state after
    its first lengths coefficient sets (clamped to [0, P]), and its
    samples past them are left unwritten."""
    global fastaudio_launches
    ins = {"excit": excit, "coef": coef, "hist0": hist0, "r9_0": r9_0}
    if lengths is not None:
        ins["lengths"] = lengths
    dev = on_one_card(**ins)
    B, P, L = synth_sizes(excit, coef, hist0, r9_0, lengths)
    pcm = torch.empty((B, P * L), dtype=torch.int16, device=dev)
    hist = torch.empty_like(hist0)
    r9 = torch.empty_like(r9_0)
    launch(_load().mobi_fastaudio_synth_launch, dev, excit.data_ptr(),
           coef.data_ptr(), hist0.data_ptr(), r9_0.data_ptr(), _ptr(lengths),
           pcm.data_ptr(), hist.data_ptr(), r9.data_ptr(), B, P, L)
    fastaudio_launches += 1
    return pcm, hist, r9


def ima_scan(nibbles: torch.Tensor, index0: torch.Tensor,
             last0: torch.Tensor, lengths: torch.Tensor | None = None):
    """K9: nibbles (..., N), index0 (...), last0 (...), contiguous int32
    CUDA tensors on one device -> the (..., N) int32 samples of
    ``decode_nibbles`` on the tensors' card.  Given lengths (...), int32 on
    the same card, -> (samples, index, last): also each row's step index
    and sample after its first lengths nibbles (clamped to [0, N]).  No
    launch where there is nothing to decode (N or the leading size 0)."""
    global ima_launches
    ins = {"nibbles": nibbles, "index0": index0, "last0": last0}
    if lengths is not None:
        ins["lengths"] = lengths
    dev = on_one_card(**ins)
    M, N = scan_sizes(nibbles, index0, last0, lengths)
    out = torch.empty_like(nibbles)
    if M == 0 or N == 0:
        # no nibble taken: each row's state is its start
        return out if lengths is None else (out, index0.clone(),
                                            last0.clone())
    final = (None, None) if lengths is None else (torch.empty_like(index0),
                                                  torch.empty_like(last0))
    launch(_load().mobi_ima_scan_launch, dev, nibbles.data_ptr(),
           index0.data_ptr(), last0.data_ptr(), _tables(dev).data_ptr(),
           _ptr(lengths), out.data_ptr(), *map(_ptr, final), M, N)
    ima_launches += 1
    return out if lengths is None else (out, *final)


def _ptr(t) -> int | None:
    """A tensor's or an array's address, None (NULL) for None."""
    if t is None:
        return None
    return t.data_ptr() if isinstance(t, torch.Tensor) else t.ctypes.data


def _np32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), np.int32)


def fastaudio_synth_host(excit, coef, hist0, r9_0, lengths=None) -> tuple:
    """K8's per-channel code on the host (g++ build): numpy operands as
    ``fastaudio_synth``'s -> (pcm int16, hist, r9) numpy; samples a row's
    lengths leaves unwritten are 0."""
    excit, coef, hist0, r9_0 = map(_np32, (excit, coef, hist0, r9_0))
    if lengths is not None:
        lengths = _np32(lengths)
    B, P, L = synth_sizes(excit, coef, hist0, r9_0, lengths)
    pcm = np.zeros((B, P * L), np.int16)
    hist = np.empty_like(hist0)
    r9 = np.empty_like(r9_0)
    _load_host().mobi_fastaudio_synth_host(
        excit.ctypes.data, coef.ctypes.data, hist0.ctypes.data,
        r9_0.ctypes.data, _ptr(lengths), pcm.ctypes.data, hist.ctypes.data,
        r9.ctypes.data, B, P, L)
    return pcm, hist, r9


def ima_scan_host(nibbles, index0, last0, lengths=None):
    """K9's block code on the host (g++ build), row by row: numpy operands
    as ``ima_scan``'s -> (..., N) int32 samples, or with lengths
    (samples, index, last) as ``ima_scan`` gives them."""
    nibbles, index0, last0 = map(_np32, (nibbles, index0, last0))
    if lengths is not None:
        lengths = _np32(lengths)
    M, N = scan_sizes(nibbles, index0, last0, lengths)
    out = np.empty_like(nibbles)
    final = (None, None) if lengths is None else (index0.copy(),
                                                  last0.copy())
    if M and N:
        _load_host().mobi_ima_scan_host(
            nibbles.ctypes.data, index0.ctypes.data, last0.ctypes.data,
            IMA_TABLES.ctypes.data, _ptr(lengths), out.ctypes.data,
            *map(_ptr, final), M, N)
    return out if lengths is None else (out, *final)
