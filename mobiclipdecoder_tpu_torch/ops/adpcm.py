"""IMA ADPCM as two inclusive scans of clamped-add maps.

Port of ``mobiclipdecoder_tpu/ops/adpcm.py``.  The sample-sequential IMA
recurrence (models/audio_ima.py) looks serial, but both state variables
evolve by clamped adds, and clamped-add maps ``x -> clamp(x + a, lo, hi)``
are closed under composition:

    g(f(x)) = clamp(x + af + ag, clamp(lo_f + ag, lo_g, hi_g),
                                 clamp(hi_f + ag, lo_g, hi_g))

so a log-step (Hillis-Steele) scan computes all intermediate states in
O(log n) steps:

  pass 1 - the step-index chain (delta from the nibble's index table entry,
           clamped to [0, 88]); shifted by one, it yields each nibble's
           *pre-update* index, from which its diff follows directly;
  pass 2 - the sample chain (clamped add of the signed diff to [-32768,
           32767]); the inclusive scan yields the output samples.

Composition is associative, so any scan order gives the JAX package's
results exactly.  All arithmetic is int32.  On CUDA tensors
``decode_nibbles`` is one launch of K9 (``ops/audio_kernels.py``,
csrc/audio.cu), a block per row; on CPU tensors it is the plain torch
``decode_nibbles_plain``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.audio_ima import INDEX_TABLE, STEP_TABLE
from ..utils.device import check_device
from . import audio_kernels


def _compose(f, g):
    """Compose clamped-add maps elementwise: g after f."""
    af, lof, hif = f
    ag, log_, hig = g
    a = af + ag
    lo = torch.clamp(lof + ag, log_, hig)
    hi = torch.clamp(hif + ag, log_, hig)
    return a, lo, hi


def _inclusive_scan(f):
    """Inclusive scan of (a, lo, hi) maps along the last axis: element i
    becomes the composition of elements 0..i (0 applied first)."""
    n = f[0].shape[-1]
    d = 1
    while d < n:
        comp = _compose(tuple(x[..., :-d] for x in f),
                        tuple(x[..., d:] for x in f))
        f = tuple(torch.cat([x[..., :d], c], dim=-1)
                  for x, c in zip(f, comp))
        d *= 2
    return f


def decode_nibbles(nibbles: torch.Tensor, index0: torch.Tensor,
                   last0: torch.Tensor, lengths: torch.Tensor | None = None):
    """Decode a (..., N) int32 nibble tensor given initial (index, last) of
    shape (...).  Returns int32 samples of the same shape, on the nibbles'
    device.  Vectorizes over any leading batch axes (channels, packets,
    streams).  Given lengths (...), returns (samples, index, last): also
    each row's step index and sample after its first lengths nibbles
    (clamped to [0, N]), the state a decoder carries on from a row that
    was padded to N.

    On CUDA tensors one launch of K9, which takes contiguous tensors or
    raises; on CPU tensors the plain version; any other device raises."""
    if nibbles.device.type == "cpu":
        return decode_nibbles_plain(nibbles, index0, last0, lengths)
    if nibbles.device.type != "cuda":
        raise ValueError(f"no IMA scans for device {nibbles.device}")
    return audio_kernels.ima_scan(nibbles, index0, last0, lengths)


def decode_nibbles_plain(nibbles: torch.Tensor, index0: torch.Tensor,
                         last0: torch.Tensor,
                         lengths: torch.Tensor | None = None):
    """``decode_nibbles`` in plain torch, on whatever device its inputs lie
    on: the two log-step scans."""
    dev = nibbles.device
    idx_t = torch.from_numpy(INDEX_TABLE.astype(np.int32)).to(dev)
    step_t = torch.from_numpy(STEP_TABLE.astype(np.int32)).to(dev)
    # pass 1: pre-update step index per nibble
    a = idx_t[(nibbles & 7).long()]
    lo = torch.zeros_like(a)
    hi = torch.full_like(a, 88)
    pa, plo, phi = _inclusive_scan((a, lo, hi))
    # exclusive: index BEFORE nibble k = prefix of k-1 applied to index0
    idx_incl = torch.clamp(index0[..., None] + pa, plo, phi)
    idx_pre = torch.cat([index0[..., None].expand_as(idx_incl[..., :1]),
                         idx_incl[..., :-1]], dim=-1)
    # diff from pre-update index (IMAADPCMDecoder.cs:37-42)
    step = step_t[idx_pre.long()]
    diff = (step >> 3) + (step >> 2) * (nibbles & 1) \
        + (step >> 1) * ((nibbles >> 1) & 1) + step * ((nibbles >> 2) & 1)
    d = torch.where((nibbles & 8) != 0, -diff, diff)
    # pass 2: clamped-add sample chain
    lo2 = torch.full_like(d, -32768)
    hi2 = torch.full_like(d, 32767)
    sa, slo, shi = _inclusive_scan((d, lo2, hi2))
    samples = torch.clamp(last0[..., None] + sa, slo, shi)
    if lengths is None:
        return samples
    if nibbles.shape[-1] == 0:      # no nibble taken: the start state
        return samples, index0.clone(), last0.clone()
    n = torch.clamp(lengths, 0, nibbles.shape[-1]).long()
    at = (n - 1).clamp(min=0)[..., None]
    return (samples,
            torch.where(n > 0, idx_incl.gather(-1, at)[..., 0], index0),
            torch.where(n > 0, samples.gather(-1, at)[..., 0], last0))


def decode_packets(packets: np.ndarray, index0: np.ndarray,
                   last0: np.ndarray, *, device) -> np.ndarray:
    """Decode (..., L) uint8 packet bytes -> (..., 2L) int16 samples, the
    scans on ``device`` (a CUDA device that is not there raises)."""
    dev = check_device(device)
    b = torch.from_numpy(np.ascontiguousarray(packets, np.int32)).to(dev)
    nibbles = torch.stack([b & 0xF, b >> 4], dim=-1).reshape(
        *b.shape[:-1], b.shape[-1] * 2)
    out = decode_nibbles(
        nibbles,
        torch.from_numpy(np.asarray(index0, np.int32).copy()).to(dev),
        torch.from_numpy(np.asarray(last0, np.int32).copy()).to(dev))
    return out.cpu().numpy().astype(np.int16)
