"""Batched LPC audio synthesis (the FastAudio lattice).

Port of ``mobiclipdecoder_tpu/ops/audio_lpc.py``.  The FastAudio codec
(models/audio_fastaudio.py, mirror of FastAudioDecoder.cs:41-72) splits at
the same seam as video: packet unpacking (bitstream work, host) vs the
8-tap lattice synthesis filter (sample-sequential arithmetic, device).  One
channel's filter is a scalar recurrence, but a transcode job carries
CHANNELS x STREAMS independent recurrences, so the device form is a loop
over the 256 samples of a packet with every channel in the batch advancing
one sample per step.  On CUDA tensors ``fastaudio_synth`` is one launch of
K8 (``ops/audio_kernels.py``, csrc/audio.cu), a thread per channel; on CPU
tensors it is the plain torch ``fastaudio_synth_plain``.

Bit-exactness: the reference computes ``(coef * hist + 0x4000) >> 15`` in
unbounded precision.  With |coef| < 2**15 and an int32 history the exact
value fits int32, and so does every int64 product here, so the product is
taken in int64 and cast back: equal to the JAX package's exact int32 split.
The state and the adds stay int32, as there, so that any wrap matches.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import check_device
from . import audio_kernels

_DEEMPH = 0x6E14  # fixed de-emphasis coefficient (FastAudioDecoder.cs:66)


def _mulshift15(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact (a * b + 0x4000) >> 15 as int32, for int32 b and |a| < 2**15."""
    return ((a.to(torch.int64) * b.to(torch.int64) + 0x4000) >> 15).to(
        torch.int32)


def fastaudio_synth(excit, coef, hist0, r9_0, lengths=None):
    """Batched FastAudio synthesis filter (FastAudioDecoder.cs:54-71).

    excit: (B, N) int32 pulse excitation; coef: (B, 8) int32 LPC
    coefficients, or (B, P, 8), one set per packet of N / P samples;
    hist0: (B, 8) int32 filter history (hist[j] = Internal[107-j]); r9_0:
    (B,) int32 de-emphasis state; lengths: None, or (B,) int32 each row's
    packets (the rest of the row is padding), all on one device.  Returns
    (pcm (B, N) int16, hist, r9): the state after each row's packets; the
    padding's samples are not defined.

    On CUDA tensors one launch of K8, which takes contiguous tensors or
    raises; on CPU tensors the plain version; any other device raises."""
    if excit.device.type == "cpu":
        return fastaudio_synth_plain(excit, coef, hist0, r9_0, lengths)
    if excit.device.type != "cuda":
        raise ValueError(f"no FastAudio lattice for device {excit.device}")
    return audio_kernels.fastaudio_synth(excit, coef, hist0, r9_0, lengths)


def fastaudio_synth_plain(excit, coef, hist0, r9_0, lengths=None):
    """``fastaudio_synth`` in plain torch, on whatever device its inputs
    lie on: a loop over the samples, every channel one step at a time; a
    row's state stops where its packets end.  Tap j of the lattice
    subtracts coef[j] * hist[j] from r5, a product no tap changes, so the
    r5 after each tap is the excitation less a running sum of the eight
    products (int64, then wrapped: int32 arithmetic is arithmetic mod
    2**32), and the history's eight updates are one product after it."""
    B, P, L = audio_kernels.synth_sizes(excit, coef, hist0, r9_0, lengths)
    # cast once, not per use
    sets = coef.reshape(B, P, 8).to(torch.int64)
    stop = None if lengths is None else lengths.clamp(0, P) * L
    hist, r9 = hist0, r9_0
    deemph = torch.tensor(_DEEMPH, dtype=torch.int64, device=excit.device)
    out = []
    for n, e in enumerate(excit.unbind(1)):
        if n % L == 0:
            cf = sets[:, n // L]
        r5 = (e[:, None].to(torch.int64) - torch.cumsum(
            _mulshift15(cf, hist), 1, dtype=torch.int64)).to(torch.int32)
        cols = hist + _mulshift15(cf, r5)
        cols = torch.cat([cols[:, 1:], r5[:, 7:]], dim=1)
        r5 = r5[:, 7] + _mulshift15(deemph, r9)
        if stop is None:
            hist, r9 = cols, r5
        else:
            live = n < stop
            hist = torch.where(live[:, None], cols, hist)
            r9 = torch.where(live, r5, r9)
        r8 = torch.clamp(r5, -(1 << 28), 1 << 28) * 2
        out.append(torch.clamp(r8, -32768, 32767).to(torch.int16))
    return torch.stack(out, dim=1), hist, r9


class FastAudioBatchDecoder:
    """Many-channel FastAudio decoding with the synthesis filter on
    ``device`` (required; a CUDA device that is not there raises).

    The host unpacks each channel's packet (FastAudioDecoder.excitation);
    the lattice runs as one batched call over all channels.  Bit-exact
    with the per-channel host decoders."""

    def __init__(self, channels: int, *, device):
        from ..models.audio_fastaudio import FastAudioDecoder
        self.device = check_device(device)
        self.channels = channels
        self.decs = [FastAudioDecoder() for _ in range(channels)]
        self.hist = torch.zeros((channels, 8), dtype=torch.int32,
                                device=self.device)
        self.r9 = torch.zeros((channels,), dtype=torch.int32,
                              device=self.device)

    def decode(self, packets: list[bytes | None]) -> np.ndarray:
        """packets[ch] = one 40-byte packet per channel (None = silence for
        that channel this round).  Returns (channels, 256) int16."""
        ex = np.zeros((self.channels, 256), np.int32)
        cf = np.zeros((self.channels, 8), np.int32)
        for ch, pkt in enumerate(packets):
            if pkt is None:
                continue
            d = self.decs[ch]
            d.data = pkt
            d.offset = 0
            out, coef = d.excitation()
            ex[ch] = out.astype(np.int32)
            cf[ch] = coef
        pcm, self.hist, self.r9 = fastaudio_synth(
            torch.from_numpy(ex).to(self.device),
            torch.from_numpy(cf).to(self.device), self.hist, self.r9)
        return pcm.cpu().numpy()
