"""FastAudio packets unpacked in bulk (the port's own; no JAX counterpart).

``audio_fastaudio.FastAudioDecoder.excitation`` parses one 40-byte packet
at a time into its excitation and its 8 LPC coefficients (sub_C48 and
sub_11F4, FastAudioDecoder.cs:130-311).  The parse reads nothing of the
decoder's state, so here it runs over any number of packets at once, in
numpy, with no loop over packets or samples.  ``audio_fastaudio.py`` is a
copy of the JAX package's module and stays as it is; the tests hold this
module against its ``excitation`` packet by packet.
"""
from __future__ import annotations

import numpy as np

from ..tables import TABLES

#: where the 10 three-bit pulse indices of a sub-block's word lie
_SHIFTS = np.array([29, 26, 23, 20, 17, 14, 11, 8, 5, 2])
_BLOCKS = np.arange(4)
#: a sub-block's 21 pulses lie 3 samples apart
_PULSE_AT = 3 * np.arange(21)


def unpack(packets: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(..., 40) uint8 packets -> (excitation (..., 256) int32, LPC
    coefficients (..., 8) int32), each packet's as ``excitation`` gives
    them."""
    p = np.ascontiguousarray(packets, np.uint8)
    lead = p.shape[:-1]
    # ten little-endian u32 fields (_read_u32's two u16 halves)
    w = p.reshape(-1, 40).view("<u4").astype(np.int64)
    M = w.shape[0]
    w0, w1 = w[:, 0], w[:, 1]
    ra, rb = w[:, 2::2], w[:, 3::2]                     # (M, 4) each
    q = [TABLES[f"fa_lpc_q{i}"] for i in range(7)]
    low = rb & 1
    idx5 = low[:, 3] | (low[:, 2] << 1) | (low[:, 1] << 2) | (low[:, 0] << 3)
    # Internal[0..7]; coefficient j is Internal[7 - j]
    inr = np.stack([q[0][w0 >> 26], q[0][(w0 >> 20) & 0x3F],
                    q[1][(w0 >> 15) & 0x1F], q[2][(w0 >> 10) & 0x1F],
                    q[3][(w0 >> 6) & 0xF], q[6][idx5], q[4][(w0 >> 3) & 7],
                    q[5][w0 & 7]], axis=1)
    coef = inr[:, ::-1].astype(np.int32)
    # each sub-block's 21 pulse indices: 10 from each of its two words,
    # the last from the spare bits of both
    idx = np.concatenate([(ra[..., None] >> _SHIFTS) & 7,
                          (rb[..., None] >> _SHIFTS) & 7,
                          (((rb >> 1) & 1) | ((ra & 3) << 1))[..., None]],
                         axis=2)                        # (M, 4, 21)
    table = ((w1[:, None] >> (8 + 6 * _BLOCKS)) & 0x3F) * 8
    zeros = (w1[:, None] >> (2 * _BLOCKS)) & 3
    pulses = TABLES.fa_pulse[table[..., None] + idx]
    # sub-block k fills samples [64 k, 64 k + 64): zeros[k] zeros, then
    # pulse, 0, 0 twenty times, the last pulse and 3 - zeros[k] zeros
    at = 64 * _BLOCKS[:, None] + zeros[..., None] + _PULSE_AT
    excit = np.zeros((M, 256), np.int32)
    np.put_along_axis(excit, at.reshape(M, 84), pulses.reshape(M, 84), 1)
    return excit.reshape(*lead, 256), coef.reshape(*lead, 8)
