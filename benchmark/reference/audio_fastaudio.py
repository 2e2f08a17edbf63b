"""FastAudio audio decoder — NumPy oracle, frozen for the benchmark, and
the player's loop over a Moflex FastAudio chunk.

``FastAudioDecoder`` mirrors the reference (LibMobiclip/Codec/FastAudio/
FastAudioDecoder.cs:9-381): each 40-byte packet yields 256 samples.  Ten
u32 fields (read as LE u16 pairs) unpack into 8 LPC coefficients via seven
quantization tables plus four sub-blocks of 21 pulses each with
bitrate-dependent amplitude tables; synthesis is an 8-tap lattice filter
followed by a fixed 0x6E14 de-emphasis and a x2 saturating gain.  State
across packets: the filter history and de-emphasis accumulator
(Internal[100..109]).

``moflex_pcm`` drives one decoder a channel over a stream's chunks as the
player does (Form1.cs:561-599).
"""
from __future__ import annotations

import numpy as np

from .tables import TABLES

#: bytes a Moflex demuxer appends to each frame it delivers, for the
#: video bit reader's over-read (MoLiveDemux.cs:353)
MOFLEX_PAD = 2


def _s32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


class FastAudioDecoder:
    """Stateful per-channel decoder (FastAudioDecoder.cs:9-72)."""

    def __init__(self) -> None:
        self.data: bytes = b""
        self.offset = 0
        self.internal = np.zeros(113, dtype=np.uint32)
        t = TABLES
        self._q = [t.fa_lpc_q0, t.fa_lpc_q1, t.fa_lpc_q2, t.fa_lpc_q3,
                   t.fa_lpc_q4, t.fa_lpc_q5, t.fa_lpc_q6]
        self._pulse = t.fa_pulse

    def _read_u32(self) -> int:
        lo = self.data[self.offset] | (self.data[self.offset + 1] << 8)
        hi = self.data[self.offset + 2] | (self.data[self.offset + 3] << 8)
        self.offset += 4
        return lo | (hi << 16)

    def _unpack(self) -> None:
        """sub_C48 (FastAudioDecoder.cs:130-285)."""
        inr = self.internal
        q = self._q
        r3 = self._read_u32()
        inr[0] = q[0][r3 >> 26] & 0xFFFFFFFF
        inr[1] = q[0][(r3 >> 20) & 0x3F] & 0xFFFFFFFF
        inr[2] = q[1][(r3 >> 15) & 0x1F] & 0xFFFFFFFF
        inr[3] = q[2][(r3 >> 10) & 0x1F] & 0xFFFFFFFF
        inr[4] = q[3][(r3 >> 6) & 0xF] & 0xFFFFFFFF
        inr[6] = q[4][(r3 >> 3) & 0x7] & 0xFFFFFFFF
        inr[7] = q[5][r3 & 0x7] & 0xFFFFFFFF
        r3 = self._read_u32()
        inr[15] = r3 >> 26
        inr[14] = (r3 >> 20) & 0x3F
        inr[13] = (r3 >> 14) & 0x3F
        inr[12] = (r3 >> 8) & 0x3F
        inr[11] = (r3 >> 6) & 3
        inr[10] = (r3 >> 4) & 3
        inr[9] = (r3 >> 2) & 3
        inr[8] = r3 & 3
        lowbits = []
        for grp in range(4):
            ra = self._read_u32()
            base = 16 + grp * 21
            shifts = (29, 26, 23, 20, 17, 14, 11, 8, 5, 2)
            for k, sh in enumerate(shifts):
                inr[base + k] = (ra >> sh) & 7
            rb = self._read_u32()
            for k, sh in enumerate(shifts):
                inr[base + 10 + k] = (rb >> sh) & 7
            inr[base + 20] = ((rb >> 1) & 1) | ((ra & 3) << 1)
            lowbits.append(rb & 1)
        idx5 = lowbits[3] | (lowbits[2] << 1) | (lowbits[1] << 2) \
            | (lowbits[0] << 3)
        inr[5] = q[6][idx5] & 0xFFFFFFFF

    @staticmethod
    def _pulse_block(out: np.ndarray, dst: int, pulses: np.ndarray,
                     zeros_before: int) -> int:
        """sub_11F4 (FastAudioDecoder.cs:287-311): sparse pulse train — N
        leading zeros, 20 x {pulse, 0, 0}, final pulse, (3 - N) zeros."""
        for _ in range(zeros_before):
            out[dst] = 0
            dst += 1
        for i in range(20):
            out[dst] = pulses[i]
            out[dst + 1] = 0
            out[dst + 2] = 0
            dst += 3
        out[dst] = pulses[20]
        dst += 1
        for _ in range(3 - zeros_before):
            out[dst] = 0
            dst += 1
        return dst

    def excitation(self) -> tuple[np.ndarray, list[int]]:
        """Parse one packet into (excitation (256,) int64, 8 LPC coefs) —
        the bitstream half of decode(); the synthesis filter can then run
        here (decode) or batched on device (ops/audio_lpc.py)."""
        self._unpack()
        inr = self.internal
        out = np.zeros(256, dtype=np.int64)
        dst = 0
        for blk in range(4):
            toff = int(inr[12 + blk]) * 8
            idxs = inr[16 + blk * 21:16 + blk * 21 + 21].astype(np.int64)
            pulses = self._pulse[toff + idxs]
            dst = self._pulse_block(out, dst, pulses, int(inr[8 + blk]))
        coef = [_s32(int(inr[7 - j])) for j in range(8)]
        return out, coef

    def decode(self) -> np.ndarray:
        """Decode (FastAudioDecoder.cs:41-72): one 40-byte packet -> 256
        int16 samples; advances self.offset."""
        out, coef = self.excitation()
        inr = self.internal
        hist = [_s32(int(inr[107 - j])) for j in range(8)]  # j = 0..7
        r9 = _s32(int(inr[109]))
        result = np.empty(256, dtype=np.int16)
        for i in range(256):
            r5 = int(out[i])
            for j in range(8):
                r6 = coef[j]
                r7 = hist[j]
                r5 -= (r6 * r7 + 0x4000) >> 15
                hist[j] = r7 + ((r6 * r5 + 0x4000) >> 15)
            # shift history: Internal[108-j] were written; new Internal[100]=r5
            # reconstruct the array layout: hist[j] corresponds to 107-j...
            inr[100] = r5 & 0xFFFFFFFF
            for j in range(8):
                inr[108 - j] = hist[j] & 0xFFFFFFFF
            hist = [_s32(int(inr[107 - j])) for j in range(8)]
            r9 = r5 + ((r9 * 0x6E14 + 0x4000) >> 15)
            r8 = r9 * 2
            r8 = max(-32768, min(32767, r8))
            result[i] = r8
        inr[109] = r9 & 0xFFFFFFFF
        return result


def moflex_pcm(chunks: list[bytes], channels: int) -> list:
    """Each chunk's interleaved PCM, for one stream's FastAudio chunks in
    order (Form1.cs:561-599): one decoder a channel for the whole stream;
    in each chunk as delivered (with the demuxer's pad), rounds of one
    40-byte packet a channel, the channels in turn, begun while more than
    40 bytes remain.  Where a packet runs past the chunk the loop raises
    and the chunk gives no PCM (None), though the packets before it have
    advanced their decoders."""
    decs = [FastAudioDecoder() for _ in range(channels)]
    out = []
    for chunk in chunks:
        payload = chunk + bytes(MOFLEX_PAD)
        chans: list[list[np.ndarray]] = [[] for _ in range(channels)]
        off = 0
        try:
            while off + 40 < len(payload):
                for c in range(channels):
                    decs[c].data = payload
                    decs[c].offset = off
                    chans[c].append(decs[c].decode())
                    off = decs[c].offset
        except IndexError:
            out.append(None)
            continue
        arrs = [np.concatenate(c) if c else np.empty(0, np.int16)
                for c in chans]
        n = min(len(a) for a in arrs)
        out.append(np.stack([a[:n] for a in arrs], axis=1).reshape(-1))
    return out


def file_pcm(channels: int, gops: list[list[list[bytes]]]) -> list:
    """Each frame's interleaved PCM in a Moflex file whose frame f of GOP g
    has the one FastAudio chunk ``gops[g][f][0]`` muxed before its video:
    the converter attaches each chunk to the frame that follows it."""
    return moflex_pcm([a[0] for g in gops for a in g], channels)
