"""IMA ADPCM audio decoder — NumPy oracle.

Mirror of the reference app-level decoder (MobiclipDecoder/IMAADPCMDecoder.cs:
9-52 + IMAADPCMConst.cs): 4-byte init `{s16 index & 0x7F, s16 last}`, then two
nibbles per byte; diff = step/8 + step/4*b0 + step/2*b1 + step*b2 with the
step looked up at the *pre-update* index; sign bit b3; index advanced by the
standard IMA index table and clamped to [0, 88].

The TPU path (ops/adpcm.py) reformulates the recurrences as two associative
scans; tests check it bit-exact against this oracle.
"""
from __future__ import annotations

import numpy as np

# Standard IMA tables (IMAADPCMConst.cs:11-31)
INDEX_TABLE = np.array([-1, -1, -1, -1, 2, 4, 6, 8], dtype=np.int32)
STEP_TABLE = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28,
    31, 34, 37, 41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107,
    118, 130, 143, 157, 173, 190, 209, 230, 253, 279, 307, 337, 371, 408,
    449, 494, 544, 598, 658, 724, 796, 876, 963, 1060, 1166, 1282, 1411,
    1552, 1707, 1878, 2066, 2272, 2499, 2749, 3024, 3327, 3660, 4026,
    4428, 4871, 5358, 5894, 6484, 7132, 7845, 8630, 9493, 10442, 11487,
    12635, 13899, 15289, 16818, 18500, 20350, 22385, 24623, 27086, 29794,
    32767], dtype=np.int32)


class ImaAdpcmDecoder:
    """Stateful per-channel decoder (IMAADPCMDecoder.cs:9-52)."""

    def __init__(self) -> None:
        self.is_init = False
        self.last = 0
        self.index = 0

    def decode(self, data: bytes, offset: int, length: int) -> np.ndarray:
        """GetWaveData: returns int16 samples; the first call consumes a
        4-byte state header (index @+0 masked to 7 bits, last @+2)."""
        if not self.is_init:
            self.last = int(np.frombuffer(data, "<i2", 1, offset + 2)[0])
            self.index = int(np.frombuffer(data, "<i2", 1, offset)[0]) & 0x7F
            offset += 4
            length -= 4
            self.is_init = True
        out = np.empty(length * 2, dtype=np.int16)
        last, index = self.last, self.index
        pos = 0
        for b in data[offset:offset + length]:
            for half in (b & 0xF, b >> 4):
                step = int(STEP_TABLE[index])
                diff = (step >> 3) + (step >> 2) * (half & 1) \
                    + (step >> 1) * ((half >> 1) & 1) + step * ((half >> 2) & 1)
                samp = last + (-diff if half & 8 else diff)
                last = max(-32768, min(32767, samp))
                index = max(0, min(88, index + int(INDEX_TABLE[half & 7])))
                out[pos] = last
                pos += 1
        self.last, self.index = last, index
        return out


def encode_ima(samples: np.ndarray, index0: int = 0) -> bytes:
    """Minimal IMA encoder (test-vector generator): packs int16 samples into
    the MODS packet format with the 4-byte state header.  Greedy nearest-level
    quantization; output decodes to *some* valid waveform, which is all the
    bit-exactness tests need."""
    samples = np.asarray(samples, dtype=np.int64)
    last = int(samples[0]) if len(samples) else 0
    index = index0
    nibbles = []
    for s in samples:
        step = int(STEP_TABLE[index])
        diff = int(s) - last
        code = 8 if diff < 0 else 0
        diff = abs(diff)
        if diff >= step:
            code |= 4
            diff -= step
        if diff >= step >> 1:
            code |= 2
            diff -= step >> 1
        if diff >= step >> 2:
            code |= 1
        d = (step >> 3) + (step >> 2) * (code & 1) \
            + (step >> 1) * ((code >> 1) & 1) + step * ((code >> 2) & 1)
        last = max(-32768, min(32767, last + (-d if code & 8 else d)))
        index = max(0, min(88, index + int(INDEX_TABLE[code & 7])))
        nibbles.append(code)
    if len(nibbles) & 1:
        nibbles.append(0)
    first = int(samples[0]) if len(samples) else 0
    hdr = int(index0).to_bytes(2, "little") \
        + (first & 0xFFFF).to_bytes(2, "little")
    body = bytes((nibbles[i] | (nibbles[i + 1] << 4))
                 for i in range(0, len(nibbles), 2))
    return hdr + body
