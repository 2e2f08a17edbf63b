"""The work a decode must do, counted from the stream content alone.

The counts come from the frozen reference's parse of each frame
(``CountingOracle``): blocks by kind, the coded transform blocks with their
sizes and nonzero coefficients, the pixels each block writes, and the
reference frames each frame's motion compensation reads.  Nothing here
reads the decoder's packed arrays, so a change to the op-row or blob
layout does not move these numbers.

From them, ``k1_bytes`` and ``k5_bytes`` give the least bytes the executor
(K1) and the prologue (K5) must move for one launch: each input read once,
each output written once.  A kernel's roofline share is the time those
bytes take at the card's memory rate over the kernel's device time.
"""
from __future__ import annotations

from ..reference.oracle_video import OracleDecoder

#: NVIDIA H100 SXM, published: HBM3 at 3.35 TB/s.  Both kernels are bound
#: by bytes (their operations at the published 67 TFLOP/s 32-bit rate take
#: under a tenth of the bytes' time), so only the memory rate is used.
HBM_BYTES_PER_S = 3.35e12
#: one block's record as the scanner emits it (3 words) and as the
#: executor reads it (4 words)
RECORD_IN, RECORD_OUT = 12, 16
#: bytes of one spatial residual sample (int32)
SAMPLE = 4
#: bytes of one coded nonzero coefficient: its position (int32) and its
#: dequantized value (int16)
NONZERO = 6
#: the intra predictor's tables, read once by a launch that has intra
#: blocks: 20 tables of 256 int32
INTRA_TABLES = 20 * 256 * 4


class CountingOracle(OracleDecoder):
    """The frozen oracle, decoding as usual, that also counts each frame's
    work; ``frame_extras()`` returns the counts of the frame just decoded."""

    def decode_frame(self, rgb=False):
        self._c = {"mc": 0, "resid": 0, "intra": 0, "coded": 0,
                   "coded_samples": 0, "nonzeros": 0, "pixels": 0,
                   "refs": set(), "intra_blocks": 0}
        return super().decode_frame(rgb)

    def _coded(self, size, coefs) -> None:
        dense, _last = coefs
        c = self._c
        c["coded"] += 1
        c["coded_samples"] += size * size
        c["nonzeros"] += int((dense != 0).sum())

    def _exec_mc(self, w, h, ref, dx, dy, off):
        c = self._c
        c["mc"] += 1
        c["pixels"] += w * h + 2 * (w >> 1) * (h >> 1)
        c["refs"].add(int(ref))
        super()._exec_mc(w, h, ref, dx, dy, off)

    def _exec_intra(self, plane, off, size, mode, gradient, coefs):
        c = self._c
        c["intra"] += 1
        c["pixels"] += size * size
        if coefs is not None:
            self._coded(size, coefs)
        super()._exec_intra(plane, off, size, mode, gradient, coefs)

    def _exec_resid(self, plane, off, size, coefs):
        self._c["resid"] += 1
        self._c["pixels"] += size * size
        self._coded(size, coefs)
        super()._exec_resid(plane, off, size, coefs)

    def _exec_plane16(self, off, gradient):
        self._c["intra"] += 1
        self._c["pixels"] += 256
        super()._exec_plane16(off, gradient)

    def frame_extras(self) -> dict:
        c = dict(self._c)
        c["refs"] = sorted(c["refs"])
        return c


def frame_bytes(height: int, stride: int) -> int:
    """One frame as the user gets it: H luma rows and H/2 chroma rows of
    ``stride`` samples."""
    return (height + height // 2) * stride


def k1_bytes(counts: list[list[dict]], first: list[int], height: int,
             stride: int) -> dict:
    """The executor's least traffic for one launch.

    ``counts[b]`` is stream b's per-frame counts for the launch's frames,
    and ``first[b]`` the stream index of its first frame.  Terms: each
    block's record read; each coded block's spatial residual read; each
    reference frame read that an earlier launch made (a frame this launch
    makes is not read back); the intra tables; each frame written out, and
    the last (at most 6) frames of each stream written to its reference
    ring."""
    plane = frame_bytes(height, stride)
    F = len(counts[0])
    records = sum(c["mc"] + c["resid"] + c["intra"]
                  for s in counts for c in s)
    samples = sum(c["coded_samples"] for s in counts for c in s)
    planes_in = 0
    for s, f0 in zip(counts, first):
        srcs = {f0 + i - r for i, c in enumerate(s) for r in c["refs"]}
        planes_in += sum(1 for k in srcs if k < f0)
    intra = any(c["intra"] for s in counts for c in s)
    terms = {"records": records * RECORD_OUT,
             "residuals": samples * SAMPLE,
             "references": planes_in * plane,
             "tables": INTRA_TABLES if intra else 0,
             "frames": F * len(counts) * plane,
             "ring": min(F, 6) * len(counts) * plane}
    return {"bytes": sum(terms.values()), "terms": terms,
            "planes_in": planes_in}


def k5_bytes(counts: list[list[dict]]) -> dict:
    """The prologue's least traffic for one launch: each block's record
    read as emitted and written widened, each nonzero coefficient read,
    one size bit per coded block, each coded block's spatial residual
    written."""
    records = sum(c["mc"] + c["resid"] + c["intra"]
                  for s in counts for c in s)
    coded = sum(c["coded"] for s in counts for c in s)
    terms = {"records": records * (RECORD_IN + RECORD_OUT),
             "nonzeros": sum(c["nonzeros"] for s in counts for c in s)
             * NONZERO,
             "sizes": (coded + 7) // 8,
             "residuals": sum(c["coded_samples"] for s in counts for c in s)
             * SAMPLE}
    return {"bytes": sum(terms.values()), "terms": terms}


def launches(n_frames: int, per_launch: int) -> list[tuple[int, int]]:
    """The [start, end) frame ranges of a stream decoded ``per_launch``
    frames at a time."""
    return [(a, min(a + per_launch, n_frames))
            for a in range(0, n_frames, per_launch)]


def content(packets: list[bytes], counts: list[dict], width: int,
            height: int, fps: float) -> dict:
    """What the traffic's streams hold, per frame, for holding the
    generated content against figures of real files: bytes per I- and
    P-frame, the bit rate at the configuration's frame rate, and the coded
    transform blocks and nonzero coefficients per macroblock.  ``packets``
    and ``counts`` are the frames' packets and frozen counts, in step;
    an I-frame is a frame with no motion-compensated block."""
    mbs = (width // 16) * (height // 16)
    kinds = {"i": [], "p": []}
    for pkt, c in zip(packets, counts):
        kinds["p" if c["mc"] else "i"].append(len(pkt))
    n = len(counts)
    return {
        "frames": n,
        "i_frame_bytes": (sum(kinds["i"]) / len(kinds["i"])
                          if kinds["i"] else None),
        "p_frame_bytes": (sum(kinds["p"]) / len(kinds["p"])
                          if kinds["p"] else None),
        "kbit_per_s": sum(len(p) for p in packets) * 8 * fps / n / 1e3,
        "coded_blocks_per_mb": sum(c["coded"] for c in counts) / n / mbs,
        "nonzeros_per_mb": sum(c["nonzeros"] for c in counts) / n / mbs,
    }
