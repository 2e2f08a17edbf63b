"""MOC5 (Wii) files for the benchmark: a writer and the video-only GOPs.

The reference has no MOC5 demuxer class; the player parses the framing
inline (MobiclipDecoder/Form1.cs:282-320): magic ``MOC5``, the first frame
at ``u32@0x4 + 8``, the frame rate as ``u32@0xC / 128``, width and height
at 0x1C and 0x20.  Each frame is a block: a u32 size, 4 bytes the player
skips, then the video payload (``offs + 8``); the next block starts
``4 + (size & ~1)`` bytes on, rounded up to a multiple of 4.  The video
uses the Moflex3DS profile (``:291``).  The audio's format is unknown
upstream (README.md:14), so these files carry none.

``file_gop`` follows ``traffic.file_gop``'s seeding, so a file's GOPs are
made in parallel from the seed, each referencing nothing before its
I-frame.
"""
from __future__ import annotations

import struct

from .traffic import version_of
from .synth import StreamSynthesizer

#: bytes of the header this writer emits; the first block follows it
HEADER = 0x30
#: zero bytes at least after each payload, for the bit reader's over-read
TAIL = 2


def file_gop(cfg: dict, seed: int, file: int, gop: int, frames: int,
             qp: int) -> dict:
    """One GOP of one file: its video packets (unpadded) and, beside each
    frame, no audio."""
    syn = StreamSynthesizer(cfg["width"], cfg["height"], version_of(cfg),
                            seed=[int(seed), 2, int(file), int(gop)])
    video = [syn.iframe(qp, pad=False) if f == 0 else syn.pframe(pad=False)
             for f in range(frames)]
    return {"video": video, "audio": [[] for _ in range(frames)]}


def mux_file(cfg: dict, gops: list[dict]) -> bytes:
    """The MOC5 bytes of a file made of ``gops`` (``file_gop``)."""
    head = bytearray(HEADER)
    head[0:4] = b"MOC5"
    struct.pack_into("<I", head, 0x4, HEADER - 8)
    struct.pack_into("<I", head, 0xC, int(round(cfg["fps"] * 128)))
    struct.pack_into("<I", head, 0x1C, cfg["width"])
    struct.pack_into("<I", head, 0x20, cfg["height"])
    out = bytearray(head)
    for g in gops:
        for video in g["video"]:
            pad = TAIL + (-(len(video) + TAIL) % 4)
            # the size counts the skipped word, the payload and its pad,
            # so the next block starts 4-aligned
            out += struct.pack("<I", 4 + len(video) + pad)
            out += bytes(4) + video + bytes(pad)
    return bytes(out)
