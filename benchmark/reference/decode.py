"""The plain reference: what a decode of the benchmark's inputs must give.

Video: the frozen numpy oracle (``oracle_video.py``, the spec) decodes each
stream's packets in order; a frame is its Y rows then its UV rows (U in
columns [0, S/2), V in [S/2, S)), at the stride S.  Audio: the frozen host
IMA decoder (``audio_ima.py``), driven as the reference converter and
player drive it.  Nothing here reads what the decoder under test made: the
inputs are the generator's packets, not the container's demuxed bytes.

Each function is a module-level task for a process pool.  ``decoder``
names the oracle class to use as "module:Class", so the benchmark's own
counting oracle and its control run through the same code.
"""
from __future__ import annotations

import importlib

import numpy as np

from .audio_ima import ImaAdpcmDecoder
from .oracle_video import MobiclipVersion, OracleDecoder


def _decoder_class(decoder: str | None):
    if decoder is None:
        return OracleDecoder
    mod, cls = decoder.split(":")
    return getattr(importlib.import_module(mod), cls)


def decode_video(width: int, height: int, version: str,
                 packets: list[bytes], decoder: str | None = None):
    """(frames (N, HH, S) uint8, per-frame extras) for one stream's
    packets, decoded in order by one oracle.  The extras are what the
    decoder class's ``frame_extras()`` returns after each frame (the
    counting oracle's counts), or None."""
    dec = _decoder_class(decoder)(width, height, MobiclipVersion[version])
    S = dec.stride
    out = np.empty((len(packets), height + height // 2, S), np.uint8)
    extras = []
    for i, pkt in enumerate(packets):
        dec.data = pkt
        dec.offset = 0
        dec.decode_frame()
        out[i, :height] = dec.y_planes[0].reshape(-1, S)
        out[i, height:] = dec.uv_planes[0].reshape(-1, S)
        if hasattr(dec, "frame_extras"):
            extras.append(dec.frame_extras())
    return out, (extras or None)


def _interleave(chans: list[np.ndarray]) -> np.ndarray:
    n = min(len(c) for c in chans)
    return np.stack([c[:n] for c in chans], axis=1).reshape(-1)


def mods_pcm(audio: list[list[bytes]]) -> list[np.ndarray]:
    """Per-frame interleaved PCM of one MODS GOP: frame f carries one IMA
    packet per channel, channels in turn (MobiConverter Program.cs:253-
    275); each channel's decoder starts afresh at the keyframe that opens
    the GOP and reads its 4-byte state from its first packet."""
    nch = len(audio[0])
    decs = [ImaAdpcmDecoder() for _ in range(nch)]
    out = []
    for pkts in audio:
        chans = []
        for c, pkt in enumerate(pkts):
            chans.append(decs[c].decode(pkt, 0, len(pkt)))
        out.append(_interleave(chans))
    return out


#: bytes a Moflex demuxer appends to each frame it delivers, for the
#: bit reader's over-read (MoLiveDemux.cs:353)
MOFLEX_PAD = 2


def moflex_pcm(chunk: bytes, channels: int) -> np.ndarray:
    """Interleaved PCM of one Moflex IMA audio chunk (Form1.cs:601-630):
    each channel's 4-byte state first, then 128-byte blocks, channels in
    turn, for as long as a whole round of blocks lies strictly before the
    end of the frame as delivered (the chunk and its over-read pad)."""
    chunk = chunk + bytes(MOFLEX_PAD)
    decs = [ImaAdpcmDecoder() for _ in range(channels)]
    for c in range(channels):
        decs[c].decode(chunk, 4 * c, 4)
    chans: list[list[np.ndarray]] = [[] for _ in range(channels)]
    off = 4 * channels
    while off + 128 * channels < len(chunk):
        for c in range(channels):
            chans[c].append(decs[c].decode(chunk, off, 128))
            off += 128
    return _interleave([np.concatenate(c) if c else np.empty(0, np.int16)
                        for c in chans])


def file_pcm(container: str, channels: int,
             gops: list[list[list[bytes]]]) -> list:
    """Each frame's interleaved PCM in a file, as the converter attaches
    it; ``gops[g][f]`` is what the container carries beside frame f of
    GOP g.

    MODS: the frame's own packets, each channel's IMA decoder restarting
    at the keyframe that opens a GOP.  Moflex: an audio chunk follows its
    video frame and is attached to the next frame, so frame 0 has none and
    the last chunk is not attached."""
    if container == "mods":
        return [p for g in gops for p in mods_pcm(g)]
    chunks = [a[0] for g in gops for a in g]
    return [None] + [moflex_pcm(c, channels) for c in chunks[:-1]]
