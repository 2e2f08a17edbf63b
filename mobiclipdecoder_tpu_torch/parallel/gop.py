"""GOP sharding: distributing a decode corpus across chips and hosts.

The codec's scaling axes (SURVEY.md §5) and how they map here:

* **across GOPs / files** — fully parallel (keyframes reset every piece of
  decoder state).  This module cuts container files into GOP shards using
  the containers' native boundaries (MODS keyframe index, the I-frame
  bit of Moflex and MOC5 packets) and assigns them round-robin to
  workers.  A shard is idempotent and restartable: (file, gop_index) is
  the checkpoint unit, mirroring the reference's JumpToKeyFrame seek
  design (ModsDemuxer.cs:88-95).
* **across streams on one chip** — parallel/batch.py lockstep batching.
* **across chips in one process** — the batch axis sharded over the mesh's
  "data" axis (jax.sharding); ICI carries nothing between streams (they are
  independent), so scaling is embarrassingly parallel by construction and
  efficiency is bounded by host scan throughput, not collectives.
* **across hosts** — `jax.distributed` + per-host shard lists; results
  gather host-side (DCN).  Bit-exactness means every payload is integer.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from ..containers.mods import ModsDemuxer


@dataclasses.dataclass(frozen=True)
class GopShard:
    """One independently decodable unit of work."""

    file_id: int
    gop_index: int
    first_frame: int
    frame_count: int
    packets: tuple[bytes, ...]
    audio_counts: tuple[int, ...]


def shard_mods(data: bytes, file_id: int = 0) -> list[GopShard]:
    """Cut a MODS file into GOP shards at its keyframe index entries."""
    dm = ModsDemuxer(data)
    frames: list[tuple[bytes, int]] = []
    keyflags: list[bool] = []
    # demuxer quirk: the first keyframe is never flagged (ModsDemuxer.cs
    # constructor skips it) — treat frame 0 as a boundary regardless
    while (rec := dm.read_frame()) is not None:
        pkt, n_audio, is_key = rec
        frames.append((pkt, n_audio))
        keyflags.append(is_key)
    if frames:
        keyflags[0] = True
    shards = []
    start = 0
    for i in range(1, len(frames) + 1):
        if i == len(frames) or keyflags[i]:
            shards.append(GopShard(
                file_id=file_id, gop_index=len(shards), first_frame=start,
                frame_count=i - start,
                packets=tuple(p for p, _ in frames[start:i]),
                audio_counts=tuple(n for _, n in frames[start:i])))
            start = i
    return shards


def shard_moflex(data: bytes, file_id: int = 0,
                 video_stream: int | None = None) -> list[GopShard]:
    """Cut a Moflex file's video stream into GOP shards at its I-frames.

    Moflex has no keyframe index; the cut points are the frames whose
    Mobiclip header marks an I-frame — bit 31 of the bit reader's initial
    register, i.e. bit 7 of the packet's second byte (the decoder seeds
    r3 = u16LE << 16, MobiclipDecoder.cs:110-113).  Synchro headers with
    timestamps are the container-level resume points (MoLiveDemux.cs:124).
    """
    from ..containers.moflex import (MoflexDemuxer, VideoStream,
                                     VideoStreamWithLayout)
    frames: list[bytes] = []
    state = {"vid": video_stream}

    def on_frame(chunk, payload):
        if isinstance(chunk, (VideoStream, VideoStreamWithLayout)):
            if state["vid"] is None:
                state["vid"] = chunk.stream_index
            if chunk.stream_index == state["vid"]:
                frames.append(payload)
    dm = MoflexDemuxer(data, on_frame=on_frame)
    last = -1
    stall = 0
    while True:
        r = dm.read_packet()
        if r in (1, 0x80):
            break
        if dm.position == last:
            stall += 1
            if stall > 2:
                break
        else:
            stall = 0
        last = dm.position
    return _iframe_shards(frames, file_id)


def shard_moc5(data: bytes, file_id: int = 0) -> list[GopShard]:
    """Cut a MOC5 (Wii) file into GOP shards at its I-frames.

    MOC5 has no keyframe index and carries no decodable audio
    (Form1.cs:282-320, README.md:14); its frames use the Moflex3DS profile,
    so the cut points are ``shard_moflex``'s I-frame bit."""
    from ..containers.moc5 import Moc5Demuxer
    return _iframe_shards(list(Moc5Demuxer(data).frames()), file_id)


def _iframe_shards(frames: list[bytes], file_id: int) -> list[GopShard]:
    """Video-only shards of ``frames``, cut before each packet with the
    I-frame bit (bit 7 of its second byte); frame 0 always opens one."""
    keyflags = [len(p) >= 2 and bool(p[1] & 0x80) for p in frames]
    if frames:
        keyflags[0] = True
    shards = []
    start = 0
    for i in range(1, len(frames) + 1):
        if i == len(frames) or keyflags[i]:
            shards.append(GopShard(
                file_id=file_id, gop_index=len(shards), first_frame=start,
                frame_count=i - start, packets=tuple(frames[start:i]),
                audio_counts=tuple(0 for _ in range(i - start))))
            start = i
    return shards


def assign_shards(shards: list[GopShard], n_workers: int,
                  worker_id: int) -> list[GopShard]:
    """Deterministic round-robin assignment (size-balanced greedy)."""
    order = sorted(range(len(shards)),
                   key=lambda i: -sum(len(p) for p in shards[i].packets))
    loads = [0] * n_workers
    mine = []
    for i in order:
        w = int(np.argmin(loads))
        loads[w] += sum(len(p) for p in shards[i].packets)
        if w == worker_id:
            mine.append(shards[i])
    return sorted(mine, key=lambda s: (s.file_id, s.gop_index))


class ShardProgress:
    """Completion ledger: per-(file, gop) done markers make a batch job
    restartable from partial progress (the checkpoint/resume story — decoder
    state itself is never checkpointed because keyframes reset everything,
    DecodeVXS2 I-branch reads absolute QP, MobiclipDecoder.cs:231-236)."""

    def __init__(self) -> None:
        self.done: set[tuple[int, int]] = set()

    def mark(self, shard: GopShard) -> None:
        self.done.add((shard.file_id, shard.gop_index))

    def pending(self, shards: list[GopShard]) -> list[GopShard]:
        return [s for s in shards
                if (s.file_id, s.gop_index) not in self.done]
