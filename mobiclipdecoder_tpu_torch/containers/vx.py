"""Vx (old DS) and VX2 (raw homebrew) containers.

Vx: header + keyframe index only — frame reading is commented out upstream
(LibMobiclip/Containers/Vx/VxDemuxer.cs:88-98) and the Vx video profile is a
stub (MobiclipDecoder.cs:63-95, README.md:13), so this is documented stub
parity: the header parses, decode raises NotImplementedError.

VX2: no header at all (MobiclipDecoder/Form1.cs:227-280,
MobiConverter/Program.cs:367-438): every `rate` frames a raw 32768-sample
mono PCM16 chunk, then u32-LE length + a Moflex3DS-profile Mobiclip frame at
256x192.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Iterator


@dataclasses.dataclass
class VxHeader:
    """`VXDS` header with two layout variants disambiguated by
    ChannelCount > 16 (VxDemuxer.cs:42-60)."""

    frame_count: int
    width: int
    height: int
    fps: int
    unknown: int
    frequency: int
    channel_count: int
    biggest_frame: int
    audio_offset: int
    keyframe_index_offset: int
    keyframe_count: int

    @classmethod
    def parse(cls, data: bytes) -> "VxHeader":
        frame_count, width, height, fps, unknown, frequency, channel_count = \
            struct.unpack_from("<7I", data, 4)
        if channel_count > 16:
            channel_count = 0
            biggest, audio_off, kf_off, kf_count = \
                struct.unpack_from("<4I", data, 0x1C)
        else:
            biggest, audio_off, kf_off, kf_count = \
                struct.unpack_from("<4I", data, 0x20)
        return cls(frame_count, width, height, fps, unknown, frequency,
                   channel_count, biggest, audio_off, kf_off, kf_count)


class VxDemuxer:
    """Header + keyframe index (VxDemuxer.cs:14-29); ReadFrame is stub
    parity with the reference's commented-out implementation."""

    def __init__(self, data: bytes):
        self.data = data
        self.header = VxHeader.parse(data[:0x30])
        self.keyframes: list[tuple[int, int]] = []
        pos = self.header.keyframe_index_offset
        for _ in range(self.header.keyframe_count):
            fn, off = struct.unpack_from("<II", data, pos)
            self.keyframes.append((fn, off))
            pos += 8

    def read_frame(self):
        raise NotImplementedError(
            "Vx frame decode is a stub in the reference too "
            "(VxDemuxer.cs:88-98, MobiclipDecoder.cs:63-95)")


VX2_WIDTH, VX2_HEIGHT = 256, 192
VX2_AUDIO_SAMPLES = 32768
VX2_AUDIO_RATE = 20  # frames per audio chunk in the converter (Program.cs:378)


class Vx2Demuxer:
    """Raw VX2 iteration (Program.cs:367-438)."""

    def __init__(self, data: bytes, audio_every: int = VX2_AUDIO_RATE):
        self.data = data
        self.audio_every = audio_every

    def frames(self) -> Iterator[tuple[bytes, bytes | None]]:
        """Yields (video_packet, pcm16_bytes_or_None) per frame."""
        pos = 0
        frame = 0
        data = self.data
        while pos < len(data):
            pcm = None
            if frame % self.audio_every == 0:
                pcm = data[pos:pos + VX2_AUDIO_SAMPLES * 2]
                pos += VX2_AUDIO_SAMPLES * 2
            if pos + 4 > len(data):
                return
            length = struct.unpack_from("<I", data, pos)[0]
            pos += 4
            if pos + length > len(data):
                return
            yield data[pos:pos + length], pcm
            pos += length
            frame += 1


class Vx2Muxer:
    """Fixture writer for the raw VX2 layout."""

    def __init__(self, audio_every: int = VX2_AUDIO_RATE):
        self.audio_every = audio_every
        self.out = bytearray()
        self.frame = 0

    def add_frame(self, video: bytes, pcm: bytes | None = None) -> None:
        if self.frame % self.audio_every == 0:
            chunk = pcm or bytes(VX2_AUDIO_SAMPLES * 2)
            assert len(chunk) == VX2_AUDIO_SAMPLES * 2
            self.out += chunk
        self.out += struct.pack("<I", len(video)) + video
        self.frame += 1

    def to_bytes(self) -> bytes:
        return bytes(self.out)
