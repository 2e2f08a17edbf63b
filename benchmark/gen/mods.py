"""MODS (DS) container: demuxer + muxer.

Mirror of the reference ModsDemuxer (LibMobiclip/Containers/Mods/
ModsDemuxer.cs:10-119): a 0x30-byte LE header, optional per-channel 0xC34-byte
Sx codebooks at AudioOffset, a (frame_number, data_offset) keyframe index, and
per-frame records of `u32 (size << 14 | nr_audio_packets)` + payload bytes.

The keyframe index is the natural GOP-shard boundary list for distributed
batch decode (each keyframe resets all decoder state).

The muxer exists because the reference repo ships no sample files and this
image has no .NET runtime: tests synthesize container fixtures with it.
"""
from __future__ import annotations

import dataclasses
import io
import struct


@dataclasses.dataclass
class ModsHeader:
    """0x30-byte MODS header (ModsDemuxer.cs:46-64)."""

    tag_id: int           # 0x334E ('N3') enables the +4 audio-offset quirk
    tag_id_size_dword: int
    frame_count: int
    width: int
    height: int
    fps: int              # fixed-point x 2^24
    audio_codec: int      # 0 none, 1 Sx, 2 FastAudio, 3 IMA ADPCM
    nb_channel: int
    frequency: int
    biggest_frame: int
    audio_offset: int
    keyframe_index_offset: int
    keyframe_count: int

    @classmethod
    def parse(cls, data: bytes) -> "ModsHeader":
        if data[:4] != b"MODS":
            raise ValueError("not a MODS file")
        f = struct.unpack_from("<HHIIIIHHIIIII", data, 4)
        return cls(*f)

    def pack(self) -> bytes:
        return b"MODS" + struct.pack(
            "<HHIIIIHHIIIII", self.tag_id, self.tag_id_size_dword,
            self.frame_count, self.width, self.height, self.fps,
            self.audio_codec, self.nb_channel, self.frequency,
            self.biggest_frame, self.audio_offset,
            self.keyframe_index_offset, self.keyframe_count)

    @property
    def fps_float(self) -> float:
        return self.fps / (1 << 24)


class ModsDemuxer:
    """Pull-style demuxer (ModsDemuxer.cs:97-117)."""

    def __init__(self, data: bytes):
        self.data = data
        self.header = ModsHeader.parse(data[:0x30])
        h = self.header
        self.audio_codebooks: list[bytes] = []
        if h.audio_offset != 0:
            pos = h.audio_offset
            for _ in range(h.nb_channel):
                self.audio_codebooks.append(data[pos:pos + 0xC34])
                pos += 0xC34
        self.keyframes: list[tuple[int, int]] = []
        pos = h.keyframe_index_offset
        for _ in range(h.keyframe_count):
            fn, off = struct.unpack_from("<II", data, pos)
            self.keyframes.append((fn, off))
            pos += 8
        self._next_key = 0
        self.cur_frame = 0
        self.pos = 0x30
        if self.keyframes:
            self.jump_to_keyframe(0)

    def jump_to_keyframe(self, k: int) -> None:
        """JumpToKeyFrame (ModsDemuxer.cs:88-95) — checkpoint/seek support."""
        if k >= len(self.keyframes):
            return
        self.cur_frame, self.pos = self.keyframes[k]
        self._next_key = k + 1 if k + 1 < len(self.keyframes) else -1

    def read_frame(self) -> tuple[bytes, int, bool] | None:
        """Returns (packet, nr_audio_packets, is_keyframe) or None at EOF."""
        if self.cur_frame >= self.header.frame_count:
            return None
        is_key = False
        if 0 <= self._next_key < len(self.keyframes) \
                and self.cur_frame == self.keyframes[self._next_key][0]:
            is_key = True
            self._next_key = self._next_key + 1 \
                if self._next_key + 1 < len(self.keyframes) else -1
        self.cur_frame += 1
        info = struct.unpack_from("<I", self.data, self.pos)[0]
        self.pos += 4
        size = info >> 14
        nr_audio = info & 0x3FFF
        pkt = self.data[self.pos:self.pos + size]
        self.pos += size
        return pkt, nr_audio, is_key


class ModsMuxer:
    """Writes a MODS file from per-frame (video_payload, audio_packets)."""

    def __init__(self, width: int, height: int, fps: float = 25.0,
                 audio_codec: int = 0, nb_channel: int = 0,
                 frequency: int = 0, tag_id: int = 0x324E):
        self.width, self.height = width, height
        self.fps_fixed = int(fps * (1 << 24))
        self.audio_codec = audio_codec
        self.nb_channel = nb_channel
        self.frequency = frequency
        self.tag_id = tag_id
        self.frames: list[tuple[bytes, int, bool]] = []
        self.codebooks: list[bytes] = []

    def add_frame(self, video: bytes, audio_packets: list[bytes] | None = None,
                  keyframe: bool = False) -> None:
        """``video`` must be the exact byte-aligned video payload (no padding):
        the decoder's final bitstream offset lands at len(video) + 2, and
        audio starts at offset-2 == len(video) (Program.cs:250-252)."""
        audio = b"".join(audio_packets or [])
        n_audio = len(audio_packets or [])
        payload = video + (audio if audio else b"\x00\x00")
        self.frames.append((payload, n_audio, keyframe))

    def to_bytes(self) -> bytes:
        body = io.BytesIO()
        frame_start = 0x30
        body.seek(frame_start)
        keyframes = []
        biggest = 0
        for i, (payload, n_audio, is_key) in enumerate(self.frames):
            if is_key:
                keyframes.append((i, body.tell()))
            body.write(struct.pack("<I", (len(payload) << 14) | n_audio))
            body.write(payload)
            biggest = max(biggest, len(payload))
        audio_offset = 0
        if self.codebooks:
            audio_offset = body.tell()
            for cb in self.codebooks:
                assert len(cb) == 0xC34
                body.write(cb)
        kf_offset = body.tell()
        for fn, off in keyframes:
            body.write(struct.pack("<II", fn, off))
        hdr = ModsHeader(
            tag_id=self.tag_id, tag_id_size_dword=0,
            frame_count=len(self.frames), width=self.width,
            height=self.height, fps=self.fps_fixed,
            audio_codec=self.audio_codec, nb_channel=self.nb_channel,
            frequency=self.frequency, biggest_frame=biggest,
            audio_offset=audio_offset, keyframe_index_offset=kf_offset,
            keyframe_count=len(keyframes))
        out = body.getvalue()
        return hdr.pack() + out[0x30:]
