"""MOC5 (Wii) container: header + frame iteration (+ fixture writer).

The reference has no MOC5 demuxer class — framing is parsed inline in the
player (MobiclipDecoder/Form1.cs:282-320): magic `MOC5`, frame data at
`u32@0x4 + 8`, fps = `u32@0xC / 128`, width/height at 0x1C/0x20; per frame a
u32 block size, video payload 8 bytes in, advance by `4 + (blocksize & ~1)`
then align to 4.  Video decodes with the Moflex3DS profile; the audio format
is unknown upstream too (README.md:14) and is skipped, matching behavior.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Iterator


@dataclasses.dataclass
class Moc5Header:
    data_offset: int
    fps: float
    width: int
    height: int

    @classmethod
    def parse(cls, data: bytes) -> "Moc5Header":
        if data[:4] != b"MOC5":
            raise ValueError("not a MOC5 file")
        return cls(
            data_offset=struct.unpack_from("<I", data, 0x4)[0] + 8,
            fps=struct.unpack_from("<I", data, 0xC)[0] / 128.0,
            width=struct.unpack_from("<I", data, 0x1C)[0],
            height=struct.unpack_from("<I", data, 0x20)[0])


class Moc5Demuxer:
    def __init__(self, data: bytes):
        self.data = data
        self.header = Moc5Header.parse(data)

    def frames(self) -> Iterator[bytes]:
        """Yields per-frame video packets (payload starting at block+8, like
        the player's `d.Offset = offs + 8`; the decoder consumes what it
        needs and the iterator advances by the block size)."""
        data = self.data
        offs = self.header.data_offset
        while offs + 4 <= len(data):
            blocksize = struct.unpack_from("<I", data, offs)[0]
            start = offs + 8
            offs += 4 + (blocksize & ~1)
            while offs % 4:
                offs += 1
            if start >= len(data):
                return
            yield data[start:min(offs + 8, len(data))]


class Moc5Muxer:
    """Fixture writer for the same framing."""

    def __init__(self, width: int, height: int, fps: float = 30.0):
        self.width, self.height = width, height
        self.fps = fps
        self.frames: list[bytes] = []

    def add_frame(self, video: bytes) -> None:
        self.frames.append(video)

    def to_bytes(self) -> bytes:
        header = bytearray(0x28)
        header[0:4] = b"MOC5"
        struct.pack_into("<I", header, 0x4, 0x28 - 8)  # data at 0x28
        struct.pack_into("<I", header, 0xC, int(self.fps * 128))
        struct.pack_into("<I", header, 0x1C, self.width)
        struct.pack_into("<I", header, 0x20, self.height)
        out = bytearray(header)
        for f in self.frames:
            # payload begins at block+8: 4-byte size + 4 opaque bytes
            blocksize = ((len(f) + 4 + 1) & ~1) + 2  # covers payload+4, even
            out += struct.pack("<I", blocksize)
            out += b"\x00\x00\x00\x00"
            out += f
            pad = (4 + (blocksize & ~1)) - (4 + 4 + len(f))
            out += bytes(max(pad, 0))
            while len(out) % 4:
                out += b"\x00"
        return bytes(out)
