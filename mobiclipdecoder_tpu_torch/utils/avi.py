"""Minimal AVI (RIFF) writer + reader: uncompressed BGR24 video + PCM16.

Replaces the reference's Windows-only avifil32.dll P/Invoke wrapper
(MobiclipDecoder/IO/AVI/Avi.cs:191-262, AviManager.cs) with a portable
pure-Python muxer, so the converter CLI can emit .avi like
MobiConverter/Program.cs does (video via AddVideoStream + accumulated PCM
audio stream, Program.cs:72,176-200,329-353).  AviReader covers the
wrapper's read-back side (AviManager open + VideoStream.GetFrame,
MobiclipDecoder/IO/AVI/VideoStream.cs:24-655, AudioStream read) for
uncompressed-DIB files like the ones AviWriter emits.
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    pad = b"\x00" if len(payload) & 1 else b""
    return fourcc + struct.pack("<I", len(payload)) + payload + pad


def _list(fourcc: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", fourcc + payload)


class AviWriter:
    """Accumulate frames/audio in memory, write one interleaved AVI."""

    def __init__(self, path: str | Path, width: int, height: int,
                 fps: float, audio_rate: int = 0, audio_channels: int = 1):
        self.path = Path(path)
        self.w, self.h = width, height
        self.fps = max(fps, 1e-3)
        self.audio_rate = audio_rate
        self.audio_channels = max(audio_channels, 1)
        self._frames: list[bytes] = []
        self._audio: list[np.ndarray] = []

    def add_frame(self, rgb: np.ndarray) -> None:
        """rgb: (H, W, 3) uint8.  Stored as bottom-up BGR24 DIB rows padded
        to 4 bytes (the classic uncompressed AVI frame format)."""
        assert rgb.shape == (self.h, self.w, 3)
        bgr = rgb[::-1, :, ::-1]   # bottom-up, RGB->BGR
        row = self.w * 3
        pad = (-row) % 4
        if pad:
            bgr = np.concatenate(
                [bgr.reshape(self.h, row),
                 np.zeros((self.h, pad), np.uint8)], axis=1)
        self._frames.append(bgr.tobytes())

    def add_audio(self, pcm: np.ndarray) -> None:
        """pcm: interleaved int16 samples."""
        self._audio.append(np.asarray(pcm, dtype="<i2"))

    def close(self) -> None:
        n = len(self._frames)
        row = self.w * 3 + ((-self.w * 3) % 4)
        frame_bytes = row * self.h
        usec = int(round(1_000_000 / self.fps))
        has_audio = bool(self._audio) and self.audio_rate > 0
        pcm = (np.concatenate(self._audio) if has_audio
               else np.empty(0, "<i2"))

        avih = _chunk(b"avih", struct.pack(
            "<14I", usec, frame_bytes * max(int(self.fps), 1), 0, 0x10,
            n, 0, 2 if has_audio else 1, 0, self.w, self.h, 0, 0, 0, 0))

        strh_v = _chunk(b"strh", struct.pack(
            "<4s4sIHHIIIIIIIIhhhh", b"vids", b"DIB ", 0, 0, 0, 0,
            1000, int(round(self.fps * 1000)), 0, n, frame_bytes, 0xFFFFFFFF,
            0, 0, 0, self.w, self.h))
        strf_v = _chunk(b"strf", struct.pack(
            "<IiiHHIIiiII", 40, self.w, self.h, 1, 24, 0, frame_bytes,
            0, 0, 0, 0))
        strl_v = _list(b"strl", strh_v + strf_v)

        strls = strl_v
        if has_audio:
            block = 2 * self.audio_channels
            strh_a = _chunk(b"strh", struct.pack(
                "<4s4sIHHIIIIIIIIhhhh", b"auds", b"\x00\x00\x00\x00", 0, 0,
                0, 0, block, self.audio_rate * block, 0,
                len(pcm) // self.audio_channels, block, 0xFFFFFFFF, block,
                0, 0, 0, 0))
            strf_a = _chunk(b"strf", struct.pack(
                "<HHIIHH", 1, self.audio_channels, self.audio_rate,
                self.audio_rate * block, block, 16))
            strls += _list(b"strl", strh_a + strf_a)

        hdrl = _list(b"hdrl", avih + strls)

        movi_parts: list[bytes] = []
        idx: list[tuple[bytes, int, int]] = []
        pos = 4  # after 'movi' fourcc
        samples_per_frame = (len(pcm) // n if (has_audio and n) else 0)
        # align audio to channel blocks
        if has_audio:
            samples_per_frame -= samples_per_frame % self.audio_channels
        ap = 0
        for i, fr in enumerate(self._frames):
            c = _chunk(b"00db", fr)
            idx.append((b"00db", pos, len(fr)))
            movi_parts.append(c)
            pos += len(c)
            if has_audio:
                hi = len(pcm) if i == n - 1 else ap + samples_per_frame
                seg = pcm[ap:hi].tobytes()
                ap = hi
                if seg:
                    c = _chunk(b"01wb", seg)
                    idx.append((b"01wb", pos, len(seg)))
                    movi_parts.append(c)
                    pos += len(c)
        movi = _list(b"movi", b"".join(movi_parts))

        idx1 = _chunk(b"idx1", b"".join(
            fourcc + struct.pack("<III", 0x10, off, ln)
            for fourcc, off, ln in idx))

        riff = b"AVI " + hdrl + movi + idx1
        with open(self.path, "wb") as f:
            f.write(b"RIFF" + struct.pack("<I", len(riff)) + riff)


class AviReader:
    """Read an uncompressed-DIB AVI back into frames + PCM (the read-back
    half of the reference AVI wrapper: VideoStream.GetFrame decodes DIB
    frame bytes, VideoStream.cs:24-655; AudioStream accumulates PCM).

    Supports the format AviWriter emits: 24-bit bottom-up BGR '00db'/'00dc'
    video chunks and '01wb' PCM16 audio chunks, walked sequentially from
    the 'movi' list (no idx1 dependence).
    """

    def __init__(self, path: str | Path):
        data = Path(path).read_bytes()
        if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
            raise ValueError("not an AVI file")
        self.width = self.height = 0
        self.fps = 0.0
        self.audio_rate = 0
        self.audio_channels = 0
        self._frames: list[bytes] = []
        self._audio: list[bytes] = []
        self._bottom_up = True
        self._walk(data, 12, len(data))
        if not self.width or not self.height:
            raise ValueError("no video stream header found")

    # RIFF chunk walk: LIST chunks recurse, leaves dispatch on fourcc
    def _walk(self, data: bytes, pos: int, end: int) -> None:
        while pos + 8 <= end:
            fourcc = data[pos:pos + 4]
            (size,) = struct.unpack_from("<I", data, pos + 4)
            body = pos + 8
            if fourcc == b"LIST":
                self._walk(data, body + 4, body + size)
            elif fourcc == b"avih":
                usec, = struct.unpack_from("<I", data, body)
                if usec:
                    self.fps = 1_000_000 / usec
                self.width, self.height = struct.unpack_from(
                    "<II", data, body + 32)
            elif fourcc == b"strf":
                self._parse_strf(data, body, size)
            elif fourcc in (b"00db", b"00dc"):
                self._frames.append(data[body:body + size])
            elif fourcc == b"01wb":
                self._audio.append(data[body:body + size])
            pos = body + size + (size & 1)

    def _parse_strf(self, data: bytes, body: int, size: int) -> None:
        # a BITMAPINFOHEADER strf starts with biSize=40 (video); a
        # WAVEFORMATEX strf (format tag 1 = PCM) carries the audio params
        if size < 16:
            return
        (first,) = struct.unpack_from("<I", data, body)
        if first == 40:           # video BITMAPINFOHEADER
            height = struct.unpack_from("<i", data, body + 8)[0]
            self._bottom_up = height >= 0
            return
        tag, ch, rate = struct.unpack_from("<HHI", data, body)
        if tag == 1 and 0 < ch <= 16:
            self.audio_channels = ch
            self.audio_rate = rate

    @property
    def n_frames(self) -> int:
        return len(self._frames)

    def get_frame(self, i: int) -> np.ndarray:
        """Frame i as (H, W, 3) uint8 RGB (VideoStream.GetFrame analog)."""
        raw = self._frames[i]
        row = self.width * 3 + ((-self.width * 3) % 4)
        if len(raw) < row * self.height:
            raise ValueError(f"frame {i} truncated")
        a = np.frombuffer(raw[:row * self.height], np.uint8)
        a = a.reshape(self.height, row)[:, :self.width * 3]
        a = a.reshape(self.height, self.width, 3)
        if self._bottom_up:
            a = a[::-1]
        return a[:, :, ::-1].copy()      # BGR -> RGB

    def audio(self) -> np.ndarray:
        """All PCM16 samples, interleaved, as one int16 array."""
        if not self._audio:
            return np.empty(0, np.int16)
        return np.frombuffer(b"".join(self._audio), "<i2").copy()
