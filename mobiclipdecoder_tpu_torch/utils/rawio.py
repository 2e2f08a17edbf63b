"""Raw A/V output writers (the reference's avifil32-based AVI writer is
Windows-only third-party code; raw Y4M/WAV/PPM cover the same role for a
batch transcoder: file in -> decoded frames + PCM out)."""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


class Y4MWriter:
    """YUV4MPEG2 4:2:0 writer. Note: Mobiclip chroma is codec-native (MODS
    pseudo-YUV / Moflex YCbCr), written as-is; use rgb/PPM output for
    colorimetrically converted frames."""

    def __init__(self, path: str | Path, width: int, height: int,
                 fps: float = 25.0):
        self.f = open(path, "wb")
        num = int(round(fps * 1000))
        self.f.write(f"YUV4MPEG2 W{width} H{height} F{num}:1000 Ip A1:1 "
                     f"C420jpeg\n".encode())

    def add_frame(self, y: np.ndarray, u: np.ndarray, v: np.ndarray) -> None:
        self.f.write(b"FRAME\n")
        self.f.write(np.ascontiguousarray(y, dtype=np.uint8).tobytes())
        self.f.write(np.ascontiguousarray(u, dtype=np.uint8).tobytes())
        self.f.write(np.ascontiguousarray(v, dtype=np.uint8).tobytes())

    def close(self) -> None:
        self.f.close()


class LiveY4MPipe:
    """Streaming YUV4MPEG2 C444 sink for live playback: pipe into any
    y4m-capable player (``play clip.mods --pipe-y4m - | mpv -``).  Frames
    arrive as display RGB (the reference player's presentation surface,
    Form1.cs:510-543) and are converted to full-range BT.601 YCbCr 4:4:4 —
    a display epilogue, deliberately outside the bit-exact YUV contract."""

    def __init__(self, dest, width: int, height: int, fps: float):
        import sys
        self._own = dest != "-"
        self.f = open(dest, "wb") if self._own else sys.stdout.buffer
        num = int(round(max(fps, 1e-3) * 1000))
        self.f.write(f"YUV4MPEG2 W{width} H{height} F{num}:1000 Ip A1:1 "
                     f"C444\n".encode())

    def add_rgb(self, rgb: np.ndarray) -> None:
        r = rgb[:, :, 0].astype(np.float32)
        g = rgb[:, :, 1].astype(np.float32)
        b = rgb[:, :, 2].astype(np.float32)
        y = 0.299 * r + 0.587 * g + 0.114 * b
        cb = 128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b
        cr = 128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b
        self.f.write(b"FRAME\n")
        for plane in (y, cb, cr):
            self.f.write(np.clip(plane + 0.5, 0, 255
                                 ).astype(np.uint8).tobytes())
        self.f.flush()

    def close(self) -> None:
        if self._own:
            self.f.close()
        else:
            self.f.flush()


class LiveWavPipe:
    """Streaming PCM16 WAV sink for live playback audio (the reference
    player feeds decoded PCM to NAudio as it arrives, Form1.cs:549-558).
    Writes a streaming-style header up front (0xFFFFFFFF sizes, which
    players accept for pipes); on close, patches the real sizes when the
    destination is seekable (a regular file)."""

    def __init__(self, dest, rate: int, channels: int):
        import sys
        self._own = dest != "-"
        self.f = open(dest, "wb") if self._own else sys.stdout.buffer
        self._n = 0
        ch = max(channels, 1)
        block = 2 * ch
        self.f.write(
            b"RIFF" + b"\xff\xff\xff\xff" + b"WAVEfmt "
            + struct.pack("<IHHIIHH", 16, 1, ch, rate, rate * block,
                          block, 16)
            + b"data" + b"\xff\xff\xff\xff")

    def add(self, pcm: np.ndarray) -> None:
        b = np.asarray(pcm, dtype="<i2").tobytes()
        self._n += len(b)
        self.f.write(b)
        self.f.flush()

    def close(self) -> None:
        try:
            self.f.seek(4)
            self.f.write(struct.pack("<I", 36 + self._n))
            self.f.seek(40)
            self.f.write(struct.pack("<I", self._n))
        except (OSError, ValueError):
            pass  # pipe destinations keep the streaming header
        if self._own:
            self.f.close()
        else:
            self.f.flush()


def write_wav(path: str | Path, samples: np.ndarray, rate: int,
              channels: int) -> None:
    """PCM16 WAV writer; ``samples`` is interleaved int16 (frames*channels,)."""
    samples = np.asarray(samples, dtype="<i2")
    data = samples.tobytes()
    with open(path, "wb") as f:
        byte_rate = rate * channels * 2
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, rate,
                                      byte_rate, channels * 2, 16))
        f.write(b"data" + struct.pack("<I", len(data)))
        f.write(data)


def write_ppm(path: str | Path, rgb: np.ndarray) -> None:
    h, w, _ = rgb.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(rgb, dtype=np.uint8).tobytes())


def yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray,
               moflex: bool) -> np.ndarray:
    """Cropped-plane YUV->RGB epilogue, identical math to the decoder's
    conversion (MobiclipDecoder.cs:260-323 / OracleDecoder.to_rgb):
    chroma upsample by pixel parity (edge rows/cols use the co-sited sample —
    the reference's `interior` condition), then Moflex YCbCr (float, with
    (c-16)*255/239 range expansion) or MODS pseudo-YUV (integer)."""
    H, W = y.shape
    yf = y.astype(np.float32)
    uf = u.astype(np.float32) - np.float32(128.0)
    vf = v.astype(np.float32) - np.float32(128.0)
    yy, xx = np.mgrid[0:H, 0:W]
    cy, cx = yy // 2, xx // 2
    u0, v0 = uf[cy, cx], vf[cy, cx]
    interior = (xx != W - 1) & (yy != H - 1)
    case = np.where(interior, (xx & 1) | ((yy & 1) << 1), 0)
    cx1 = np.minimum(cx + 1, W // 2 - 1)
    cy1 = np.minimum(cy + 1, H // 2 - 1)
    U, V = u0.copy(), v0.copy()
    m = case == 1
    U[m] = (u0[m] + uf[cy, cx1][m]) / np.float32(2)
    V[m] = (v0[m] + vf[cy, cx1][m]) / np.float32(2)
    m = case == 2
    U[m] = (u0[m] + uf[cy1, cx][m]) / np.float32(2)
    V[m] = (v0[m] + vf[cy1, cx][m]) / np.float32(2)
    m = case == 3
    U[m] = (((u0[m] + uf[cy, cx1][m]) + uf[cy1, cx][m])
            + uf[cy1, cx1][m]) / np.float32(4)
    V[m] = (((v0[m] + vf[cy, cx1][m]) + vf[cy1, cx][m])
            + vf[cy1, cx1][m]) / np.float32(4)
    if moflex:
        R = yf + np.float32(1.420) * V
        G = yf - np.float32(0.344) * U - np.float32(0.714) * V
        B = yf + np.float32(1.772) * U
        R = (R - 16) * np.float32(255) / np.float32(255 - 16)
        G = (G - 16) * np.float32(255) / np.float32(255 - 16)
        B = (B - 16) * np.float32(255) / np.float32(255 - 16)
    else:
        yi = yf.astype(np.int32)
        ui = U.astype(np.int32)
        vi = V.astype(np.int32)
        R = (yi + ui - vi).astype(np.float32)
        G = (yi + vi).astype(np.float32)
        B = (yi - ui - vi).astype(np.float32)
    return np.clip(np.stack([R, G, B], axis=-1), 0, 255).astype(np.uint8)


def interleave_channels(channels: list[np.ndarray]) -> np.ndarray:
    """Per-sample channel interleave (Form1.cs:637-650)."""
    n = min(len(c) for c in channels)
    out = np.empty(n * len(channels), dtype=np.int16)
    for i, c in enumerate(channels):
        out[i::len(channels)] = c[:n]
    return out


def anaglyph(left_rgb: np.ndarray, right_rgb: np.ndarray) -> np.ndarray:
    """Red/cyan anaglyph compositor for 3D stereo pairs: R from the left
    eye, G and B from the right (the reference ships the same compositor,
    present but unused in its display flow — Form1.cs:652-675)."""
    out = right_rgb.copy()
    out[..., 0] = left_rgb[..., 0]
    return out
