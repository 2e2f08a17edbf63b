"""The benchmark's inputs, made from the run's seed.

Every function here is a module-level task for a process pool: it takes
plain arguments and returns bytes or lists of bytes, and it imports only
the frozen generator (this folder) and the frozen format definitions in
``benchmark/reference``.  The same (seed, config, traffic) always gives the
same bytes.

Streams come from the frozen ``StreamSynthesizer``: each GOP starts with an
I-frame at the configuration's I-frame QP and continues with P-frames.
Audio is IMA ADPCM from the frozen ``encode_ima``, over a waveform drawn
from the seed.
"""
from __future__ import annotations

import numpy as np

from ..reference.oracle_video import MobiclipVersion
from .synth import StreamSynthesizer

#: samples per channel in one MODS audio packet (128 bytes of nibbles)
IMA_PACKET_SAMPLES = 256
#: 128-byte blocks per channel in one Moflex audio chunk
MOFLEX_BLOCKS = 2


def version_of(cfg: dict) -> MobiclipVersion:
    return MobiclipVersion[cfg["version"]]


def _rng(*key: int) -> np.random.Generator:
    return np.random.default_rng([int(k) for k in key])


def corpus_stream(cfg: dict, seed: int, stream: int, gops: int,
                  gop_frames: int, qp: int) -> list[list[bytes]]:
    """One stream of a corpus: ``gops`` GOPs of ``gop_frames`` packets.

    The synthesizer runs on across GOPs, so a later GOP's P-frames may
    reference the previous GOP's last frames: the decoder's reference ring
    has to carry over.  The first GOP references nothing before its
    I-frame, so the GOPs can be decoded again in a cycle."""
    syn = StreamSynthesizer(cfg["width"], cfg["height"], version_of(cfg),
                            seed=[int(seed), 1, int(stream)])
    return [[syn.iframe(qp) if f == 0 else syn.pframe()
             for f in range(gop_frames)] for _ in range(gops)]


def _waveform(rng: np.random.Generator, n: int, t0: int) -> np.ndarray:
    period = rng.uniform(4.0, 40.0)
    amp = rng.uniform(1000.0, 8000.0)
    t = np.arange(n) + t0
    noise = rng.normal(0.0, amp / 16, n)
    return np.clip(amp * np.sin(t / period) + noise, -32768, 32767).astype(
        np.int16)


def file_gop(cfg: dict, seed: int, file: int, gop: int, frames: int,
             qp: int) -> dict:
    """One GOP of one file: video packets (unpadded: the MODS audio starts
    where the video ends) and each frame's audio as the container carries
    it.  Each GOP is seeded on its own and references nothing before its
    I-frame, so a file's GOPs are made in parallel.

    MODS: per frame one packet per channel, 128 bytes of nibbles, the
    first packet of each channel in the GOP led by its 4-byte state (IMA
    restarts at keyframes).  Moflex: per frame one audio chunk holding each
    channel's 4-byte state, then MOFLEX_BLOCKS blocks of 128 bytes per
    channel, channels interleaved block by block."""
    syn = StreamSynthesizer(cfg["width"], cfg["height"], version_of(cfg),
                            seed=[int(seed), 2, int(file), int(gop)])
    video = [syn.iframe(qp, pad=False) if f == 0 else syn.pframe(pad=False)
             for f in range(frames)]
    nch = cfg["audio"]["channels"]
    rng = _rng(seed, 3, file, gop)
    audio: list[list[bytes]] = [[] for _ in range(frames)]
    from ..reference.audio_ima import encode_ima
    if cfg["container"] == "mods":
        n = frames * IMA_PACKET_SAMPLES
        for c in range(nch):
            blob = encode_ima(_waveform(rng, n, gop * n), index0=8)
            hdr, body = blob[:4], blob[4:]
            for f in range(frames):
                chunk = body[f * 128:(f + 1) * 128]
                audio[f].append((hdr if f == 0 else b"") + chunk)
    else:
        n = MOFLEX_BLOCKS * IMA_PACKET_SAMPLES
        for f in range(frames):
            heads, bodies = bytearray(), []
            for _c in range(nch):
                blob = encode_ima(_waveform(rng, n, f * n), index0=4)
                heads += blob[:4]
                bodies.append(blob[4:])
            for k in range(MOFLEX_BLOCKS):
                for c in range(nch):
                    heads += bodies[c][k * 128:(k + 1) * 128]
            audio[f].append(bytes(heads))
    return {"video": video, "audio": audio}


def mux_file(cfg: dict, gops: list[dict]) -> bytes:
    """The container's bytes for a file made of ``gops`` (``file_gop``)."""
    if cfg["container"] == "mods":
        from .mods import ModsMuxer
        a = cfg["audio"]
        mux = ModsMuxer(cfg["width"], cfg["height"], fps=float(cfg["fps"]),
                        audio_codec=3, nb_channel=a["channels"],
                        frequency=a["frequency"])
        for g in gops:
            for f, video in enumerate(g["video"]):
                mux.add_frame(video, g["audio"][f], keyframe=f == 0)
        return mux.to_bytes()
    from .moflex import AudioStream, MoflexMuxer, VideoStream
    a = cfg["audio"]
    mux = MoflexMuxer([
        VideoStream(stream_index=0, codec_id=0, fps_rate=int(cfg["fps"]),
                    fps_scale=1, width=cfg["width"], height=cfg["height"]),
        AudioStream(stream_index=1, codec_id=1, frequency=a["frequency"],
                    channels=a["channels"])])
    for g in gops:
        for f, video in enumerate(g["video"]):
            mux.add_frame(0, video)
            mux.add_frame(1, g["audio"][f][0])
    return mux.to_bytes()
