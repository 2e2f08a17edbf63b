"""Moflex files with FastAudio sound (Moflex audio codec 0) for the
benchmark: the GOPs and the writer.

The video is ``traffic.file_gop``'s, seeded the same way, so a file's
GOPs are made in parallel from the seed.  The sound is the configuration's
channels of FastAudio: frame f carries one chunk of ``rounds(f)`` rounds,
each round one 40-byte packet (256 samples) a channel, the channels in
turn (Form1.cs:561-599).  The packets' bytes are drawn from the seed: no
FastAudio encoder exists upstream or here, and the decoder's work per
packet does not depend on its bits.  Each frame's chunk is muxed before
its video, as a streaming muxer primes the player's audio buffer, so a
file's first frame carries its sound.
"""
from __future__ import annotations

from .traffic import _rng, version_of
from .synth import StreamSynthesizer

#: bytes and samples of one FastAudio packet (FastAudioDecoder.cs:41-72)
PACKET_BYTES, PACKET_SAMPLES = 40, 256


def rounds(frame: int, frequency: int, fps: int) -> int:
    """Packets a channel in frame ``frame``'s chunk: those due by the
    frame's end less those due by its start."""
    per = PACKET_SAMPLES * fps
    return (frame + 1) * frequency // per - frame * frequency // per


def file_gop(cfg: dict, seed: int, file: int, gop: int, frames: int,
             qp: int) -> dict:
    """One GOP of one file: its video packets (unpadded) and, beside each
    frame, its one FastAudio chunk."""
    syn = StreamSynthesizer(cfg["width"], cfg["height"], version_of(cfg),
                            seed=[int(seed), 2, int(file), int(gop)])
    video = [syn.iframe(qp, pad=False) if f == 0 else syn.pframe(pad=False)
             for f in range(frames)]
    a = cfg["audio"]
    rng = _rng(seed, 4, file, gop)
    audio = [[rng.integers(0, 256, rounds(gop * frames + f, a["frequency"],
                                          cfg["fps"])
                           * a["channels"] * PACKET_BYTES,
                           dtype="uint8").tobytes()]
             for f in range(frames)]
    return {"video": video, "audio": audio}


def mux_file(cfg: dict, gops: list[dict]) -> bytes:
    """The Moflex bytes of a file made of ``gops`` (``file_gop``): video
    stream 0, FastAudio stream 1, each frame's chunk before its video."""
    from .moflex import AudioStream, MoflexMuxer, VideoStream
    a = cfg["audio"]
    mux = MoflexMuxer([
        VideoStream(stream_index=0, codec_id=0, fps_rate=int(cfg["fps"]),
                    fps_scale=1, width=cfg["width"], height=cfg["height"]),
        AudioStream(stream_index=1, codec_id=0, frequency=a["frequency"],
                    channels=a["channels"])])
    for g in gops:
        for f, video in enumerate(g["video"]):
            mux.add_frame(1, g["audio"][f][0])
            mux.add_frame(0, video)
    return mux.to_bytes()
