"""MODS and Moflex files with IMA ADPCM audio for the transcoder's tests,
made with the port's own muxers and synthesizer (no JAX, so that the
tests on the card can use them too).

The audio is random bytes in the layout the transcoder reads: in MODS a
packet of 128 bytes per channel in turn, led by a 4-byte state where the
channel starts or restarts at a keyframe; in Moflex a chunk a frame with
each channel's state, then 128-byte blocks of the channels in turn.  Random
nibbles drive the decoder's clamps; any bytes decode the same on every
path, as long as no packet runs past its payload."""
import numpy as np

from mobiclipdecoder_tpu_torch.containers.mods import ModsMuxer
from mobiclipdecoder_tpu_torch.containers.moflex import (AudioStream,
                                                         MoflexMuxer,
                                                         VideoStream)
from mobiclipdecoder_tpu_torch.models.oracle_video import MobiclipVersion
from mobiclipdecoder_tpu_torch.testing.synth import StreamSynthesizer

W, H = 64, 48


def spoil(video: bytes) -> bytes:
    """A frame's video past its first 8 bytes set to 0xFF, so that it fails
    to decode (on most seeds: a test asserts it)."""
    return video[:8] + b"\xff" * (len(video) - 8)


def _state(rng, index: int | None = None) -> bytes:
    """An IMA state header: step index (drawn in [0, 88] unless given),
    then the starting sample."""
    idx = int(rng.integers(0, 89)) if index is None else index
    last = int(rng.integers(-32768, 32768))
    return idx.to_bytes(2, "little") + last.to_bytes(2, "little",
                                                     signed=True)


def mods_ima(nframes: int, key_at=(0,), seed: int = 11, channels: int = 2,
             audio=None, n3: bool = False, bad_index_at=None,
             truncate_video_at=None) -> bytes:
    """A MODS file with IMA audio (codec 3).  ``audio[f]`` is frame f's
    number of packets (default: one per channel).  ``n3``: tag 'N3', with
    the 4 bytes its quirk skips after the video of every frame whose first
    word has bit 15 set.  ``bad_index_at``: that frame's first header reads
    step index 100.  ``truncate_video_at``: that frame's video ``spoil``ed."""
    rng = np.random.default_rng(seed)
    synth = StreamSynthesizer(W, H, MobiclipVersion.MODS_DS, seed=seed)
    mux = ModsMuxer(W, H, fps=24.0, audio_codec=3, nb_channel=channels,
                    frequency=16384, tag_id=0x334E if n3 else 0x324E)
    audio = [channels] * nframes if audio is None else audio
    header = [True] * channels
    cur = 0
    for f in range(nframes):
        key = f in key_at
        video = synth.iframe(0x18, pad=False) if key \
            else synth.pframe(pad=False)
        if key:
            synth.frame_idx = 1     # P-frames after it reference it alone
        if key and audio[f]:        # IMA restarts where audio is decoded
            header = [True] * channels
        pkts = []
        for k in range(audio[f]):
            head = b""
            if header[cur]:
                head = _state(rng, 100 if f == bad_index_at and k == 0
                              else None)
                header[cur] = False
            pkts.append(head + rng.integers(0, 256, 128, np.uint8).tobytes())
            cur = (cur + 1) % channels
        if n3 and (video[0] | (video[1] << 8)) & 0x8000:
            video += b"\xa5" * 4
        if f == truncate_video_at:
            video = spoil(video)
        mux.add_frame(video, pkts, keyframe=key)
    return mux.to_bytes()


def moflex_ima(nframes: int, seed: int = 21, channels: int = 2,
               payloads=None, pcm16: bool = False,
               truncate_video_at=None) -> bytes:
    """A Moflex file: video stream 0 and an IMA stream 1 (codec 1), each
    frame's video followed by its audio chunk.  ``payloads[f]`` is frame
    f's chunk as (blocks per channel, extra bytes, step index or None),
    or an int: a chunk of that many random bytes (shorter than the headers:
    dropped).  ``pcm16``: a PCM16 stream 2 beside it, an odd number of
    bytes a frame.  ``truncate_video_at``: as in ``mods_ima``."""
    rng = np.random.default_rng(seed)
    synth = StreamSynthesizer(W, H, MobiclipVersion.MOFLEX_3DS, seed=seed)
    streams = [VideoStream(stream_index=0, codec_id=0, fps_rate=24,
                           fps_scale=1, width=W, height=H),
               AudioStream(stream_index=1, codec_id=1, frequency=16384,
                           channels=channels)]
    if pcm16:
        streams.append(AudioStream(stream_index=2, codec_id=2,
                                   frequency=16384, channels=channels))
    mux = MoflexMuxer(streams)
    payloads = [(2, 0, None)] * nframes if payloads is None else payloads
    for f in range(nframes):
        video = synth.iframe(0x12, pad=False) if f == 0 \
            else synth.pframe(pad=False)
        mux.add_frame(0, spoil(video) if f == truncate_video_at else video)
        spec = payloads[f]
        if isinstance(spec, int):
            chunk = rng.integers(0, 256, spec, np.uint8).tobytes()
        else:
            blocks, extra, index = spec
            chunk = b"".join(_state(rng, index) for _ in range(channels))
            chunk += rng.integers(0, 256, blocks * 128 * channels + extra,
                                  np.uint8).tobytes()
        mux.add_frame(1, chunk)
        if pcm16:
            n = 2 * channels * int(rng.integers(1, 60)) + 1
            mux.add_frame(2, rng.integers(0, 256, n, np.uint8).tobytes())
    return mux.to_bytes()


def moflex_fastaudio(nframes: int, seed: int = 31, streams=((1, 2),),
                     sizes=None, before: bool = True,
                     truncate_video_at=None) -> bytes:
    """A Moflex file: video stream 0 and FastAudio streams (codec 0),
    ``streams`` giving each one's (stream index, channels), each frame's
    chunks muxed before its video (``before``) or after it.  ``sizes[f]``
    gives frame f's chunk sizes in bytes, one per stream (default: two
    rounds of 40-byte packets); the bytes are random, which any packet
    decodes (the decoder's work does not depend on its bits).
    ``truncate_video_at``: as in ``mods_ima``."""
    rng = np.random.default_rng(seed)
    synth = StreamSynthesizer(W, H, MobiclipVersion.MOFLEX_3DS, seed=seed)
    mux = MoflexMuxer(
        [VideoStream(stream_index=0, codec_id=0, fps_rate=24, fps_scale=1,
                     width=W, height=H)]
        + [AudioStream(stream_index=s, codec_id=0, frequency=32728,
                       channels=ch) for s, ch in streams])
    for f in range(nframes):
        video = synth.iframe(0x12, pad=False) if f == 0 \
            else synth.pframe(pad=False)
        if f == truncate_video_at:
            video = spoil(video)
        chunks = [rng.integers(0, 256, 80 * ch if sizes is None
                               else sizes[f][k], np.uint8).tobytes()
                  for k, (_s, ch) in enumerate(streams)]
        if not before:
            mux.add_frame(0, video)
        for (s, _ch), chunk in zip(streams, chunks):
            mux.add_frame(s, chunk)
        if before:
            mux.add_frame(0, video)
    return mux.to_bytes()
