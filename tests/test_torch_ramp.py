"""The transcoder's launch ramp (runtime/transcode.py ``launch_frames``):
a stream's ``decode_stream_chunk`` calls on the chunk path take 1, 3, 12,
then CHUNK_FRAMES frames, so that a file's first frame waits for one
frame's decode.  On engine="cpu" for MODS, Moflex and MOC5 at 64x48 and
VX2 at its fixed 256x192: the calls' lengths, the first frame after one
call of one packet, frames, keyframe flags and PCM equal to the JAX
package's transcoder (engine "oracle") and to the port's own oracle engine,
a frame that fails inside the ramp, and the ``ramp_launches`` counter."""
import sys
from pathlib import Path

import numpy as np
import pytest

from mobiclipdecoder_tpu.runtime import transcode as jt
from mobiclipdecoder_tpu_torch.containers.moc5 import Moc5Muxer
from mobiclipdecoder_tpu_torch.containers.vx import (VX2_AUDIO_SAMPLES,
                                                     Vx2Muxer)
from mobiclipdecoder_tpu_torch.models.oracle_video import MobiclipVersion
from mobiclipdecoder_tpu_torch.ops.vmem_engine import VmemVideoDecoder
from mobiclipdecoder_tpu_torch.runtime import metrics
from mobiclipdecoder_tpu_torch.runtime import transcode as pt
from mobiclipdecoder_tpu_torch.testing.synth import StreamSynthesizer

sys.path.insert(0, str(Path(__file__).parent))
from torch_av import W, H, moflex_ima, mods_ima, spoil  # noqa: E402

launch_lengths = pt.launch_lengths


def _packets(version, w, h, nframes, seed, bad_at):
    synth = StreamSynthesizer(w, h, version, seed=seed)
    out = [synth.iframe(0x14) if f == 0 else synth.pframe()
           for f in range(nframes)]
    if bad_at is not None:
        out[bad_at] = spoil(out[bad_at])
    return out


def _moc5(nframes, seed, bad_at=None):
    mux = Moc5Muxer(W, H, fps=30.0)
    for pkt in _packets(MobiclipVersion.MOFLEX_3DS, W, H, nframes, seed,
                        bad_at):
        mux.add_frame(pkt)
    return mux.to_bytes()


def _vx2(nframes, seed, bad_at=None):
    """256x192, a PCM chunk every ``VX2_AUDIO_RATE`` frames."""
    rng = np.random.default_rng(seed)
    mux = Vx2Muxer()
    for pkt in _packets(MobiclipVersion.MOFLEX_3DS, 256, 192, nframes, seed,
                        bad_at):
        mux.add_frame(pkt, rng.integers(-2000, 2000, VX2_AUDIO_SAMPLES,
                                        np.int16).astype("<i2").tobytes())
    return mux.to_bytes()


#: each container: (the port's entry point, file of n frames from a seed
#: whose frame ``bad_at`` fails to decode)
FILES = {
    "mods": (pt.decode_mods, lambda n, seed, bad_at=None: mods_ima(
        n, key_at=(0, 6, 24), seed=seed, truncate_video_at=bad_at)),
    "moflex": (pt.decode_moflex, lambda n, seed, bad_at=None: moflex_ima(
        n, seed=seed, truncate_video_at=bad_at)),
    "moc5": (pt.decode_moc5, _moc5),
    "vx2": (pt.decode_vx2, _vx2),
}


@pytest.fixture
def lengths(monkeypatch):
    """The length of each decode_stream_chunk call, in order."""
    got = []
    chunk = VmemVideoDecoder.decode_stream_chunk

    def recording(self, packets):
        got.append(len(packets))
        return chunk(self, packets)
    monkeypatch.setattr(VmemVideoDecoder, "decode_stream_chunk", recording)
    return got


def _same(got, want):
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        for p in ("y", "u", "v"):
            np.testing.assert_array_equal(getattr(a, p), getattr(b, p),
                                          err_msg=f"frame {k} {p}")
        assert (a.index, a.keyframe, a.corrupt) == (b.index, b.keyframe,
                                                    b.corrupt), k
        assert (a.pcm is None) == (b.pcm is None), k
        if a.pcm is not None:
            np.testing.assert_array_equal(a.pcm, b.pcm, err_msg=f"frame {k}")


def _oracles(kind, blob):
    """The JAX package's transcoder and the port's, both on engine
    "oracle"."""
    return (list(getattr(jt, f"decode_{kind}")(blob, engine="oracle")),
            list(FILES[kind][0](blob, engine="oracle")))


def test_launch_frames_ramps_to_the_chunk_grid(monkeypatch):
    assert [pt.launch_frames(p) for p in (0, 1, 4, 16, 32, 2, 5)] == [
        1, 3, 12, 16, 16, 6, 15]
    assert launch_lengths(48) == [1, 3, 12, 16, 16]
    assert launch_lengths(20) == [1, 3, 12, 4]
    assert launch_lengths(20, failed=(2,)) == [1, 3, 9, 8]
    monkeypatch.setattr(pt, "CHUNK_FRAMES", 3)
    assert launch_lengths(13) == [1, 3, 3, 3, 3]


# VX2 (256x192) in the short case only: 48 of its frames take 17 s on a CPU
CASES = [(kind, 48, 16) for kind in ("mods", "moflex", "moc5")] + [
    (kind, 13, 3) for kind in sorted(FILES)]


@pytest.mark.parametrize("kind,nframes,chunk", CASES)
def test_launch_lengths_and_frames_equal_the_oracles(monkeypatch, lengths,
                                                     kind, nframes, chunk):
    """The calls' lengths follow the schedule: [1, 3, 12, 16, 16] for 48
    frames, [1, 3, 3, 3, 3] for 13 under CHUNK_FRAMES = 3, and
    ``ramp_launches`` counts the calls shorter than CHUNK_FRAMES (3, 1);
    frames, keyframe flags and PCM equal the JAX package's transcoder's
    and the port's oracle engine's."""
    monkeypatch.setattr(pt, "CHUNK_FRAMES", chunk)
    decode, build = FILES[kind]
    blob = build(nframes, seed=nframes + chunk)
    before = metrics.TOTALS.ramp_launches
    got = list(decode(blob, engine="cpu"))
    assert lengths == launch_lengths(nframes) == (
        [1, 3, 12, 16, 16] if nframes == 48 else [1, 3, 3, 3, 3])
    assert metrics.TOTALS.ramp_launches - before == (3 if nframes == 48
                                                     else 1)
    jax, want = _oracles(kind, blob)
    assert len(got) == nframes and not any(f.corrupt for f in got)
    if kind in ("mods", "moflex"):
        assert sum(f.pcm is not None for f in got) >= nframes // 2
    # a Moflex frame's audio chunk follows it; MOC5 carries none
    assert (got[0].pcm is None) == (kind in ("moflex", "moc5"))
    _same(got, jax)
    _same(got, want)


@pytest.mark.parametrize("kind", sorted(FILES))
def test_first_frame_follows_one_launch_of_one_packet(lengths, kind):
    """After the first ``next()`` on each entry point exactly one call of
    one packet has run."""
    decode, build = FILES[kind]
    frames = decode(build(20, seed=5), engine="cpu")
    first = next(frames)
    assert lengths == [1]
    assert first.index == 0 and not first.corrupt
    frames.close()


@pytest.mark.parametrize("kind", sorted(FILES))
def test_a_frame_that_fails_inside_the_ramp_is_contained(lengths, kind):
    """Frame 2, in the second call, fails to scan: it comes back corrupt
    showing the last committed frame (frame 1), every frame is yielded,
    the frames before it equal the JAX package's transcoder's and the
    port's oracle engine's, and the schedule goes on from frame 3."""
    decode, build = FILES[kind]
    n = 20 if kind != "vx2" else 8
    blob = build(n, seed=7, bad_at=2)
    got = list(decode(blob, engine="cpu"))
    assert len(got) == n and [f.index for f in got] == list(range(n))
    assert [f.index for f in got if f.corrupt] == [2]
    for p in ("y", "u", "v"):
        np.testing.assert_array_equal(getattr(got[2], p), getattr(got[1], p))
    assert lengths == launch_lengths(n, failed=(2,))
    jax, want = _oracles(kind, blob)
    _same(got[:2], jax[:2])
    _same(got[:2], want[:2])


@pytest.mark.parametrize("nframes,ramped", [(1, 0), (2, 1), (20, 3)])
@pytest.mark.parametrize("kind", ["mods", "moflex", "moc5"])
def test_ramp_launches_counts_the_short_calls_with_frames_after_them(
        kind, nframes, ramped):
    """``ramp_launches`` reads 3 for a file of more than 16 frames (the
    calls of 1, 3 and 12), 0 for a one-frame file; a call cut short by the
    end of the file (the second of 2 frames, the last 4 of 20) is not
    counted."""
    decode, build = FILES[kind]
    blob = build(nframes, seed=11)
    before = metrics.TOTALS.ramp_launches
    assert len(list(decode(blob, engine="cpu"))) == nframes
    assert metrics.TOTALS.ramp_launches - before == ramped
