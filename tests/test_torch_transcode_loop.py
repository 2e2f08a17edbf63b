"""The transcoder's one frame loop (runtime/transcode.py
``_chunked_video_frames``, its decoders behind ``_Launches``) on the engines
that decode a frame a call: a 6-frame file whose frame 2 fails, in every
container.  The oracle engine's frames, ``corrupt`` and keyframe flags and
PCM equal the JAX package's transcoder with its oracle engine; the
wavefront engine raises at the failed frame with the JAX package's
``tpu-xla`` engine's error, after the oracle's frames.  And every ``decode_*``, on
every engine the CPU has, reaches the loop once per file.

MODS, Moflex and MOC5 at 64x48; VX2 at its fixed 256x192, on the oracle
alone (the frame decoders' failures at 256x192 add nothing the 64x48
cases do not show)."""
import sys
from pathlib import Path

import numpy as np
import pytest

from mobiclipdecoder_tpu.runtime import transcode as jt
from mobiclipdecoder_tpu_torch.runtime import transcode as pt

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_ramp import FILES  # noqa: E402

BAD = 2
CASES = [(kind, engine) for kind in ("mods", "moflex", "moc5")
         for engine in ("oracle", "wavefront-cpu")] + [("vx2", "oracle")]


def _until_error(frames):
    """The frames yielded before the iterator raised, and its error."""
    got = []
    try:
        for fr in frames:
            got.append(fr)
    except Exception as err:    # noqa: BLE001 - compared below
        return got, err
    return got, None


def _same(got, want):
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        assert (a.index, a.keyframe, a.corrupt) \
            == (b.index, b.keyframe, b.corrupt), k
        for p in ("y", "u", "v"):
            np.testing.assert_array_equal(getattr(a, p), getattr(b, p),
                                          err_msg=f"frame {k} {p}")
        assert (a.pcm is None) == (b.pcm is None), k
        if a.pcm is not None:
            np.testing.assert_array_equal(a.pcm, b.pcm, err_msg=f"frame {k}")


@pytest.mark.parametrize("kind,engine", CASES)
def test_a_failed_frame_on_a_frame_decoder(kind, engine):
    decode, build = FILES[kind]
    blob = build(6, 7, bad_at=BAD)
    jdecode = getattr(jt, decode.__name__)
    if engine == "oracle":
        got = list(decode(blob, engine="oracle"))
        _same(got, list(jdecode(blob, engine="oracle")))
        assert len(got) == 6 and got[BAD].corrupt
        assert not any(f.corrupt for f in got[:BAD])
        return
    got, err = _until_error(decode(blob, engine=engine))
    want, jerr = _until_error(jdecode(blob, engine="tpu-xla"))
    assert isinstance(err, AttributeError) and "ring_frame_np" in str(err)
    assert type(err) is type(jerr)
    assert isinstance(err.__context__, type(jerr.__context__))
    assert isinstance(err.__context__, ValueError)
    # the frames before the failure, as the oracle decodes them; the JAX
    # package's Moflex loop yields a packet's frames only after its parse,
    # so it yields none of those that share the failed frame's packet
    _same(got, list(jdecode(blob, engine="oracle"))[:BAD])
    _same(want, got[:len(want)])


@pytest.mark.parametrize("engine", ["oracle", "cpu", "wavefront-cpu"])
def test_every_container_reaches_the_one_loop(monkeypatch, engine):
    """A counting wrapper around ``_chunked_video_frames``: one call per
    file, which yields every frame."""
    calls = []
    loop = pt._chunked_video_frames

    def counting(*args, **kwargs):
        calls.append(args[0])
        return loop(*args, **kwargs)

    monkeypatch.setattr(pt, "_chunked_video_frames", counting)
    for kind in ("mods", "moflex", "moc5", "vx2"):
        decode, build = FILES[kind]
        calls.clear()
        frames = list(decode(build(2, 7), engine=engine))
        assert len(frames) == 2 and not any(f.corrupt for f in frames), kind
        assert len(calls) == 1, kind
