"""The port's transcoder and CLI (mobiclipdecoder_tpu_torch/runtime/
transcode.py, __main__.py) against the JAX package's, at 64x48 on the CPU.

The port's engines are "oracle", "cuda", "cpu", "wavefront" and
"wavefront-cpu" (tests/test_torch_wavefront.py); here "cpu" runs the
port's decoder with the plain PyTorch executor.  Frames and PCM must equal
those of the JAX package's "oracle" engine and, where named, its "tpu"
engine (the Pallas executor in interpret mode).
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from test_mods_e2e import _build_fixture  # noqa: E402
from test_moflex import _build_moflex  # noqa: E402

from mobiclipdecoder_tpu.containers.moc5 import Moc5Muxer  # noqa: E402
from mobiclipdecoder_tpu.containers.vx import Vx2Muxer  # noqa: E402
from mobiclipdecoder_tpu.models.oracle_video import (  # noqa: E402
    MobiclipVersion, OracleDecoder)
from mobiclipdecoder_tpu.runtime import transcode as jt  # noqa: E402
from mobiclipdecoder_tpu.testing.synth import StreamSynthesizer  # noqa: E402

from mobiclipdecoder_tpu_torch.__main__ import main  # noqa: E402
from mobiclipdecoder_tpu_torch.ops.vmem_engine import (  # noqa: E402
    VmemVideoDecoder)
from mobiclipdecoder_tpu_torch.runtime import transcode as pt  # noqa: E402


def _same(a, b, pcm=True):
    """Two DecodedFrame lists are equal: planes, flags and PCM."""
    assert len(a) == len(b)
    for k, (fa, fb) in enumerate(zip(a, b)):
        for p in ("y", "u", "v"):
            np.testing.assert_array_equal(getattr(fa, p), getattr(fb, p),
                                          err_msg=f"frame {k} {p}")
        assert (fa.index, fa.keyframe, fa.corrupt) == (
            fb.index, fb.keyframe, fb.corrupt), k
        if pcm:
            assert (fa.pcm is None) == (fb.pcm is None), k
            if fa.pcm is not None:
                np.testing.assert_array_equal(fa.pcm, fb.pcm,
                                              err_msg=f"frame {k} pcm")


def test_decode_mods_matches_jax_tpu_and_oracle():
    blob = _build_fixture()
    got = list(pt.decode_mods(blob, engine="cpu"))
    assert len(got) == 6 and any(f.pcm is not None for f in got)
    _same(got, list(jt.decode_mods(blob, engine="oracle")))
    _same(got, list(jt.decode_mods(blob, engine="tpu")))


def test_chunk_boundary_exactness(monkeypatch):
    """More frames than CHUNK_FRAMES (patched on the port's transcoder,
    whose decode functions read it at each call): chunk seams are exact."""
    monkeypatch.setattr(pt, "CHUNK_FRAMES", 3)
    blob = _build_fixture(nframes=8, seed=13, key_at=(0, 4))
    got = list(pt.decode_mods(blob, engine="cpu"))
    assert len(got) == 8
    _same(got, list(jt.decode_mods(blob, engine="oracle")))


def test_chunked_containment_matches_policy():
    """A corrupted mid-stream frame comes back corrupt=True showing the
    last committed frame; the stream yields every frame, and frames before
    the first corruption equal the oracle's."""
    blob = bytearray(_build_fixture(nframes=6, seed=31, key_at=(0,)))
    for i in range(len(blob) * 3 // 4, len(blob) * 3 // 4 + 16):
        blob[i] ^= 0xFF
    got = list(pt.decode_mods(bytes(blob), engine="cpu"))
    oracle = list(jt.decode_mods(bytes(blob), engine="oracle"))
    assert len(got) == len(oracle) == 6
    assert any(f.corrupt for f in got)
    for fa, fb in zip(oracle, got):
        if fa.corrupt or fb.corrupt:
            break
        np.testing.assert_array_equal(fa.y, fb.y)


def test_stream_chunk_bitflip_sweep():
    """20 random bit flips through decode_stream_chunk: a consistent
    (yuv, offsets, err) triple, frames before the flipped packet equal the
    oracle, and the next keyframe recovers exactly."""
    W, H = 64, 48
    ds = MobiclipVersion.MODS_DS
    rng = np.random.default_rng(11)
    n_err = 0
    for trial in range(20):
        synth = StreamSynthesizer(W, H, ds, seed=100 + trial)
        pkts = [synth.iframe(0x18) if i == 0 else synth.pframe()
                for i in range(4)]
        bad = int(rng.integers(1, 4))
        flipped = bytearray(pkts[bad])
        bit = int(rng.integers(16, len(flipped) * 8))
        flipped[bit // 8] ^= 1 << (bit % 8)
        pkts[bad] = bytes(flipped)
        dec = VmemVideoDecoder(W, H, ds, device="cpu")
        yuv, offs, err = dec.decode_stream_chunk(pkts)
        assert yuv.shape[0] == len(offs) <= 4
        if err is not None:
            n_err += 1
            assert err == yuv.shape[0]
        oracle = OracleDecoder(W, H, ds)
        S = oracle.stride
        for k in range(min(yuv.shape[0], bad)):
            oracle.data = pkts[k]
            oracle.offset = 0
            oracle.decode_frame()
            np.testing.assert_array_equal(
                yuv[k][:H], oracle.y_planes[0].reshape(-1, S)[:H],
                err_msg=f"trial {trial} frame {k}")
        synth2 = StreamSynthesizer(W, H, ds, seed=500 + trial)
        tail = [synth2.iframe(0x18), synth2.pframe()]
        y2, _o2, e2 = dec.decode_stream_chunk(tail)
        assert e2 is None and y2.shape[0] == 2
        fresh = OracleDecoder(W, H, ds)
        for k in range(2):
            fresh.data = tail[k]
            fresh.offset = 0
            fresh.decode_frame()
            np.testing.assert_array_equal(
                y2[k], np.concatenate([fresh.y_planes[0].reshape(-1, S),
                                       fresh.uv_planes[0].reshape(-1, S)]),
                err_msg=f"trial {trial} recovery frame {k}")
    assert n_err >= 1


def test_truncated_container_is_contained():
    """A MODS file cut short (its keyframe index is at the end) fails in
    the demuxer, before any decode, as the oracle's does; a Moflex stream
    cut mid-stream decodes the frames it still holds, the same as the
    oracle, and never hangs."""
    blob = _build_fixture()
    for cut in (blob[:16], blob[:len(blob) // 2]):
        with pytest.raises(Exception) as port_err:
            list(pt.decode_mods(cut, engine="cpu"))
        with pytest.raises(Exception) as oracle_err:
            list(jt.decode_mods(cut, engine="oracle"))
        assert port_err.type is oracle_err.type
    blob = _build_moflex(nframes=6)
    cut = blob[:len(blob) * 2 // 3]
    got = list(pt.decode_moflex(cut, engine="cpu"))
    assert 0 < len(got) < 6
    _same(got, list(jt.decode_moflex(cut, engine="oracle")))


def test_moflex_with_audio_moc5_and_vx2_match_oracle():
    blob = _build_moflex(nframes=5)
    got = list(pt.decode_moflex(blob, engine="cpu"))
    assert len(got) == 5 and any(f.pcm is not None for f in got)
    _same(got, list(jt.decode_moflex(blob, engine="oracle")))

    W, H = 64, 48
    synth = StreamSynthesizer(W, H, MobiclipVersion.MOFLEX_3DS, seed=31)
    mux = Moc5Muxer(W, H, fps=30.0)
    for i in range(4):
        mux.add_frame(synth.iframe(0x14) if i == 0 else synth.pframe())
    blob = mux.to_bytes()
    got = list(pt.decode_moc5(blob, engine="cpu"))
    assert len(got) == 4
    _same(got, list(jt.decode_moc5(blob, engine="oracle")))

    synth = StreamSynthesizer(256, 192, MobiclipVersion.MOFLEX_3DS, seed=32)
    mux = Vx2Muxer()
    pcm = (1000 * np.sin(np.arange(32768) / 20)).astype("<i2").tobytes()
    for i in range(3):
        mux.add_frame(synth.iframe(0x14) if i == 0 else synth.pframe(),
                      pcm if i == 0 else None)
    blob = mux.to_bytes()
    got = list(pt.decode_vx2(blob, engine="cpu"))
    assert len(got) == 3 and got[0].pcm is not None
    _same(got, list(jt.decode_vx2(blob, engine="oracle")))


@pytest.mark.parametrize("fmt", ["y4m", "avi"])
def test_cli_decode_matches_oracle_bytes(tmp_path, capsys, fmt):
    src = tmp_path / "clip.mods"
    src.write_bytes(_build_fixture())
    outs = {}
    for eng in ("cpu", "oracle"):
        assert main(["decode", str(src), str(tmp_path / eng), "--engine",
                     eng, "--format", fmt]) == 0
        stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert stats["frames"] == 6 and stats["format"] == fmt
        outs[eng] = sorted(tmp_path.glob(f"{eng}.*"))
    assert [p.suffix for p in outs["cpu"]] == (
        [".wav", ".y4m"] if fmt == "y4m" else [".avi"])
    for a, b in zip(outs["cpu"], outs["oracle"]):
        assert a.read_bytes() == b.read_bytes(), a.name
    jt.transcode(src, tmp_path / "jax", engine="oracle", fmt=fmt)
    assert (tmp_path / f"jax.{fmt}").read_bytes() == (
        tmp_path / f"cpu.{fmt}").read_bytes()


def test_cli_info_and_play(tmp_path, capsys):
    src = tmp_path / "clip.mods"
    src.write_bytes(_build_fixture())
    assert main(["info", str(src)]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info == jt.probe_info(src)
    res = subprocess.run(
        [sys.executable, "-m", "mobiclipdecoder_tpu_torch", "info", str(src)],
        cwd=Path(__file__).resolve().parent.parent, capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout) == info
    assert main(["play", str(src), "--engine", "cpu", "--no-pacing",
                 "--dump-frame", "2", "--dump-path",
                 str(tmp_path / "f2.ppm")]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["frames"] == 6 and stats["audio_samples"] == 0
    assert (tmp_path / "f2.ppm").read_bytes()[:2] == b"P6"


def test_jax_module_keeps_its_own_factory():
    """The port's transcoder is a module of its own with its own decoder
    factory; the JAX package's transcoder still builds the JAX engines.
    The JAX engine names raise in the port; its own wavefront engine and
    encoder are the port's modules."""
    assert pt is not jt
    assert pt._make_video_decoder.__module__ == (
        "mobiclipdecoder_tpu_torch.runtime.transcode")
    assert jt._make_video_decoder.__module__ == (
        "mobiclipdecoder_tpu.runtime.transcode")
    from mobiclipdecoder_tpu.ops.vmem_engine import VmemVideoDecoder as JV
    assert isinstance(jt._make_video_decoder(64, 48, MobiclipVersion.MODS_DS,
                                             "tpu"), JV)
    assert isinstance(pt._make_video_decoder(64, 48, MobiclipVersion.MODS_DS,
                                             "cpu"), VmemVideoDecoder)
    for eng in ("tpu", "tpu-xla", "gpu"):
        with pytest.raises(ValueError, match=eng):
            pt._make_video_decoder(64, 48, MobiclipVersion.MODS_DS, eng)
    from mobiclipdecoder_tpu_torch.models.pipeline import (
        WavefrontVideoDecoder)
    assert isinstance(pt._make_video_decoder(64, 48, MobiclipVersion.MODS_DS,
                                             "wavefront-cpu"),
                      WavefrontVideoDecoder)
    assert WavefrontVideoDecoder.__module__.startswith(
        "mobiclipdecoder_tpu_torch.")
    from mobiclipdecoder_tpu_torch.models import encoder
    assert encoder.SadVolume.__module__ == (
        "mobiclipdecoder_tpu_torch.ops.mesearch")


def test_engine_cuda_raises_without_gpu(tmp_path, monkeypatch):
    """--engine cuda (the CLI's default) never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = tmp_path / "clip.mods"
    src.write_bytes(_build_fixture())
    for argv in (["decode", str(src), str(tmp_path / "o")],
                 ["decode", str(src), str(tmp_path / "o"), "--engine",
                  "cuda"],
                 ["play", str(src), "--no-pacing"]):
        with pytest.raises(RuntimeError, match="cuda"):
            main(argv)
