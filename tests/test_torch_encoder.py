"""The port's encoder (mobiclipdecoder_tpu_torch/models/encoder.py) and its
SAD volume (ops/mesearch.py) against the JAX package's, on the CPU at
64x48 with inputs drawn from numpy seeds: equal volumes, equal packet
bytes, equal .moflex files."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobiclipdecoder_tpu.models.encoder import MobiclipEncoder as JEncoder
from mobiclipdecoder_tpu.models.oracle_video import MobiclipVersion as JV
from mobiclipdecoder_tpu.ops import mesearch as jm
from mobiclipdecoder_tpu.runtime import transcode as jt
from mobiclipdecoder_tpu.utils.rawio import Y4MWriter

from mobiclipdecoder_tpu_torch.__main__ import main
from mobiclipdecoder_tpu_torch.models.encoder import MobiclipEncoder
from mobiclipdecoder_tpu_torch.models.oracle_video import (MobiclipVersion,
                                                           OracleDecoder)
from mobiclipdecoder_tpu_torch.models.pipeline import WavefrontVideoDecoder
from mobiclipdecoder_tpu_torch.ops import mesearch as pm
from mobiclipdecoder_tpu_torch.runtime import transcode as pt

W, H = 64, 48


def _test_video(W, H, n, seed=0):
    """The frames of tests/test_encoder.py."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    frames = []
    for t in range(n):
        y = (128 + 60 * np.sin(xx / 17 + t / 3) * np.cos(yy / 13)
             + rng.normal(0, 3, (H, W))).clip(0, 255).astype(np.uint8)
        u = (128 + 40 * np.sin((xx[:H // 2 * 2:2, :W // 2 * 2:2] / 23)
                               + t / 5)).clip(0, 255).astype(np.uint8)
        v = (128 + 40 * np.cos((yy[:H // 2 * 2:2, :W // 2 * 2:2] / 19)
                               - t / 4)).clip(0, 255).astype(np.uint8)
        frames.append((y, u, v))
    return frames


@pytest.mark.parametrize("range_", [6, 16])
def test_sad_volume_matches_jax(range_):
    rng = np.random.default_rng(range_)
    cur = rng.integers(0, 256, (H, W)).astype(np.uint8)
    refs = [rng.integers(0, 256, (H, W)).astype(np.uint8) for _ in range(2)]
    refs[1][:] = 255 * (rng.random((H, W)) < 0.5)      # SADs near the top
    port = pm._sad8_volume(torch.from_numpy(cur.astype(np.int32)),
                           torch.from_numpy(np.stack(refs).astype(np.int32)),
                           range_)
    ref = jm._sad8_volume(jnp.asarray(cur, jnp.int32),
                          jnp.asarray(np.stack(refs), jnp.int32), range_)
    side = 2 * range_ + 1
    assert port.shape == (side * side, 2, H // 8, W // 8)
    assert port.dtype == torch.int32
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    pv = pm.SadVolume(cur, refs, range_=range_, device="cpu")
    jv = jm.SadVolume(cur, refs, range_=range_)
    np.testing.assert_array_equal(pv.vol, jv.vol)
    for leaf in ((0, 0, 16, 16, -12, 12, -12, 12, 2),
                 (24, 16, 8, 16, -4, 30, -30, 2, 2),
                 (56, 40, 8, 8, -40, 0, -40, 0, 1)):
        assert pv.leaf_best(*leaf) == jv.leaf_best(*leaf)
    assert pm.SadVolume(cur, [], device="cpu").vol is None


@pytest.mark.parametrize("version,kw", [
    ("MOFLEX_3DS", dict(quantizer=0x14, gop=3)),
    ("MODS_DS", dict(quantizer=0x14, gop=3)),
    ("MOFLEX_3DS", dict(quantizer=0x14, gop=4, refs=2, me_range=6)),
], ids=["moflex", "mods", "moflex-refs2-range6"])
def test_encoder_bytes_match_jax(version, kw):
    """Same frames in, same packet bytes out, and the port's packets decode
    (oracle and wavefront engine) to the encoder's own reconstruction."""
    frames = _test_video(W, H, 4)
    port = MobiclipEncoder(W, H, MobiclipVersion[version], device="cpu",
                           **kw)
    ref = JEncoder(W, H, JV[version], **kw)
    dec = OracleDecoder(W, H, MobiclipVersion[version])
    wf = WavefrontVideoDecoder(W, H, MobiclipVersion[version], device="cpu")
    for i, (y, u, v) in enumerate(frames):
        pkt = port.encode_frame(y, u, v)
        assert pkt == ref.encode_frame(y, u, v), f"frame {i}"
        dec.data = pkt + b"\x00\x00"
        dec.offset = 0
        dec.decode_frame()
        np.testing.assert_array_equal(dec.y_planes[0], port.twin.y_planes[0])
        np.testing.assert_array_equal(dec.uv_planes[0],
                                      port.twin.uv_planes[0])
        wy, wuv = wf.decode_frame(pkt + b"\x00\x00")
        np.testing.assert_array_equal(wy.ravel(), port.twin.y_planes[0])
        np.testing.assert_array_equal(wuv.ravel(), port.twin.uv_planes[0])
    assert port.device == torch.device("cpu")


def _write_y4m(path, n=5):
    yy, xx = np.mgrid[0:H, 0:W]
    w = Y4MWriter(path, W, H, 24.0)
    for t in range(n):
        y = (128 + 80 * np.sin(xx / 11 + t / 2)).clip(0, 255).astype(np.uint8)
        u = np.full((H // 2, W // 2), 100 + 5 * t, np.uint8)
        v = np.full((H // 2, W // 2), 140 - 5 * t, np.uint8)
        w.add_frame(y, u, v)
    w.close()


def test_encode_y4m_and_cli_match_jax(tmp_path, capsys):
    """encode_y4m_to_moflex and `encode --device cpu` write the JAX
    package's .moflex bytes; the file decodes like the oracle."""
    src = tmp_path / "in.y4m"
    _write_y4m(src)
    stats = pt.encode_y4m_to_moflex(src, tmp_path / "port.moflex", qp=0x10,
                                    gop=4, device="cpu")
    jstats = jt.encode_y4m_to_moflex(src, tmp_path / "jax.moflex", qp=0x10,
                                     gop=4)
    assert stats == jstats and stats["frames"] == 5
    blob = (tmp_path / "port.moflex").read_bytes()
    assert blob == (tmp_path / "jax.moflex").read_bytes()
    assert main(["encode", str(src), str(tmp_path / "cli.moflex"),
                 "--device", "cpu"]) == 0
    cli = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli["frames"] == 5
    jt.encode_y4m_to_moflex(src, tmp_path / "jax2.moflex")
    assert (tmp_path / "cli.moflex").read_bytes() == (
        tmp_path / "jax2.moflex").read_bytes()
    frames = list(pt.decode_moflex(blob, engine="wavefront-cpu"))
    want = list(jt.decode_moflex(blob, engine="oracle"))
    assert len(frames) == len(want) == 5
    for a, b in zip(frames, want):
        np.testing.assert_array_equal(a.y, b.y)


def test_encoder_on_cuda_raises_without_gpu(tmp_path, monkeypatch):
    """The encoder, its SAD volume and the CLI's default device never fall
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        MobiclipEncoder(W, H, MobiclipVersion.MOFLEX_3DS, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        pm.SadVolume(np.zeros((H, W), np.uint8), [np.zeros((H, W),
                                                           np.uint8)],
                     device="cuda")
    src = tmp_path / "in.y4m"
    _write_y4m(src, n=2)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["encode", str(src), str(tmp_path / "o.moflex")])
    with pytest.raises(TypeError):
        MobiclipEncoder(W, H)                              # device is explicit
