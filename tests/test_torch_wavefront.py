"""The port's wavefront engine (mobiclipdecoder_tpu_torch/models/pipeline.py,
ops/idct.py, parallel/batch.py) against the JAX package's (``--engine
tpu-xla``) and the oracle, on the CPU at small sizes with inputs drawn
from numpy seeds.  Every comparison is exact."""
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from test_mods_e2e import _build_fixture  # noqa: E402

from mobiclipdecoder_tpu.models import pipeline as jp  # noqa: E402
from mobiclipdecoder_tpu.ops import idct as jidct  # noqa: E402
from mobiclipdecoder_tpu.parallel.batch import (  # noqa: E402
    BatchVideoDecoder as JBatch)
from mobiclipdecoder_tpu.runtime import transcode as jt  # noqa: E402

from mobiclipdecoder_tpu_torch.__main__ import main  # noqa: E402
from mobiclipdecoder_tpu_torch.models import pipeline as pp  # noqa: E402
from mobiclipdecoder_tpu_torch.models.oracle_video import (  # noqa: E402
    MobiclipVersion, OracleDecoder)
from mobiclipdecoder_tpu_torch.models.plan import (  # noqa: E402
    PlanningDecoder)
from mobiclipdecoder_tpu_torch.ops import idct as pidct  # noqa: E402
from mobiclipdecoder_tpu_torch.parallel.batch import (  # noqa: E402
    BatchVideoDecoder)
from mobiclipdecoder_tpu_torch.runtime import transcode as pt  # noqa: E402
from mobiclipdecoder_tpu_torch.testing.synth import (  # noqa: E402
    StreamSynthesizer)

DS, MF = MobiclipVersion.MODS_DS, MobiclipVersion.MOFLEX_3DS


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _packets(W, H, version, seed, n):
    s = StreamSynthesizer(W, H, version, seed=seed)
    return [s.iframe(0x18) if i == 0 else s.pframe() for i in range(n)]


def _plans(W, H, version, seed, n):
    """FramePlans of n consecutive frames from the Python planner."""
    p = PlanningDecoder(W, H, version)
    out = []
    for pkt in _packets(W, H, version, seed, n):
        p.data = pkt
        p.offset = 0
        p.decode_frame()
        out.append(p.plan())
    return out


@pytest.mark.parametrize("n", [8, 4])
def test_idct_matches_jax(n):
    rng = np.random.default_rng(40 + n)
    c = rng.integers(-3000, 3000, (64, n, n)).astype(np.int32)
    c[:8] = rng.integers(-2**20, 2**20, (8, n, n))
    port = (pidct.idct8 if n == 8 else pidct.idct4)(_t(c))
    ref = (jidct.idct8 if n == 8 else jidct.idct4)(jnp.asarray(c))
    assert port.dtype == torch.int32
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("size", [4, 8, 16])
def test_plane_predictor_matches_jax(size):
    """The plane modes' closed form, byte aliasing included: taps over
    0..255 and gradients large enough that the composed bytes wrap."""
    rng = np.random.default_rng(size)
    N = 64
    taps = rng.integers(0, 256, (N, 33)).astype(np.int32)
    taps[0], taps[1] = 0, 255
    grad = rng.integers(-600, 600, N).astype(np.int32)
    grad[:8] = [-2000, 2000, -1, 0, 1, 127, -128, 900]
    sz = np.full(N, size, np.int32)
    port = pp._plane_pred_batch(_t(taps), _t(sz), _t(grad))
    ref = jp._plane_pred_batch(jnp.asarray(taps), jnp.asarray(sz),
                               jnp.asarray(grad))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    # the same ops as plane-mode intra ops (mode 2 at 8 and 16, mode 12 at
    # 4) through a whole level on a random plane
    H, S = 48, 256
    HH = H + H // 2
    buf = rng.integers(0, 256, (HH, S)).astype(np.int32)
    seqmap = np.full((HH // 4, S // 4), -1, np.int32)
    seqmap[:, :8] = 0
    ops = np.zeros((3, 11), np.int32)
    for k, (y, x) in enumerate(((16, 16), (16, 32 + size), (0, 64 + size))):
        ops[k] = (0, y, x, size, 12 if size == 4 else 2, grad[k], 0,
                  int(y > 0), 1, 1, 5)
    coefs = np.zeros((3, 64), np.int32)
    port = pp._intra_level_kernel(
        torch.cat([_t(buf).reshape(1, -1), torch.zeros(1, 1,
                                                       dtype=torch.int32)],
                  1), _t(seqmap)[None], _t(ops)[None],
        torch.zeros((1, 3, 8, 8), dtype=torch.int32), H, S)
    ref = jp._intra_level_kernel(jnp.asarray(buf), jnp.asarray(seqmap),
                                 jnp.asarray(ops), jnp.asarray(coefs), H, S)
    np.testing.assert_array_equal(port[0, :HH * S].reshape(HH, S).numpy(),
                                  np.asarray(ref))


def _scatter_targets(ops, H, S):
    """The flat pixel indices an intra level's ops write."""
    out = []
    for pid, y, x, size in ops[:, :4]:
        if size > 0:
            r0 = y + pid * H
            ii, jj = np.mgrid[0:size, 0:size]
            out.append(((r0 + ii) * S + x + jj).ravel())
    return np.concatenate(out) if out else np.zeros(0, np.int64)


@pytest.mark.parametrize("version", [DS, MF])
def test_intra_levels_match_jax_and_write_disjoint_pixels(version):
    """Every level of a real I-frame plan and of a P-frame plan: the
    level's ops write disjoint pixels (so the scatter's only repeated index
    is the sentinel), MC leaves are disjoint, and one level run from the
    frame's own state equals the JAX engine's level."""
    W, H = 64, 48
    plans = _plans(W, H, version, seed=21, n=2)
    S = plans[0].stride
    HH = H + H // 2
    for plan in plans:
        a = pp.prepare_plan(plan)
        for lv in range(a["n_levels"]):
            t = _scatter_targets(a["iops"][lv], H, S)
            assert len(np.unique(t)) == len(t), lv
        mc = plan.mc
        luma = []
        for y, x, w, h, *_ in mc:
            ii, jj = np.mgrid[0:h, 0:w]
            luma.append(((y + ii) * S + x + jj).ravel())
        if luma:
            luma = np.concatenate(luma)
            assert len(np.unique(luma)) == len(luma)
    # the I-frame's middle level from the state the levels before it leave
    plan = plans[0]
    a = pp.prepare_plan(plan)
    tt = pp.upload_plan(a, "cpu")
    ring = torch.zeros((1, 6, HH, S), dtype=torch.int32)
    lv = a["n_levels"] // 2
    assert a["n_levels"] >= 3 and (a["iops"][lv][:, 3] > 0).sum() >= 2
    buf = torch.zeros((1, HH * S + 1), dtype=torch.int32)
    buf = pp._mc_kernel(ring, buf, tt["mc"][None], H, S)
    buf = pp._resid_kernel(buf, tt["resid"][None], tt["resid_coef"][None],
                           H, S)
    res8 = pp._residual8(tt["icoef"][None], tt["iops"][None, ..., 3] != 4)
    for k in range(lv):
        buf = pp._intra_level_kernel(buf, tt["seqmap"][None],
                                     tt["iops"][None, k], res8[:, k], H, S)
    port = pp._intra_level_kernel(buf, tt["seqmap"][None],
                                  tt["iops"][None, lv], res8[:, lv], H, S)
    ref = jp._intra_level_kernel(
        jnp.asarray(buf[0, :HH * S].reshape(HH, S).numpy()),
        jnp.asarray(a["seqmap"]), jnp.asarray(a["iops"][lv]),
        jnp.asarray(a["icoef"][lv]), H, S)
    assert not torch.equal(port, buf)
    np.testing.assert_array_equal(port[0, :HH * S].reshape(HH, S).numpy(),
                                  np.asarray(ref))


@pytest.mark.parametrize("version", [DS, MF])
def test_decode_frame_core_matches_jax(version):
    """One P-frame plan over a random reference ring (so MC reads real
    pixels from every slot) through decode_frame_core, against the JAX
    engine's jitted core on its bucketed arrays."""
    W, H = 64, 48
    plan = _plans(W, H, version, seed=5, n=3)[2]
    assert plan.mc.shape[0] > 0
    S = plan.stride
    HH = H + H // 2
    ring = np.random.default_rng(9).integers(0, 256, (6, HH, S)).astype(
        np.int32)
    a = pp.prepare_plan(plan)
    t = pp.upload_plan(a, "cpu")
    port = pp.decode_frame_core(
        _t(ring)[None], t["mc"][None], t["resid"][None],
        t["resid_coef"][None], t["iops"][None], t["icoef"][None],
        t["seqmap"][None], a["n_levels"], H, S)[0]
    j = jp.prepare_plan(plan)
    ref = jp._decode_frame_jit(jnp.asarray(ring), j["mc"], j["resid"],
                               j["resid_coef"], j["iops"], j["icoef"],
                               j["seqmap"], j["n_levels"], H, S)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("W,H,version", [(64, 48, DS), (64, 48, MF),
                                         (272, 32, MF), (528, 32, MF)],
                         ids=["64x48-mods", "64x48-moflex",
                              "272x32-stride512", "528x32-stride1024"])
def test_wavefront_decoder_matches_jax_and_oracle(W, H, version):
    pkts = _packets(W, H, version, seed=3, n=4)
    port = pp.WavefrontVideoDecoder(W, H, version, device="cpu")
    jdec = jp.JaxVideoDecoder(W, H, version)
    oracle = OracleDecoder(W, H, version)
    S = oracle.stride
    assert port.stride == S == {64: 256, 272: 512, 528: 1024}[W]
    for i, pkt in enumerate(pkts):
        oracle.data = pkt
        oracle.offset = 0
        oracle.decode_frame()
        y, uv = port.decode_frame(pkt)
        jy, juv = jdec.decode_frame(pkt)
        assert port.offset == jdec.offset == oracle.offset == len(pkt)
        np.testing.assert_array_equal(y, oracle.y_planes[0].reshape(-1, S),
                                      err_msg=f"frame {i} Y")
        np.testing.assert_array_equal(uv, oracle.uv_planes[0].reshape(-1, S),
                                      err_msg=f"frame {i} UV")
        np.testing.assert_array_equal(y, jy)
        np.testing.assert_array_equal(uv, juv)
    assert port.ring.shape == (6, H + H // 2, S)
    assert port.ring.dtype == torch.int32


def test_native_scan_fits_a_640x480_iframe():
    """A 640x480 I-frame has more intra ops than the JAX package's fixed
    8,192-row scan caps, so its native scan fails there; the port's caps
    grow with the frame, and its plan equals the Python planner's."""
    from mobiclipdecoder_tpu.utils.native import NativePlanner as JNative
    from mobiclipdecoder_tpu_torch.utils.native import NativePlanner
    W, H = 640, 480
    pkt = _packets(W, H, MF, seed=7, n=1)[0]
    with pytest.raises(ValueError, match="capacity"):
        JNative(W, H, int(MF)).scan(pkt)
    got = NativePlanner(W, H, int(MF)).scan(pkt)
    p = PlanningDecoder(W, H, MF)
    p.data = pkt
    p.offset = 0
    p.decode_frame()
    want = p.plan()
    assert got.intra.shape[0] > NativePlanner.INTRA_CAP
    for k in ("mc", "resid", "resid_coef", "intra", "intra_coef", "seq_y",
              "seq_uv", "n_levels"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)


def test_python_planner_path_matches_native():
    W, H = 64, 48
    pkts = _packets(W, H, DS, seed=8, n=3)
    a = pp.WavefrontVideoDecoder(W, H, DS, device="cpu", native=False)
    b = pp.WavefrontVideoDecoder(W, H, DS, device="cpu", native=True)
    assert a.native is None and b.native is not None
    for pkt in pkts:
        for x, y in zip(a.decode_frame(pkt), b.decode_frame(pkt)):
            np.testing.assert_array_equal(x, y)


def _oracle_gop(version, seed, W, H, nframes):
    synth = StreamSynthesizer(W, H, version, seed=seed)
    dec = OracleDecoder(W, H, version)
    pkts, planes = [], []
    for i in range(nframes):
        pkt = synth.iframe(0x18) if i == 0 else synth.pframe()
        dec.data = pkt
        dec.offset = 0
        dec.decode_frame()
        pkts.append(pkt)
        planes.append(np.concatenate([dec.y_planes[0].reshape(-1, dec.stride),
                                      dec.uv_planes[0].reshape(-1,
                                                               dec.stride)]))
    return pkts, planes


@pytest.mark.parametrize("use_gop_scan", [False, True])
def test_batch_matches_jax_and_oracle(use_gop_scan):
    W, H, B, F = 64, 48, 4, 3
    data = [_oracle_gop(DS, 100 + b, W, H, F) for b in range(B)]
    bd = BatchVideoDecoder(W, H, DS, batch=B, device="cpu")
    jd = JBatch(W, H, DS, batch=B)
    frames = [[data[b][0][f] for b in range(B)] for f in range(F)]
    if use_gop_scan:
        out = bd.decode_gop(frames)
        ref = jd.decode_gop(frames)
    else:
        out = np.stack([bd.decode_frames(fp) for fp in frames])
        ref = np.stack([jd.decode_frames(fp) for fp in frames])
    assert out.shape == (F, B, H + H // 2, 256) and out.dtype == np.uint8
    np.testing.assert_array_equal(out, ref)
    for f in range(F):
        for b in range(B):
            np.testing.assert_array_equal(out[f, b], data[b][1][f])
    assert bd.ring.shape == (B, 6, H + H // 2, 256)


def test_cli_decode_wavefront_cpu_matches_oracle_bytes(tmp_path, capsys):
    src = tmp_path / "clip.mods"
    src.write_bytes(_build_fixture())
    for eng in ("wavefront-cpu", "oracle"):
        assert main(["decode", str(src), str(tmp_path / eng), "--engine",
                     eng]) == 0
        stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert stats["frames"] == 6 and stats["audio"]
    for ext in (".y4m", ".wav"):
        assert (tmp_path / f"wavefront-cpu{ext}").read_bytes() == (
            tmp_path / f"oracle{ext}").read_bytes(), ext
    assert isinstance(pt._make_video_decoder(64, 48, DS, "wavefront-cpu"),
                      pp.WavefrontVideoDecoder)
    assert not hasattr(pp.WavefrontVideoDecoder, "decode_stream_chunk")


def test_failed_frame_raises_like_the_jax_engine():
    """A frame that fails to scan: the JAX package's ``tpu-xla`` decoder
    has no ``ring_frame_np``, so the transcoder's containment raises
    AttributeError instead of showing the last frame; the port's wavefront
    decoder does the same."""
    blob = bytearray(_build_fixture(nframes=6, seed=31, key_at=(0,)))
    for i in range(len(blob) * 3 // 4, len(blob) * 3 // 4 + 16):
        blob[i] ^= 0xFF
    for mod, eng in ((jt, "tpu-xla"), (pt, "wavefront-cpu")):
        with pytest.raises(AttributeError, match="ring_frame_np") as e:
            list(mod.decode_mods(bytes(blob), engine=eng))
        assert isinstance(e.value.__context__, ValueError)


def test_wavefront_engine_raises_without_gpu(tmp_path, monkeypatch):
    """--engine wavefront never falls back to the CPU, and the batch
    worker keeps its own engines."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = tmp_path / "clip.mods"
    src.write_bytes(_build_fixture())
    for argv in (["decode", str(src), str(tmp_path / "o"), "--engine",
                  "wavefront"],
                 ["play", str(src), "--no-pacing", "--engine", "wavefront"]):
        with pytest.raises(RuntimeError, match="cuda"):
            main(argv)
    with pytest.raises(RuntimeError, match="cuda"):
        BatchVideoDecoder(64, 48, DS, batch=2, device="cuda")
    with pytest.raises(SystemExit):
        main(["batch", str(src), str(tmp_path / "b"), "--engine",
              "wavefront-cpu"])
