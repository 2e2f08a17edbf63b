"""The port's decoders (mobiclipdecoder_tpu_torch/ops/vmem_engine.py) vs
the sequential oracle, bit-exact, at 64x48 on the CPU (where the executor
is its plain PyTorch version)."""
import ast
from pathlib import Path

import numpy as np
import pytest

from mobiclipdecoder_tpu.models.oracle_video import (MobiclipVersion,
                                                     OracleDecoder)
from mobiclipdecoder_tpu.testing.synth import StreamSynthesizer

from mobiclipdecoder_tpu_torch.ops import executor, packing
from mobiclipdecoder_tpu_torch.ops.vmem_engine import (VmemBatchDecoder,
                                                       VmemVideoDecoder)

W, H = 64, 48
DS = MobiclipVersion.MODS_DS
PORT = Path(__file__).resolve().parent.parent / "mobiclipdecoder_tpu_torch"


def _frames(version, seeds, nframes, qp=0x18):
    synths = [StreamSynthesizer(W, H, version, seed=s) for s in seeds]
    return [[s.iframe(qp) if f == 0 else s.pframe() for s in synths]
            for f in range(nframes)]


def _oracle(version, packets):
    o = OracleDecoder(W, H, version)
    S = o.stride
    out = []
    for pkt in packets:
        o.data = pkt
        o.offset = 0
        o.decode_frame()
        out.append(np.concatenate([o.y_planes[0].reshape(-1, S),
                                   o.uv_planes[0].reshape(-1, S)]))
    return np.stack(out)


def _check_oracle(version, frames, got):
    """got (F, B, HH, S) against the oracle, stream by stream."""
    for b in range(len(frames[0])):
        exp = _oracle(version, [fp[b] for fp in frames])
        bad = np.argwhere((got[:, b] != exp).any(axis=(1, 2))).ravel()
        assert bad.size == 0, f"stream {b}: frames {bad.tolist()} differ"


@pytest.mark.parametrize("version", [MobiclipVersion.MODS_DS,
                                     MobiclipVersion.MOFLEX_3DS])
@pytest.mark.parametrize("native", [True, False, None])
def test_fused_gop_matches_oracle(version, native):
    frames = _frames(version, (1, 2), 6)
    dec = VmemBatchDecoder(W, H, version, batch=2, device="cpu",
                           native=native)
    assert (dec.natives is None) == (native is False)
    before = executor.launches
    out = dec.decode_gop(frames)
    assert executor.launches == before      # CPU: the plain executor
    assert out.shape == (6, 2, H + H // 2, 256) and out.dtype == np.uint8
    _check_oracle(version, frames, out)


def test_decode_gop_fused_flag_takes_the_same_path():
    frames = _frames(DS, (3, 4), 3)
    a = VmemBatchDecoder(W, H, DS, batch=2, device="cpu")
    b = VmemBatchDecoder(W, H, DS, batch=2, device="cpu")
    np.testing.assert_array_equal(a.decode_gop(frames, fused=False),
                                  b.decode_gop(frames, fused=True))


@pytest.mark.parametrize("native", [True, False])
def test_decode_gops_streaming_and_ring_across_gops(native):
    """Three GOPs whose lengths (4, 3, 2) leave the modular ring at
    different slots; each continues from the ring the last one left, and
    P-frames of a later GOP reference the earlier GOP's frames."""
    synths = [StreamSynthesizer(W, H, DS, seed=s) for s in (5, 6)]
    lens = (4, 3, 2)
    gops = []
    for g, n in enumerate(lens):
        gops.append([[s.iframe(0x18) if (g == 0 and f == 0) else s.pframe()
                      for s in synths] for f in range(n)])
    dec = VmemBatchDecoder(W, H, DS, batch=2, device="cpu", native=native)
    outs = list(dec.decode_gops(iter(gops)))
    assert [o.shape[0] for o in outs] == list(lens)
    allf = [fp for gop in gops for fp in gop]
    _check_oracle(DS, allf, np.concatenate(outs))
    # ring slot 0 is the newest frame, slot 1 the one before
    np.testing.assert_array_equal(
        dec.ring_frame_np(1, 0)[packing.MR:packing.MR + H + H // 2,
                                packing.MCOL:packing.MCOL + 256],
        outs[-1][-1, 1])
    np.testing.assert_array_equal(
        dec.ring_frame_np(0, 1)[packing.MR:packing.MR + H + H // 2,
                                packing.MCOL:packing.MCOL + 256],
        outs[-1][-2, 0])


@pytest.mark.parametrize("native", [True, False])
def test_split_on_chunk_overflow(monkeypatch, native):
    frames = _frames(DS, (7, 8), 6)
    ref = VmemBatchDecoder(W, H, DS, batch=2, device="cpu",
                           native=native).decode_gop(frames)
    monkeypatch.setattr(packing, "NCT_BUCKETS", (4,))     # force splits
    got = VmemBatchDecoder(W, H, DS, batch=2, device="cpu",
                           native=native).decode_gop(frames)
    np.testing.assert_array_equal(got, ref)
    _check_oracle(DS, frames, got)


def test_device_crop_matches_host_crop():
    frames = _frames(DS, (9, 10), 3)
    full = VmemBatchDecoder(W, H, DS, batch=2, device="cpu").decode_gop(
        frames)
    cropped = VmemBatchDecoder(W, H, DS, batch=2, device="cpu",
                               crop=True).decode_gop(frames)
    S = 256
    assert cropped.shape[-1] == W
    np.testing.assert_array_equal(cropped[:, :, :H], full[:, :, :H, :W])
    np.testing.assert_array_equal(cropped[:, :, H:, :W // 2],
                                  full[:, :, H:, :W // 2])
    np.testing.assert_array_equal(cropped[:, :, H:, W // 2:],
                                  full[:, :, H:, S // 2:S // 2 + W // 2])


@pytest.mark.parametrize("native", [True, False])
def test_decode_stream_chunk_malformed_packet(native):
    pkts = [fp[0] for fp in _frames(DS, (11,), 6)]
    bad = 3
    pkts[bad] = b"\x00"
    dec = VmemVideoDecoder(W, H, DS, device="cpu", native=native)
    yuv, offs, err = dec.decode_stream_chunk(pkts)
    assert err == bad
    assert yuv.shape[0] == bad and offs == [len(p) for p in pkts[:bad]]
    np.testing.assert_array_equal(yuv, _oracle(DS, pkts[:bad]))


def test_decode_stream_chunk_then_decode_frame_matches_oracle():
    pkts = [fp[0] for fp in _frames(MobiclipVersion.MOFLEX_3DS, (12,), 7)]
    dec = VmemVideoDecoder(W, H, MobiclipVersion.MOFLEX_3DS, device="cpu")
    yuv, offs, err = dec.decode_stream_chunk(pkts[:5])
    assert err is None and len(offs) == 5
    rest = [np.concatenate(dec.decode_frame(p)) for p in pkts[5:]]
    np.testing.assert_array_equal(np.concatenate([yuv, np.stack(rest)]),
                                  _oracle(MobiclipVersion.MOFLEX_3DS, pkts))
    prev = dec.ring_frame_np(0, 1)
    np.testing.assert_array_equal(
        prev[packing.MR:packing.MR + H + H // 2,
             packing.MCOL:packing.MCOL + 256], yuv[-1] if len(rest) == 1
        else rest[-2])


def test_decode_frames_is_fused_f1():
    frames = _frames(DS, (13, 14, 15), 3)
    dec = VmemBatchDecoder(W, H, DS, batch=3, device="cpu")
    out = np.stack([dec.decode_frames(fp) for fp in frames])
    _check_oracle(DS, frames, out)
    assert dec.metrics.frames == 9


def test_scan_packets_feeds_the_executor():
    """scan_packets gives one frame per stream in the executor's packed
    layout; executing it reproduces decode_frames."""
    import torch
    from mobiclipdecoder_tpu_torch.ops.prologue import crop_frames
    from mobiclipdecoder_tpu_torch.ops.residuals import _residuals
    pkts = _frames(DS, (16, 17), 1)[0]
    a = VmemBatchDecoder(W, H, DS, batch=2, device="cpu")
    ops, coefs, sizes = a.scan_packets(pkts)
    assert ops.shape[0] == 2 and ops.shape[2:] == (packing.CHUNK, 4)
    resid = _residuals(torch.from_numpy(coefs).view(-1, 64),
                       torch.from_numpy(sizes).view(-1)).view(coefs.shape)
    frames = executor.run_gop(torch.from_numpy(ops), resid, a.ring, 1, H,
                              256)
    b = VmemBatchDecoder(W, H, DS, batch=2, device="cpu")
    np.testing.assert_array_equal(crop_frames(frames, H, 256)[0].numpy(),
                                  b.decode_frames(pkts))


def test_dense_fallback_for_coefficients_beyond_int16():
    """A high-QP I-frame whose levels exceed int16 takes the dense upload
    and still decodes bit-exactly."""
    from mobiclipdecoder_tpu.utils.native import NativePlanner
    for seed in range(40):
        pkt = StreamSynthesizer(W, H, DS, seed=seed).iframe(51)
        if NativePlanner(W, H, int(DS)).scan_gop_packed([pkt])[
                "val_overflow"]:
            break
    else:
        raise AssertionError("no seed produced a >int16 coefficient")
    dec = VmemVideoDecoder(W, H, DS, device="cpu")
    yuv, _offs, err = dec.decode_stream_chunk([pkt])
    assert err is None
    np.testing.assert_array_equal(yuv, _oracle(DS, [pkt]))


def test_unported_geometry_and_missing_device_raise(monkeypatch):
    """Every geometry of the codec is ported (400x240 and 640x480 build
    a decoder at strides 512 and 1024); the device is explicit, and a
    CUDA device that is not there raises instead of falling back."""
    import torch
    for (w, h), stride in (((400, 240), 512), ((640, 480), 1024)):
        assert VmemBatchDecoder(w, h, MobiclipVersion.MOFLEX_3DS,
                                device="cpu").stride == stride
    with pytest.raises(TypeError):
        VmemBatchDecoder(W, H, DS)                      # device is explicit
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        VmemBatchDecoder(W, H, DS, device="cuda")


def test_port_never_imports_jax():
    """No file of the port imports JAX or the JAX package by name (its
    ``__init__`` imports JAX); the codec's host modules are the port's own
    copies."""
    files = sorted(p for p in PORT.rglob("*.py")
                   if "build" not in p.relative_to(PORT).parts)
    files.append(PORT.parent / "chip_smoke.py")
    assert len(files) > 8
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
                names += [f"{node.module}.{a.name}" for a in node.names]
            else:
                continue
            absolute = isinstance(node, ast.Import) or not node.level
            for n in names:
                assert n != "jax" and not n.startswith("jax."), (path, n)
                assert not absolute or n.split(".")[0] != (
                    "mobiclipdecoder_tpu"), (path, n)
                assert "ops.vmem_engine" not in n or n.startswith(
                    "mobiclipdecoder_tpu_torch") or (
                        node.level and "vmem_engine" in n), (path, n)
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "mobiclipdecoder_tpu.ops.vmem_engine" not in text, path


def test_importing_the_port_leaves_jax_unimported():
    """In a fresh interpreter, every module of the port and everything
    chip_smoke.py imports load neither jax nor the JAX package: no loaded
    module has either name, and no loaded module's file lies under
    mobiclipdecoder_tpu/ (a package whose search path points there would
    load the JAX package's files under another name)."""
    import subprocess
    import sys
    mods = sorted(
        ".".join(("mobiclipdecoder_tpu_torch",)
                 + p.relative_to(PORT).with_suffix("").parts).removesuffix(
                     ".__init__")
        for p in PORT.rglob("*.py")
        if "build" not in p.relative_to(PORT).parts)
    assert "mobiclipdecoder_tpu_torch.utils.native" in mods
    assert "mobiclipdecoder_tpu_torch.graft_entry" in mods
    assert "mobiclipdecoder_tpu_torch.tools.warm_kernels" in mods
    assert "mobiclipdecoder_tpu_torch.bench" in mods
    assert "mobiclipdecoder_tpu_torch.tools.scaling_bench" in mods
    assert "mobiclipdecoder_tpu_torch.ops.prologue_kernels" in mods
    jax_dir = str(PORT.parent / "mobiclipdecoder_tpu") + "/"
    code = (
        "import importlib, os, sys; pre = set(sys.modules);"
        "sys.path.insert(0, '.'); import chip_smoke;"
        f"[importlib.import_module(m) for m in {mods!r}];"
        "new = [sys.modules[m] for m in set(sys.modules) - pre];"
        "bad = sorted(m.__name__ for m in new if m.__name__.split('.')[0] in "
        "('jax', 'jaxlib', 'mobiclipdecoder_tpu') or os.path.realpath("
        f"getattr(m, '__file__', None) or '').startswith({jax_dir!r}));"
        "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=PORT.parent,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
