"""The port at the wide strides: 512 (3DS 400x240) and 1024 (Wii 640x480),
at small heights so the CPU can run them.  272x32 needs stride 512 and
528x32 stride 1024, as the real sizes do.

Every comparison is exact.  The JAX side runs its Pallas executor in
interpret mode on the CPU, as the JAX package's own tests do; a test that
moves the JAX ring into another layout patches ``_VMEM_RING_BUDGET`` and
clears the JAX package's build and trace caches around itself, since
those are keyed by shape and not by layout.
"""
import shutil

import jax
import numpy as np
import pytest
import torch

from mobiclipdecoder_tpu.models.oracle_video import (MobiclipVersion,
                                                     OracleDecoder)
from mobiclipdecoder_tpu.models.plan import PlanningDecoder, pack_unified
from mobiclipdecoder_tpu.ops import vmem_engine as jve
from mobiclipdecoder_tpu.testing.synth import StreamSynthesizer

from mobiclipdecoder_tpu_torch import state
from mobiclipdecoder_tpu_torch.ops import executor, packing
from mobiclipdecoder_tpu_torch.ops.prologue import (_unpack_ops3,
                                                    crop_frames,
                                                    renormalize_ring)
from mobiclipdecoder_tpu_torch.ops.residuals import _residuals
from mobiclipdecoder_tpu_torch.ops.vmem_engine import (VmemBatchDecoder,
                                                       VmemVideoDecoder)

DS, MF = MobiclipVersion.MODS_DS, MobiclipVersion.MOFLEX_3DS
SIZES = {512: (272, 32), 1024: (528, 32)}


def _stream(W, H, version, seed, n):
    s = StreamSynthesizer(W, H, version, seed=seed)
    return [s.iframe(0x18) if i == 0 else s.pframe() for i in range(n)]


def _oracle(W, H, version, packets):
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


@pytest.fixture
def ring_budget(monkeypatch):
    """Sets the JAX package's VMEM ring budget (which picks its ring
    layout) with its shape-keyed caches cleared before and after."""
    def clear():
        jve._build_gop_executor.cache_clear()
        jve._build_executor.cache_clear()
        jax.clear_caches()

    def set_budget(nbytes):
        monkeypatch.setattr(jve, "_VMEM_RING_BUDGET", nbytes)
        clear()
    yield set_budget
    clear()


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("version", [DS, MF])
@pytest.mark.parametrize("stride", sorted(SIZES))
def test_port_matches_oracle_at_wide_strides(stride, version, native):
    W, H = SIZES[stride]
    seeds = (stride % 7, stride % 7 + 1)
    frames = [list(fp) for fp in zip(*[_stream(W, H, version, s, 4)
                                       for s in seeds])]
    dec = VmemBatchDecoder(W, H, version, batch=2, device="cpu",
                           native=native)
    assert dec.stride == stride and (dec.natives is None) == (not native)
    out = dec.decode_gop(frames)
    assert out.shape == (4, 2, H + H // 2, stride)
    for b in range(2):
        np.testing.assert_array_equal(
            out[:, b], _oracle(W, H, version, [fp[b] for fp in frames]),
            err_msg=f"stream {b}")


@pytest.mark.parametrize("stride,version", [(512, DS), (1024, MF)])
def test_stream_chunk_matches_jax_interpret(stride, version):
    W, H = SIZES[stride]
    pkts = _stream(W, H, version, 21, 3)
    jdec = jve.VmemVideoDecoder(W, H, version, interpret=True)
    jy, joffs, jerr = jdec.decode_stream_chunk(pkts)
    pdec = VmemVideoDecoder(W, H, version, device="cpu")
    py, poffs, perr = pdec.decode_stream_chunk(pkts)
    assert jerr is None and perr is None and poffs == joffs
    np.testing.assert_array_equal(py, jy)
    np.testing.assert_array_equal(py, _oracle(W, H, version, pkts))
    np.testing.assert_array_equal(pdec.ring_frame_np(), jdec.ring_frame_np())


@pytest.mark.parametrize("mode,stride,budget", [
    (1, 512, None), (0, 512, 0), (2, 1024, 2 ** 20)])
def test_jax_ring_carries_into_port(ring_budget, mode, stride, budget):
    """The JAX decoder decodes frames 0-2 with its ring in layout `mode`;
    the port takes that ring through ring_from_jax (its own scanner having
    only scanned frames 0-2) and decodes frames 3-5, which must equal the
    oracle.  The ring also round-trips through ring_to_jax."""
    W, H = SIZES[stride]
    if budget is not None:
        ring_budget(budget)
    pkts = _stream(W, H, MF, 31, 6)
    jdec = jve.VmemVideoDecoder(W, H, MF, interpret=True)
    assert jdec._ring_mode == mode
    jy, _offs, jerr = jdec.decode_stream_chunk(pkts[:3])
    exp = _oracle(W, H, MF, pkts)
    assert jerr is None
    np.testing.assert_array_equal(jy, exp[:3])
    jring = np.asarray(jdec.ring)
    pdec = VmemVideoDecoder(W, H, MF, device="cpu", native=True)
    assert not pdec.ring.any()
    r = pdec.natives[0].scan_gop_packed(pkts[:3])
    assert r["done"] == 3 and not r["err"]
    pdec.ring = state.ring_from_jax(jring, H, stride)
    np.testing.assert_array_equal(
        state.ring_to_jax(pdec.ring, H, stride, packed=mode == 2), jring)
    np.testing.assert_array_equal(pdec.ring_frame_np(), jdec.ring_frame_np())
    py, _offs, perr = pdec.decode_stream_chunk(pkts[3:])
    assert perr is None
    np.testing.assert_array_equal(py, exp[3:])


def _mc_edge_plans(W, H, S, seed):
    """Two frames of hand-built ops at stride S: frame 0 fills every MB by
    plane16 intra, frame 1 moves each MB by MC: the MBs of the first 64
    columns with an MV whose window reaches left of column 0, the others
    with a small one; half-pel cases and residuals are drawn at random."""
    rng = np.random.default_rng(seed)
    f0, f1 = [], []
    for my in range(0, H, 16):
        for mx in range(0, W, 16):
            f0.append(("intra", 0, my, mx, 16, 2,
                       int(rng.integers(-100, 100)), None))
            for x in (mx // 2, mx // 2 + S // 2):
                f0.append(("intra", 1, my // 2, x, 8, 2,
                           int(rng.integers(-60, 60)), None))
            dx = -2 * (mx + int(rng.integers(12, 60))) - int(rng.integers(2))
            if mx >= 64:
                dx = int(rng.integers(-40, 40))
            dy = int(rng.integers(-20, 20))
            # ref 1 is frame 0 (margins zeroed), ref 2 the given ring
            f1.append(("mc", 16, 16, 1 + (mx // 16) % 2, dx, dy,
                       my * S + mx))
            if rng.random() < 0.5:
                c = np.zeros((8, 8), np.int32)
                c[0, 0] = int(rng.integers(-90, 90))
                f1.append(("resid", 0, my, mx, 8, (c, 0)))
    return [[pack_unified(f0, S, H)], [pack_unified(f1, S, H)]]


def test_mc_window_across_column_zero_at_stride_1024(ring_budget):
    """MC windows that cross column 0 at stride 1024.  The port wraps
    window columns modulo SP; the JAX kernel's byte-packed ring (mode 2,
    what real 640x480 uses) rolls over SPX words, i.e. modulo 4 * SPX
    pixels.  Both read zeros there, because columns [S + 8, SP) and the
    pad words hold none of the frame: the port's plain executor, its
    kernel code built with g++, and the JAX kernel in mode 2 agree.  Half
    the windows read a random ring slot whose margin columns hold pixels,
    so reading any column but the wrapped one shows."""
    W, H, S = 528, 32, 1024
    ring_budget(2 ** 20)
    assert jve._ring_mode(H, S) == 2
    plans = _mc_edge_plans(W, H, S, 3)
    rows = plans[1][0]["ops"][1:1 + int(plans[1][0]["ops"][0, 0])]
    mc = rows[(rows[:, 0] & 3) == 1]
    xb = (mc[:, 1] >> 16) + ((mc[:, 2] << 16 >> 16) >> 1)
    assert (xb < 0).any() and (xb + 17 > 0).any()     # windows cross col 0
    ops, coefs, sizes = packing._pack_gop_chunks(plans, 1)
    nct = ops.shape[1]
    _hh, G8, SP = packing._geom(H, S)
    ring0 = np.random.default_rng(4).integers(
        0, 256, state.ring_shape(1, H, S)).astype(np.uint8)
    ring0[..., S + packing.MCOL:] = 0     # never written by any op
    jring, jyuv = jve._decode_gop_fused(
        state.ring_to_jax(torch.from_numpy(ring0), H, S, packed=True),
        ops, coefs, sizes, 2, H, S, True)
    resid = _residuals(torch.from_numpy(coefs).view(-1, 64),
                       torch.from_numpy(sizes).view(-1)).view(1, nct, 256, 64)
    ring_p = torch.from_numpy(ring0.copy())
    frames = executor.run_gop(torch.from_numpy(ops), resid, ring_p, 2, H, S)
    np.testing.assert_array_equal(crop_frames(frames, H, S).numpy(),
                                  np.asarray(jyuv))
    np.testing.assert_array_equal(
        renormalize_ring(ring_p, 2).numpy(),
        state.ring_from_jax(np.asarray(jring), H, S).numpy())
    if shutil.which("g++") is not None:
        ring_h = ring0.copy()
        frames_h = executor.run_gop_host(ops, resid.numpy(), ring_h, 2, H, S)
        np.testing.assert_array_equal(frames_h, frames.numpy())
        np.testing.assert_array_equal(ring_h, ring_p.numpy())


def test_pack_ops3_takes_every_op_at_wide_strides():
    """The upload packs an op's row and column in 12 bits each: every op
    of a 528x32 GOP packs and unpacks unchanged, and so do the largest
    rows and columns of 640x480 (8 + 720 rows, 8 + 1024 + 128 columns)."""
    W, H, S = 528, 32, 1024
    planner = PlanningDecoder(W, H, MF)
    plans = []
    for pkt in _stream(W, H, MF, 41, 4):
        planner.data = pkt
        planner.offset = 0
        planner.decode_frame()
        plans.append([planner.unified_plan()])
    ops, _coefs, _sizes = packing._pack_gop_chunks(plans, 1)
    cc = ops[..., 1] >> 16
    assert cc.max() > 256 + packing.MCOL          # columns past stride 256
    p3 = packing._pack_ops3(ops)
    assert p3 is not None
    np.testing.assert_array_equal(
        _unpack_ops3(torch.from_numpy(p3)).numpy(), ops)
    _hh, G8, SP = packing._geom(480, 1024)
    edge = np.zeros((1, 1, packing.CHUNK, 4), np.int32)
    edge[0, 0, 1] = [1 | 16 << 16 | 16 << 21, (G8 * 8 - 1) | (SP - 1) << 16,
                     -3 & 0xFFFF, 255]
    p3 = packing._pack_ops3(edge)
    assert p3 is not None
    np.testing.assert_array_equal(
        _unpack_ops3(torch.from_numpy(p3)).numpy(), edge)


def test_crop_at_wide_strides_matches_full_planes():
    """crop=True (the transcoder's layout, W < S) keeps Y [0, W) and packs
    U [0, W/2) and V [S/2, S/2 + W/2) adjacent."""
    for stride, (W, H) in SIZES.items():
        frames = [[p] for p in _stream(W, H, MF, 51, 3)]
        full = VmemBatchDecoder(W, H, MF, device="cpu").decode_gop(frames)
        crop = VmemBatchDecoder(W, H, MF, device="cpu",
                                crop=True).decode_gop(frames)
        assert crop.shape == (3, 1, H + H // 2, W)
        np.testing.assert_array_equal(crop[:, :, :H], full[:, :, :H, :W])
        np.testing.assert_array_equal(crop[:, :, H:, :W // 2],
                                      full[:, :, H:, :W // 2])
        np.testing.assert_array_equal(
            crop[:, :, H:, W // 2:],
            full[:, :, H:, stride // 2:stride // 2 + W // 2])
