"""The port's device prologue / epilogue and IDCT pre-pass vs the JAX
package: _unpack_ops3, the sparse blob unpack, _residuals, ring
renormalization and the width crop.  Exact equality throughout."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mobiclipdecoder_tpu.models.oracle_video import MobiclipVersion
from mobiclipdecoder_tpu.models.plan import PlanningDecoder
from mobiclipdecoder_tpu.ops import vmem_engine as jve
from mobiclipdecoder_tpu.testing.synth import StreamSynthesizer

from mobiclipdecoder_tpu_torch.ops import packing
from mobiclipdecoder_tpu_torch.ops.prologue import (_unpack_ops3,
                                                    crop_frames,
                                                    crop_gop_yuv,
                                                    renormalize_ring,
                                                    unpack_gop_blob)
from mobiclipdecoder_tpu_torch.ops.residuals import _residuals


def test_unpack_ops3_matches_jax():
    rng = np.random.default_rng(1)
    n = 700
    ops = np.zeros((n, 4), np.int32)
    ops[:, 0] = rng.integers(0, 1 << 26, n)
    ops[:, 1] = rng.integers(0, 1 << 12, n) | (rng.integers(0, 1 << 12, n)
                                               << 16)
    ops[:, 2] = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64)
    ops[:, 3] = rng.integers(0, 1 << 14, n)
    p3 = packing._pack_ops3(ops)
    got = _unpack_ops3(torch.from_numpy(p3)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jve._unpack_ops3(
        jnp.asarray(p3))))
    np.testing.assert_array_equal(got, ops)


@pytest.mark.parametrize("seed", [0, 1])
def test_residuals_match_jax(seed):
    """Random rows of sizes 4 and 8 with values up to +-32767."""
    rng = np.random.default_rng(seed)
    n = 512
    flat = rng.integers(-32767, 32768, (n, 64)).astype(np.int32)
    flat[rng.random((n, 64)) < 0.6] = 0
    flat[:8] = rng.choice([-32767, 32767], (8, 64))   # extremes
    sizes = rng.choice([4, 8], n).astype(np.int32)
    got = _residuals(torch.from_numpy(flat), torch.from_numpy(sizes))
    exp = np.asarray(jve._residuals(jnp.asarray(flat), jnp.asarray(sizes)))
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("version", [MobiclipVersion.MODS_DS,
                                     MobiclipVersion.MOFLEX_3DS])
def test_sparse_blob_unpack_restores_packed_gop(version):
    """The blob of _pack_gop_blob_sparse (the JAX package's format)
    unpacks on the device to exactly the packed (ops, coefs, sizes) that
    _decode_gop_fused_sblob hands its executor."""
    W, H, B = 64, 48, 3
    synths = [StreamSynthesizer(W, H, version, seed=s) for s in (7, 8, 9)]
    planners = [PlanningDecoder(W, H, version) for _ in range(B)]
    plans = []
    for f in range(4):
        row = []
        for s, p in zip(synths, planners):
            p.data = s.iframe(0x18) if f == 0 else s.pframe()
            p.offset = 0
            p.decode_frame()
            row.append(p.unified_plan())
        plans.append(row)
    ops, coefs, sizes = jve._pack_gop_chunks(plans, B)
    nct = ops.shape[1]
    blob, nnzb = jve._pack_gop_blob_sparse(
        ops, coefs, sizes.reshape(B, nct * packing.CHUNK))
    o, c, s = unpack_gop_blob(torch.from_numpy(blob), B, nct, nnzb)
    np.testing.assert_array_equal(o.numpy(), ops)
    np.testing.assert_array_equal(c.numpy(), coefs)
    np.testing.assert_array_equal(s.numpy(), sizes)


def test_blob_unpack_handles_int16_extremes_and_padding():
    """Little-endian int16 pairs (including -32768/32767) and padded
    indices == rows*64 (dropped)."""
    B, nct = 2, 1
    rows = nct * packing.CHUNK
    ops = np.zeros((B, nct, packing.CHUNK, 4), np.int32)
    coefs = np.zeros((B, nct, packing.CHUNK, 64), np.int32)
    coefs[0, 0, 0, :4] = (-32768, 32767, -1, 1)
    coefs[1, 0, 255, 63] = -5
    sizes = np.full((B, rows), 8, np.int32)
    sizes[0, 3] = sizes[1, 31] = sizes[1, 32] = 4
    blob, nnzb = packing._pack_gop_blob_sparse(ops, coefs, sizes)
    o, c, s = unpack_gop_blob(torch.from_numpy(blob), B, nct, nnzb)
    np.testing.assert_array_equal(c.numpy(), coefs)
    np.testing.assert_array_equal(s.numpy().reshape(B, rows), sizes)


def test_ring_renormalize_and_crops_match_jax():
    rng = np.random.default_rng(3)
    H, S, W = 48, 256, 64
    hh, G8, SP = packing._geom(H, S)
    ring = rng.integers(0, 256, (2, 6, G8 * 8, SP)).astype(np.uint8)
    for F in (1, 4, 6, 7, 24):
        got = renormalize_ring(torch.from_numpy(ring), F).numpy()
        w_last = (5 - (F - 1)) % 6
        np.testing.assert_array_equal(got, np.roll(ring, -w_last, axis=1))
    frames = rng.integers(0, 256, (3, 2, G8 * 8, SP)).astype(np.uint8)
    yuv = crop_frames(torch.from_numpy(frames), H, S)
    np.testing.assert_array_equal(
        yuv.numpy(), frames[:, :, packing.MR:packing.MR + hh,
                            packing.MCOL:packing.MCOL + S])
    got = crop_gop_yuv(yuv, H, W, S).numpy()
    exp = np.asarray(jve._crop_gop_yuv(jnp.asarray(yuv.numpy()), H, W, S))
    np.testing.assert_array_equal(got, exp)
