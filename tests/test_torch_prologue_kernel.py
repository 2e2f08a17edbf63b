"""The device prologue's kernel code (csrc/prologue_ops.cuh, built for the
host with g++ as csrc/prologue_host.cpp) against the JAX package: the row
transform against ``_residuals``, and the sparse-blob form (coefficient
scatter, size bits, op widening, row transform) against the unpack of
``_decode_gop_fused_sblob`` followed by ``_residuals``.  Exact equality
throughout.  Also the wrappers' CPU path (the plain versions) and their
input checks.  The kernels themselves run on the card only
(tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mobiclipdecoder_tpu.ops import vmem_engine as jve

from mobiclipdecoder_tpu_torch.models.oracle_video import MobiclipVersion
from mobiclipdecoder_tpu_torch.ops import packing, prologue_kernels
from mobiclipdecoder_tpu_torch.ops import vmem_engine as tve
from mobiclipdecoder_tpu_torch.ops.prologue import (blob_sections,
                                                    unpack_gop_blob,
                                                    unpack_residuals_sblob)
from mobiclipdecoder_tpu_torch.ops.residuals import _residuals, residuals
from mobiclipdecoder_tpu_torch.runtime.transcode import width_stride
from mobiclipdecoder_tpu_torch.testing.synth import StreamSynthesizer
from mobiclipdecoder_tpu_torch.utils.native import NativePlanner

CHUNK = packing.CHUNK


def _rows(seed: int, n: int = 1024):
    """Coefficient rows of both sizes: random values up to +-32768 with
    most set to zero, all-zero rows, size-4 rows with empty quadrants and
    rows of int16 extremes."""
    rng = np.random.default_rng(seed)
    flat = rng.integers(-32768, 32768, (n, 64)).astype(np.int32)
    flat[rng.random((n, 64)) < 0.6] = 0
    sizes = rng.choice([4, 8], n).astype(np.int32)
    flat[:16] = 0                                       # zero rows
    quads = flat[16:64].reshape(48, 4, 16)
    quads[rng.random((48, 4)) < 0.5] = 0                # empty quadrants
    sizes[16:64] = 4
    flat[64:96] = rng.choice([-32768, 32767], (32, 64))  # extremes
    flat[96:100] = -32768
    flat[100:104] = 32767
    return flat, sizes


def _jax_unpack(monkeypatch, blob: np.ndarray, B: int, nct: int, nnzb: int):
    """The JAX package's _decode_gop_fused_sblob up to the executor: its
    blob unpack, then _residuals of what it hands _decode_gop_fused.
    Returns (ops (B*nct*CHUNK, 4), resid (B*nct*CHUNK, 64))."""
    def stop(ring, ops, coefs, sizes, *args):
        return ops, jve._residuals(coefs.reshape(-1, 64), sizes.reshape(-1))
    monkeypatch.setattr(jve, "_decode_gop_fused", stop)
    ring = jnp.zeros((B, 1), jnp.int32)
    ops, resid = jve._decode_gop_fused_sblob.__wrapped__(
        ring, jnp.asarray(blob), 1, nct, nnzb, 48, 256, True)
    return np.asarray(ops).reshape(-1, 4), np.asarray(resid)


def _host_sblob(blob: np.ndarray, B: int, nct: int, nnzb: int):
    sections = blob_sections(torch.from_numpy(blob), B, nct, nnzb)
    return prologue_kernels.prologue_sblob_host(
        *(s.numpy() for s in sections))


def _scanned_blob(version, size, B: int, nframes: int, seed: int):
    """The upload blob _assemble_gop_parts builds from B synthesized
    streams' native GOP scans."""
    parts = []
    for b in range(B):
        synth = StreamSynthesizer(*size, version, seed=seed + b)
        pkts = [synth.iframe(0x18) if f == 0 else synth.pframe()
                for f in range(nframes)]
        r = NativePlanner(*size, int(version)).scan_gop_packed(pkts)
        assert not r["err"] and not r["val_overflow"] and r["done"] == nframes
        parts.append(packing._gop_part(r))
    return packing._assemble_gop_parts(parts)


@pytest.mark.parametrize("seed", [0, 1])
def test_host_rows_match_jax_residuals(seed):
    flat, sizes = _rows(seed)
    got = prologue_kernels.residual_rows_host(flat, sizes)
    exp = np.asarray(jve._residuals(jnp.asarray(flat), jnp.asarray(sizes)))
    np.testing.assert_array_equal(got, exp)
    assert not got[:16].any()


@pytest.mark.parametrize("version,size,B", [
    (MobiclipVersion.MODS_DS, (64, 48), 3),
    (MobiclipVersion.MOFLEX_3DS, (64, 48), 3),
    (MobiclipVersion.MOFLEX_3DS, (272, 32), 2),     # stride 512
    (MobiclipVersion.MOFLEX_3DS, (528, 32), 1),     # stride 1024
])
def test_host_sblob_matches_jax_unpack(monkeypatch, version, size, B):
    """A blob of real synthesized GOPs: the host build's ops and resid
    equal the JAX package's unpack + _residuals."""
    blob, nct, nnzb = _scanned_blob(version, size, B, 4, 11)
    assert width_stride(size[0]) in (256, 512, 1024)
    ops, resid = _host_sblob(blob, B, nct, nnzb)
    jops, jresid = _jax_unpack(monkeypatch, blob, B, nct, nnzb)
    np.testing.assert_array_equal(ops, jops)
    np.testing.assert_array_equal(resid, jresid)
    assert resid.any()


def _extreme_blob(seed: int):
    """A blob from _pack_gop_blob_sparse whose coefficients include the
    int16 extremes, with random op words and sizes; its pad indices sit
    past the nonzeros."""
    rng = np.random.default_rng(seed)
    B, nct = 2, 1
    rows = nct * CHUNK
    ops = np.zeros((B, nct, CHUNK, 4), np.int32)
    ops[..., 0] = rng.integers(0, 1 << 26, ops.shape[:3])
    ops[..., 1] = rng.integers(0, 1 << 12, ops.shape[:3]) | (
        rng.integers(0, 1 << 12, ops.shape[:3]) << 16)
    ops[..., 2] = rng.integers(-(1 << 31), 1 << 31, ops.shape[:3],
                               dtype=np.int64)
    ops[..., 3] = rng.integers(0, 1 << 14, ops.shape[:3])
    coefs = rng.integers(-32768, 32768, (B, nct, CHUNK, 64)).astype(np.int32)
    coefs[rng.random(coefs.shape) < 0.9] = 0
    coefs[0, 0, 0, :4] = (-32768, 32767, -1, 1)
    coefs[1, 0, 255, 63] = -32768
    sizes = rng.choice([4, 8], (B, rows)).astype(np.int32)
    blob, nnzb = packing._pack_gop_blob_sparse(ops, coefs, sizes)
    return blob, B, nct, nnzb, rows


def test_host_sblob_extremes_and_pads_match_jax(monkeypatch):
    blob, B, nct, nnzb, rows = _extreme_blob(5)
    _ops3, _sb, idx, _v = blob_sections(torch.from_numpy(blob), B, nct, nnzb)
    idx = idx.numpy()
    assert (idx == rows * 64).any()                     # pads
    # out-of-range indices past the pads, still ascending
    idx[0, -2:] = (rows * 64 + 1, 2 ** 31 - 1)
    ops, resid = _host_sblob(blob, B, nct, nnzb)
    jops, jresid = _jax_unpack(monkeypatch, blob, B, nct, nnzb)
    np.testing.assert_array_equal(ops, jops)
    np.testing.assert_array_equal(resid, jresid)


def test_host_sblob_drops_negative_indices_like_the_plain_version():
    """A negative index is dropped, as the plain version's spare slot
    drops it (the scanner never emits one)."""
    blob, B, nct, nnzb, rows = _extreme_blob(6)
    idx = blob_sections(torch.from_numpy(blob), B, nct, nnzb)[2].numpy()
    idx[1, -3:] = (-1, -(rows * 64), -(2 ** 31))
    idx[0, 0] = -7
    ops, resid = _host_sblob(blob, B, nct, nnzb)
    pops, coefs, sizes = unpack_gop_blob(torch.from_numpy(blob), B, nct,
                                         nnzb)
    np.testing.assert_array_equal(ops, pops.numpy().reshape(-1, 4))
    np.testing.assert_array_equal(
        resid, _residuals(coefs.reshape(-1, 64), sizes.reshape(-1)).numpy())


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """CPU tensors go to unpack_gop_blob + _residuals; no kernel launch is
    counted."""
    before = (prologue_kernels.scatter_launches,
              prologue_kernels.residual_launches)
    blob, B, nct, nnzb, _rows_ = _extreme_blob(7)
    t = torch.from_numpy(blob)
    ops, resid = unpack_residuals_sblob(t, B, nct, nnzb)
    pops, coefs, sizes = unpack_gop_blob(t, B, nct, nnzb)
    assert ops.shape == (B, nct, CHUNK, 4) and resid.shape == (B, nct,
                                                                CHUNK, 64)
    assert torch.equal(ops, pops)
    assert torch.equal(resid, _residuals(coefs.reshape(-1, 64),
                                         sizes.reshape(-1)).view(resid.shape))
    assert torch.equal(residuals(coefs.contiguous(), sizes), resid)
    flat, sz = _rows(3, 256)
    got = residuals(torch.from_numpy(flat), torch.from_numpy(sz))
    np.testing.assert_array_equal(
        got.numpy(), prologue_kernels.residual_rows_host(flat, sz))
    assert (prologue_kernels.scatter_launches,
            prologue_kernels.residual_launches) == before


def test_wrappers_refuse_what_the_kernels_do_not_take():
    blob, B, nct, nnzb, _rows_ = _extreme_blob(8)
    t = torch.from_numpy(blob)
    with pytest.raises(ValueError):
        unpack_residuals_sblob(t.long(), B, nct, nnzb)
    with pytest.raises(ValueError):
        unpack_residuals_sblob(t[:-1], B, nct, nnzb)          # too short
    with pytest.raises(ValueError):
        unpack_residuals_sblob(t, B, nct, nnzb + 1)           # odd nnzb
    with pytest.raises(ValueError):
        unpack_residuals_sblob(t.to("meta"), B, nct, nnzb)    # no kernel
    coefs = torch.zeros((4, 64), dtype=torch.int32)
    sizes = torch.full((4,), 8, dtype=torch.int32)
    with pytest.raises(ValueError):
        residuals(coefs.long(), sizes)
    with pytest.raises(ValueError):
        residuals(coefs, sizes[:3])
    with pytest.raises(ValueError):
        residuals(torch.zeros((64, 4), dtype=torch.int32).t(), sizes)
    with pytest.raises(ValueError):
        residuals(coefs.to("meta"), sizes.to("meta"))
    with pytest.raises(ValueError):
        prologue_kernels.residual_rows(coefs, sizes, coefs.clone())  # CPU


def test_decode_takes_the_prologue_wrappers(monkeypatch):
    """The whole-GOP decode reaches the executor through
    unpack_residuals_sblob (the blob path) and residuals (dense inputs),
    each row transformed once."""
    calls = {"sblob": 0, "dense": 0, "rows": 0}

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(tve, "unpack_residuals_sblob",
                        count("sblob", tve.unpack_residuals_sblob))
    monkeypatch.setattr(tve, "residuals", count("dense", tve.residuals))
    import mobiclipdecoder_tpu_torch.ops.prologue as tpro
    import mobiclipdecoder_tpu_torch.ops.residuals as tres
    monkeypatch.setattr(tpro, "_residuals", count("rows", tres._residuals))
    monkeypatch.setattr(tres, "_residuals", count("rows", tres._residuals))
    W, H, B = 64, 48, 2
    version = MobiclipVersion.MODS_DS
    synths = [StreamSynthesizer(W, H, version, seed=s) for s in (3, 4)]
    frames = [[s.iframe(0x18) if f == 0 else s.pframe() for s in synths]
              for f in range(3)]
    dec = tve.VmemBatchDecoder(W, H, version, batch=B, native=True,
                               device="cpu")
    out = dec.decode_gop(frames)
    assert out.shape == (3, B, H + H // 2, 256)
    assert calls == {"sblob": 1, "dense": 0, "rows": 1}
    ops, coefs, sizes = dec.scan_packets(frames[0])
    ring = torch.zeros_like(dec.ring)
    tve._decode_gop_fused(ring, *map(torch.from_numpy, (ops, coefs, sizes)),
                          1, H, 256)
    assert calls == {"sblob": 1, "dense": 1, "rows": 2}
