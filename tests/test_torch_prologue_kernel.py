"""The device prologue's kernel code (csrc/prologue_ops.cuh, built for the
host with g++ as csrc/prologue_host.cpp) against the JAX package: K4's row
transform against ``_residuals``, and K5's per-block code (the search of
each block's nonzeros, their placing, the size bits, the op widening and
the row transform), run block by block, against the unpack of
``_decode_gop_fused_sblob`` followed by ``_residuals``.  Exact equality
throughout.  Also the wrappers' CPU path (the plain versions) and their
input checks.  The kernels themselves run on the card only
(tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

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


def _random_ops(rng, B: int, nct: int) -> np.ndarray:
    """Random op rows that _pack_ops3 packs."""
    ops = np.zeros((B, nct, CHUNK, 4), np.int32)
    ops[..., 0] = rng.integers(0, 1 << 26, ops.shape[:3])
    ops[..., 1] = rng.integers(0, 1 << 12, ops.shape[:3]) | (
        rng.integers(0, 1 << 12, ops.shape[:3]) << 16)
    ops[..., 2] = rng.integers(-(1 << 31), 1 << 31, ops.shape[:3],
                               dtype=np.int64)
    ops[..., 3] = rng.integers(0, 1 << 14, ops.shape[:3])
    return ops


def _nonzero_int16(rng, shape) -> np.ndarray:
    v = rng.integers(-32768, 32767, shape).astype(np.int32)
    return np.where(v >= 0, v + 1, v)


def _edge_coefs(case: str, rng):
    """(coefs (B, nct, CHUNK, 64), sizes (B, nct * CHUNK)) of one edge
    case of K5's per-block search and placing."""
    if case == "no_pad":
        # stream 0 dense: 16,384 nonzeros fill nnzb exactly, so it has no
        # pad, and both its 128-row blocks hold 8,192 nonzeros each
        B, nct = 2, 1
        coefs = _nonzero_int16(rng, (B, nct, CHUNK, 64))
        coefs[1][rng.random(coefs[1].shape) < 0.95] = 0
    elif case == "empty_block_and_stream":
        # stream 0: blocks 0 and 2 full, block 1 empty between them;
        # stream 1 all zero; stream 2 sparse
        B, nct = 3, 2
        coefs = _nonzero_int16(rng, (B, nct, CHUNK, 64))
        coefs[rng.random(coefs.shape) < 0.7] = 0
        coefs[0, 0, 0:128:5] = _nonzero_int16(rng, (26, 64))
        coefs[0, 0, 128:] = 0
        coefs[1] = 0
    elif case == "dense_block":
        # one fully dense 128-row block in the middle of a sparse stream
        B, nct = 2, 2
        coefs = _nonzero_int16(rng, (B, nct, CHUNK, 64))
        coefs[rng.random(coefs.shape) < 0.97] = 0
        coefs[1, 1, :128] = _nonzero_int16(rng, (128, 64))
    elif case == "first_and_last_coefficient":
        # nonzeros at coefficient 0 of row 0 and at coefficient 63 of each
        # stream's last row
        B, nct = 3, 2
        coefs = _nonzero_int16(rng, (B, nct, CHUNK, 64))
        coefs[rng.random(coefs.shape) < 0.99] = 0
        coefs[:, 0, 0, 0] = (-32768, 32767, 5)
        coefs[:, -1, -1, 63] = (32767, -1, -32768)
    else:
        raise ValueError(case)
    sizes = rng.choice([4, 8], (B, nct * CHUNK)).astype(np.int32)
    return coefs, sizes


def _packed(coefs, sizes, rng):
    B, nct = coefs.shape[:2]
    packed = packing._pack_gop_blob_sparse(_random_ops(rng, B, nct), coefs,
                                           sizes)
    assert packed is not None
    return packed[0], B, nct, packed[1]


def _assert_host_sblob_is_jax(monkeypatch, blob, B, nct, nnzb):
    ops, resid = _host_sblob(blob, B, nct, nnzb)
    jops, jresid = _jax_unpack(monkeypatch, blob, B, nct, nnzb)
    np.testing.assert_array_equal(ops, jops)
    np.testing.assert_array_equal(resid, jresid)


@pytest.mark.parametrize("case", ["no_pad", "empty_block_and_stream",
                                  "dense_block",
                                  "first_and_last_coefficient"])
def test_host_sblob_edge_blobs_match_jax(monkeypatch, case):
    """K5's per-block code on the edges of its search and placing: a
    stream without pads, empty blocks and streams, a dense block, and the
    first and last coefficient positions of each stream."""
    rng = np.random.default_rng(["no_pad", "empty_block_and_stream",
                                 "dense_block",
                                 "first_and_last_coefficient"].index(case))
    coefs, sizes = _edge_coefs(case, rng)
    blob, B, nct, nnzb = _packed(coefs, sizes, rng)
    idx = blob_sections(torch.from_numpy(blob), B, nct, nnzb)[2].numpy()
    nnz = (coefs.reshape(B, -1) != 0).sum(axis=1)
    if case == "no_pad":
        assert nnzb == nnz[0] == nct * CHUNK * 64
        assert (idx[0] < nct * CHUNK * 64).all()
    if case == "empty_block_and_stream":
        assert nnz[1] == 0 and not coefs[0, 0, 128:].any()
    if case == "dense_block":
        assert (coefs[1, 1, :128] != 0).all()
    _assert_host_sblob_is_jax(monkeypatch, blob, B, nct, nnzb)


def _junk_after_pads(blob, B, nct, nnzb, rng, negative: bool) -> None:
    """Every pad slot of the blob (in place) -> a random index past the
    stream's positions or, with ``negative``, also below 0: out of range
    after the in-range ones, inside the JAX package's contract."""
    rows64 = nct * CHUNK * 64
    idx = blob_sections(torch.from_numpy(blob), B, nct, nnzb)[2].numpy()
    pads = idx == rows64
    junk = rng.integers(rows64, 2 ** 31, idx.shape)
    if negative:
        junk = np.where(rng.random(idx.shape) < 0.5,
                        rng.integers(-2 ** 31, 0, idx.shape), junk)
    idx[pads] = junk[pads]


def _assert_host_sblob_is_plain(blob, B, nct, nnzb):
    ops, resid = _host_sblob(blob, B, nct, nnzb)
    pops, coefs, sizes = unpack_gop_blob(torch.from_numpy(blob), B, nct,
                                         nnzb)
    np.testing.assert_array_equal(ops, pops.numpy().reshape(-1, 4))
    np.testing.assert_array_equal(
        resid, _residuals(coefs.reshape(-1, 64), sizes.reshape(-1)).numpy())


def test_host_sblob_junk_after_every_pad_like_the_plain_version():
    """Every pad slot holds a negative or too large index instead, so that
    the search's probes land on them: dropped, as the plain version drops
    them (indices compared as uint32)."""
    rng = np.random.default_rng(12)
    coefs = _nonzero_int16(rng, (3, 2, CHUNK, 64))
    coefs[rng.random(coefs.shape) < 0.98] = 0
    coefs[2] = 0
    sizes = rng.choice([4, 8], (3, 2 * CHUNK)).astype(np.int32)
    blob, B, nct, nnzb = _packed(coefs, sizes, rng)
    _junk_after_pads(blob, B, nct, nnzb, rng, negative=True)
    _assert_host_sblob_is_plain(blob, B, nct, nnzb)


@settings(max_examples=10, deadline=None, database=None, derandomize=True)
@given(B=st.integers(1, 3), nct=st.integers(1, 2),
       density=st.sampled_from([0.0, 0.01, 0.2, 0.8, 1.0]),
       junk=st.sampled_from([None, "large", "negative"]),
       seed=st.integers(0, 2 ** 32 - 1))
def test_host_sblob_random_blobs_match_jax(B, nct, density, junk, seed):
    """Small random blobs (up to 3 streams of up to 2 chunks, each stream
    at its own density up to the given one, the pads kept or replaced by
    out-of-range indices): K5's per-block code == the JAX package's
    unpack + _residuals, and == the plain version where negative indices
    (which the JAX package's scatter would wrap) replace pads."""
    rng = np.random.default_rng(seed)
    coefs = _nonzero_int16(rng, (B, nct, CHUNK, 64))
    per_stream = rng.random(B) * density
    coefs[rng.random(coefs.shape) >= per_stream[:, None, None, None]] = 0
    sizes = rng.choice([4, 8], (B, nct * CHUNK)).astype(np.int32)
    blob, B, nct, nnzb = _packed(coefs, sizes, rng)
    if junk:
        _junk_after_pads(blob, B, nct, nnzb, rng, junk == "negative")
    if junk == "negative":
        _assert_host_sblob_is_plain(blob, B, nct, nnzb)
        return
    with pytest.MonkeyPatch.context() as mp:
        _assert_host_sblob_is_jax(mp, blob, B, nct, nnzb)


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
    """CPU tensors go to unpack_gop_blob + _residuals; no kernel launch
    (K5 or K4) is counted."""
    before = (prologue_kernels.prologue_launches,
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
    assert (prologue_kernels.prologue_launches,
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
    before = prologue_kernels.prologue_launches
    ops3, sbits, idx, v32 = blob_sections(t, B, nct, nnzb)
    n = ops3.shape[0]
    ops = torch.empty((n, 4), dtype=torch.int32)
    resid = torch.empty((n, 64), dtype=torch.int32)
    with pytest.raises(ValueError):                              # CPU
        prologue_kernels.prologue_sblob(ops3, sbits, idx, v32, ops, resid)
    with pytest.raises(ValueError):
        prologue_kernels.prologue_sblob(ops3, sbits, idx, v32, ops,
                                        resid.long())
    with pytest.raises(ValueError):      # rows per stream not whole blocks
        prologue_kernels.prologue_sblob_host(ops3[:-64], sbits, idx, v32)
    assert prologue_kernels.prologue_launches == before


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
