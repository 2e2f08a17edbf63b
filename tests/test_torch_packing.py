"""The port's copies of the JAX package's numpy packing helpers
(mobiclipdecoder_tpu_torch/ops/packing.py) equal the originals exactly."""
import numpy as np
import pytest

from mobiclipdecoder_tpu.models.oracle_video import MobiclipVersion
from mobiclipdecoder_tpu.models.plan import PlanningDecoder
from mobiclipdecoder_tpu.ops import vmem_engine as jve
from mobiclipdecoder_tpu.testing.synth import StreamSynthesizer
from mobiclipdecoder_tpu.utils.native import NativePlanner

from mobiclipdecoder_tpu_torch.ops import packing

W, H = 64, 48


def _streams(version, seeds, nframes):
    synths = [StreamSynthesizer(W, H, version, seed=s) for s in seeds]
    return [[s.iframe(0x18) if f == 0 else s.pframe() for s in synths]
            for f in range(nframes)]


def _plans(version, frames):
    planners = [PlanningDecoder(W, H, version) for _ in frames[0]]
    out = []
    for fp in frames:
        row = []
        for p, pkt in zip(planners, fp):
            p.data = pkt
            p.offset = 0
            p.decode_frame()
            row.append(p.unified_plan())
        out.append(row)
    return out


def _native_parts(version, frames):
    B = len(frames[0])
    res = [NativePlanner(W, H, int(version)).scan_gop_packed(
        [fp[b] for fp in frames]) for b in range(B)]
    return [packing._gop_part(r) for r in res], [jve._gop_part(r)
                                                 for r in res]


def _eq(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _eq(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_constants_and_geometry_match():
    for name in ("MR", "MCOL", "CHUNK", "NCT_BUCKETS", "NNZ_PS_BUCKETS"):
        assert getattr(packing, name) == getattr(jve, name), name
    for h, s in ((48, 256), (192, 256), (240, 512), (480, 1024)):
        assert packing._geom(h, s) == jve._geom(h, s)
    for n in (1, 16, 17, 1024):
        assert packing._bucket(n, packing.NCT_BUCKETS) == \
            jve._bucket(n, jve.NCT_BUCKETS)
    with pytest.raises(ValueError):
        packing._bucket(1025, packing.NCT_BUCKETS)


@pytest.mark.parametrize("version", [MobiclipVersion.MODS_DS,
                                     MobiclipVersion.MOFLEX_3DS])
def test_plan_packing_matches(version):
    frames = _streams(version, (1, 2, 3), 5)
    plans = _plans(version, frames)
    for row in plans:
        for p in row:
            rows = p["ops"][1:1 + int(p["ops"][0, 0])]
            for w0 in rows[:, 0]:
                assert packing._op_nrows(int(w0)) == jve._op_nrows(int(w0))
            assert packing._frame_chunk_spans(rows) == \
                jve._frame_chunk_spans(rows)
    got = packing._pack_gop_chunks(plans, 3)
    exp = jve._pack_gop_chunks(plans, 3)
    _eq(got, exp)
    ops, coefs, sizes = got
    nct = ops.shape[1]
    sz = sizes.reshape(3, nct * packing.CHUNK)
    _eq(packing._pack_gop_blob_sparse(ops, coefs, sz),
        jve._pack_gop_blob_sparse(ops, coefs, sz))
    big = coefs.copy()
    big[0, 0, 0, 0] = 40000
    assert packing._pack_gop_blob_sparse(ops, big, sz) is None


def test_ops3_pack_matches_and_rejects_the_same_rows():
    rng = np.random.default_rng(0)
    n = 300
    ops = np.zeros((n, 4), np.int32)
    ops[:, 0] = rng.integers(0, 1 << 26, n)
    ops[:, 1] = rng.integers(0, 1 << 12, n) | (rng.integers(0, 1 << 12, n)
                                               << 16)
    ops[:, 2] = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64)
    ops[:, 3] = rng.integers(0, 1 << 14, n)
    _eq(packing._pack_ops3(ops), jve._pack_ops3(ops))
    for col, bad in ((0, 1 << 26), (1, 4096), (3, 1 << 14), (3, -1)):
        o2 = ops.copy()
        o2[7, col] = bad
        assert packing._pack_ops3(o2) is None
        assert jve._pack_ops3(o2) is None


@pytest.mark.parametrize("version", [MobiclipVersion.MODS_DS,
                                     MobiclipVersion.MOFLEX_3DS])
def test_native_parts_assemble_split_and_dense_match(version):
    frames = _streams(version, (4, 5), 6)
    mine, theirs = _native_parts(version, frames)
    _eq(mine, theirs)
    _eq(packing._assemble_gop_parts(mine), jve._assemble_gop_parts(theirs))
    _eq(packing._part_dense_arrays(mine), jve._part_dense_arrays(theirs))
    for f0, f1 in ((0, 3), (3, 6), (2, 5)):
        sm = [packing._split_gop_part(q, f0, f1) for q in mine]
        st = [jve._split_gop_part(q, f0, f1) for q in theirs]
        _eq(sm, st)
        _eq(packing._assemble_gop_parts(sm), jve._assemble_gop_parts(st))
        _eq(packing._part_dense_arrays(sm), jve._part_dense_arrays(st))
