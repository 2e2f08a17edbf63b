"""The port's whole-GOP executor vs the JAX package's Pallas executor.

Every comparison is exact equality (an integer codec).  The JAX side runs
``_decode_gop_fused`` in Pallas interpret mode on the CPU, as the JAX
package's own tests do; all calls share one shape (B=2, F=4, 16 chunks)
so the interpret-mode build happens once per process.  The CUDA kernel
runs only on a GPU; its arithmetic is checked here through the host (g++)
build of csrc/exec_ops.cuh.
"""
import contextlib
import shutil
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mobiclipdecoder_tpu.models.oracle_video import MobiclipVersion
from mobiclipdecoder_tpu.models.plan import PlanningDecoder, pack_unified
from mobiclipdecoder_tpu.ops import vmem_engine as jve
from mobiclipdecoder_tpu.testing.synth import StreamSynthesizer

from mobiclipdecoder_tpu_torch import state
from mobiclipdecoder_tpu_torch.ops import executor, packing
from mobiclipdecoder_tpu_torch.ops.prologue import (crop_frames,
                                                    renormalize_ring)
from mobiclipdecoder_tpu_torch.ops.residuals import _residuals

sys.path.insert(0, str(Path(__file__).parent))
from torch_gops import EDGE, edge_plans  # noqa: E402

W, H, S = 64, 48, 256
B, F = 2, 4


def _synth_plans(version, seeds, nframes=F, start=0, size=(W, H)):
    """Unified plans of synthesized streams: plans[f][b]."""
    synths = [StreamSynthesizer(*size, version, seed=s) for s in seeds]
    planners = [PlanningDecoder(*size, version) for _ in seeds]
    plans = []
    for f in range(start + nframes):
        row = []
        for syn, p in zip(synths, planners):
            p.data = syn.iframe(0x18) if f == 0 else syn.pframe()
            p.offset = 0
            p.decode_frame()
            row.append(p.unified_plan())
        if f >= start:
            plans.append(row)
    return plans


def _coef(rng, n):
    c = np.zeros((n, n), np.int32)
    k = rng.integers(1, 6)
    c.flat[rng.choice(n * n, k, replace=False)] = rng.integers(-90, 90, k)
    return c


# op families of the hand-built GOPs: (luma kinds for frame 0, luma kinds
# for later frames, chroma kinds) of _hand_frame
FAMILIES = {
    "all": ((0, 1, 2, 3, 4, 5), tuple(range(10)), (0, 1, 2)),
    "lifecycle": ((0,), (6,), ()),
    "resid": ((5, 9), (5, 9), (2,)),
    "intra_single": ((0, 4), (0, 4), (1,)),
    "quad": ((1, 2, 3), (1, 2, 3), ()),
    "chroma_pair": ((0,), (0,), (0,)),
    "mc": ((6, 7, 8), (6, 7, 8), ()),
}


def _hand_frame(rng, f, family="all"):
    """A decode-order op list covering every op family pack_unified
    emits: plane 2/12/plane16 (with gradients that push the closed form
    out of 0..255), single and quad-batched directional/DC intra, chroma
    U+V intra pairs, plain / masked 16x16 / U+V residuals, and (f > 0)
    MC with fused and split-leaf residuals and MVs pointing off the
    frame."""
    ops = []
    half = S // 2
    for my in range(0, H, 16):
        for mx in range(0, W, 16):
            k0, kp, cks = FAMILIES[family]
            kind = int(rng.choice(k0 if f == 0 else kp))
            if kind == 0:                       # plane16
                ops.append(("intra", 0, my, mx, 16, 2,
                            int(rng.integers(-120, 120)), None))
            elif kind in (1, 2):                # 8x8 intra (quad batch)
                for q in range(4):
                    if rng.random() < 0.2:
                        continue                # absent slot
                    mode = int(rng.choice([0, 1, 3, 4, 5, 6, 7, 8]))
                    cf = (_coef(rng, 8), 0) if rng.random() < 0.5 else None
                    ops.append(("intra", 0, my + 8 * (q >> 1),
                                mx + 8 * (q & 1), 8, mode, 0, cf))
            elif kind == 3:                     # 4x4 intra inside 8x8s
                for q8 in range(4):
                    by, bx = my + 8 * (q8 >> 1), mx + 8 * (q8 & 1)
                    for q in range(4):
                        mode = int(rng.choice([10, 11, 12, 13, 14, 15, 16,
                                               17, 18]))
                        cf = (_coef(rng, 4), 0) if rng.random() < 0.5 \
                            else None
                        grad = int(rng.integers(-90, 90)) if mode == 12 else 0
                        ops.append(("intra", 0, by + 4 * (q >> 1),
                                    bx + 4 * (q & 1), 4, mode, grad, cf))
            elif kind == 4:                     # 8x8 plane mode 2 + lone 8x8
                ops.append(("intra", 0, my, mx, 8, 2,
                            int(rng.integers(-80, 80)), (_coef(rng, 8), 0)))
                ops.append(("intra", 0, my + 8, mx + 8, 8, 3, 0, None))
                ops.append(("resid", 0, my + 8, mx, 8, (_coef(rng, 8), 0)))
            elif kind == 5:                     # masked 16x16 residual
                for q in (0, 1, 3):
                    ops.append(("resid", 0, my + 8 * (q >> 1),
                                mx + 8 * (q & 1), 8, (_coef(rng, 8), 0)))
                ops.append(("resid", 0, my + 4, mx + 12, 4,
                            (_coef(rng, 4), 0)))
            elif kind == 6:                     # 16x16 MC + fused residuals
                dx, dy = (int(v) for v in rng.integers(-40, 40, 2))
                if rng.random() < 0.3:          # far off the frame
                    dx, dy = -2 * (mx + 40) - 1, 2 * (H - my + 30) + 1
                ops.append(("mc", 16, 16, int(rng.integers(1, 6)), dx, dy,
                            my * S + mx))
                for q in range(4):
                    if rng.random() < 0.6:
                        ops.append(("resid", 0, my + 8 * (q >> 1),
                                    mx + 8 * (q & 1), 8, (_coef(rng, 8), 0)))
                cy, cx = my // 2, mx // 2
                if rng.random() < 0.6:
                    ops.append(("resid", 1, cy, cx, 8, (_coef(rng, 8), 0)))
                ops.append(("resid", 1, cy, cx + half, 8, (_coef(rng, 8), 0)))
            elif kind == 7:                     # split leaves + residuals
                lw, lh = [(8, 8), (16, 8), (8, 16)][rng.integers(0, 3)]
                for ly in range(0, 16, lh):
                    for lx in range(0, 16, lw):
                        dx, dy = (int(v) for v in rng.integers(-70, 70, 2))
                        ops.append(("mc", lw, lh, int(rng.integers(1, 4)),
                                    dx, dy, (my + ly) * S + mx + lx))
                for q in range(4):
                    if rng.random() < 0.7:
                        ops.append(("resid", 0, my + 8 * (q >> 1),
                                    mx + 8 * (q & 1), 8, (_coef(rng, 8), 0)))
            elif kind == 9:                     # plain 8x8 / 4x4 residuals
                ops.append(("resid", 0, my + 8, mx, 8, (_coef(rng, 8), 0)))
                ops.append(("resid", 0, my, mx + 4, 4, (_coef(rng, 4), 0)))
            else:                               # small leaves, half-pel
                for ly in range(0, 16, 4):
                    for lx in range(0, 16, 8):
                        dx, dy = (int(v) for v in rng.integers(-9, 9, 2))
                        ops.append(("mc", 8, 4, 1, dx, dy,
                                    (my + ly) * S + mx + lx))
            # chroma of the MB: U+V intra pair, plane-mode singles, or a
            # U+V residual pair
            cy, cx = my // 2, mx // 2
            ck = int(rng.choice(cks)) if cks else -1
            if ck == 0:
                mode = int(rng.choice([0, 1, 3, 4, 5, 6, 7, 8]))
                for x in (cx, cx + half):
                    cf = (_coef(rng, 8), 0) if rng.random() < 0.5 else None
                    ops.append(("intra", 1, cy, x, 8, mode, 0, cf))
            elif ck == 1:
                for x in (cx, cx + half):
                    ops.append(("intra", 1, cy, x, 8, 2,
                                int(rng.integers(-60, 60)), None))
            elif ck == 2:
                for x in (cx, cx + half):
                    ops.append(("resid", 1, cy, x, 8, (_coef(rng, 8), 0)))
    return pack_unified(ops, S, H)


def _hand_plans(seed, family="all"):
    rngs = [np.random.default_rng(seed * 10 + b) for b in range(B)]
    return [[_hand_frame(rngs[b], f, family) for b in range(B)]
            for f in range(F)]


def _packed(plans):
    ops, coefs, sizes = packing._pack_gop_chunks(plans, B)
    assert ops.shape[1] == 16          # one interpret-mode build per process
    return ops, coefs, sizes


def _jax_gop(ring_np, ops, coefs, sizes):
    ring, yuv = jve._decode_gop_fused(
        jnp.asarray(ring_np), jnp.asarray(ops), jnp.asarray(coefs),
        jnp.asarray(sizes), F, H, S, True)
    return np.asarray(ring), np.asarray(yuv)


def _resid(coefs, sizes):
    return _residuals(torch.from_numpy(coefs).view(-1, 64),
                      torch.from_numpy(sizes).view(-1)).view(B, -1, 256, 64)


def _port_gop(ring, ops, coefs, sizes):
    """Plain executor through the wrapper (CPU tensors)."""
    frames = executor.run_gop(torch.from_numpy(ops), _resid(coefs, sizes),
                              ring, F, H, S)
    ring = renormalize_ring(ring, F)
    return state.ring_to_jax(ring, H, S), crop_frames(frames, H, S).numpy()


def _zero_ring_jax():
    _hh, G8, SP = packing._geom(H, S)
    return np.zeros((B, 6, G8, 8, SP), np.int32)


def _zero_ring():
    return torch.zeros(state.ring_shape(B, H, S), dtype=torch.uint8)


@pytest.mark.parametrize("version", [MobiclipVersion.MODS_DS,
                                     MobiclipVersion.MOFLEX_3DS])
def test_executor_ref_matches_jax_interpret_synth(version):
    ops, coefs, sizes = _packed(_synth_plans(version, (3, 4)))
    jring, jyuv = _jax_gop(_zero_ring_jax(), ops, coefs, sizes)
    before = executor.launches
    pring, pyuv = _port_gop(_zero_ring(), ops, coefs, sizes)
    assert executor.launches == before      # CPU tensors: no kernel launch
    np.testing.assert_array_equal(pyuv, jyuv)
    np.testing.assert_array_equal(pring, jring)


# (type, size_log) op forms each family must emit; type 1 is MC
FORMS = {
    "all": ((1, None), (2, 3), (2, 4), (2, 5), (3, 2), (3, 3), (3, 4),
            (3, 5), (3, 6), (3, 7)),
    "lifecycle": ((1, None), (3, 4)),
    "resid": ((2, 3), (2, 4), (2, 5)),
    "intra_single": ((3, 3), (3, 4)),
    "quad": ((3, 5), (3, 6)),
    "chroma_pair": ((3, 7),),
    "mc": ((1, None),),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_executor_ref_matches_jax_interpret_hand_built(family):
    plans = _hand_plans(7, family)
    w0 = np.concatenate([p["ops"][1:1 + int(p["ops"][0, 0]), 0]
                         for row in plans for p in row])
    typ, sl = w0 & 3, (w0 >> 2) & 7
    for t, s in FORMS[family]:
        assert ((typ == t) & ((sl == s) if s is not None else True)).any(), \
            (family, t, s)
    if family == "mc":          # split leaves carry attached residual rows
        lw = (w0 >> 16) & 0x1F
        assert ((typ == 1) & (lw < 16) & (((w0 >> 3) & 0xF) != 0)).any()
    ops, coefs, sizes = _packed(plans)
    ring_np = np.random.default_rng(1).integers(
        0, 256, _zero_ring_jax().shape).astype(np.int32)
    jring, jyuv = _jax_gop(ring_np, ops, coefs, sizes)
    pring, pyuv = _port_gop(state.ring_from_jax(ring_np, H, S), ops, coefs,
                            sizes)
    np.testing.assert_array_equal(pyuv, jyuv)
    np.testing.assert_array_equal(pring, jring)


def test_gop_continues_from_ring_carried_over_from_jax():
    """GOP 1 decoded by the JAX engine; GOP 2 decoded by the port from
    ring_from_jax(ring) equals GOP 2 decoded by the JAX engine."""
    v = MobiclipVersion.MODS_DS
    plans = _synth_plans(v, (8, 9), nframes=2 * F)
    g1 = _packed(plans[:F])
    g2 = _packed(plans[F:])
    ring1, _ = _jax_gop(_zero_ring_jax(), *g1)
    assert ring1.any()
    jring2, jyuv2 = _jax_gop(ring1, *g2)
    ring_t = state.ring_from_jax(ring1, H, S)
    np.testing.assert_array_equal(state.ring_to_jax(ring_t, H, S), ring1)
    pring2, pyuv2 = _port_gop(ring_t, *g2)
    np.testing.assert_array_equal(pyuv2, jyuv2)
    np.testing.assert_array_equal(pring2, jring2)


# stride 512 (3DS 400x240) and 1024 (Wii 640x480) at a height of 32
WIDE = {"synth_s512": (272, 32, 512), "synth_s1024": (528, 32, 1024)}
# the hand-built families beside "hand" (the "all" family)
HAND = {f"hand_{k}": k for k in sorted(FAMILIES) if k != "all"}


# edge GOPs narrower than their stride: the first U|V row's top taps read
# the last luma row (which the cluster form's last row must not have
# written yet), and the V block of column 0 reads no U pixel
NARROW = {"edge_narrow_s512": (400, 48, 512),
          "edge_narrow_s1024": (640, 64, 1024)}
SOURCES = ["synth_ds", "synth_moflex", "hand", *WIDE, *HAND, *EDGE]


def _source(source):
    """(ops, resid, ring, h, s) of a named test GOP, B streams, F frames."""
    h, s = H, S
    if source == "hand":
        plans = _hand_plans(11)
    elif source in HAND:
        plans = _hand_plans(11, HAND[source])
    elif source in EDGE or source in NARROW:
        w, h, s = EDGE.get(source) or NARROW[source]
        plans = edge_plans(12, w, h, s, B, F)
    elif source in WIDE:
        w, h, s = WIDE[source]
        plans = _synth_plans(MobiclipVersion.MOFLEX_3DS, (5, 6), size=(w, h))
    else:
        v = (MobiclipVersion.MODS_DS if source == "synth_ds"
             else MobiclipVersion.MOFLEX_3DS)
        plans = _synth_plans(v, (5, 6))
    ops, coefs, sizes = packing._pack_gop_chunks(plans, B)
    ring0 = np.random.default_rng(2).integers(
        0, 256, state.ring_shape(B, h, s)).astype(np.uint8)
    return ops, _resid(coefs, sizes), ring0, h, s


@pytest.mark.parametrize("source", SOURCES)
def test_host_build_of_kernel_matches_plain(source):
    """csrc/exec_ops.cuh built for the host with g++ (the kernel's own
    per-op code, thread loop on the host) equals the plain executor, at
    every stride, with the working plane in shared memory and in global
    memory: on synthesized streams, on every hand-built op family, and on
    GOPs whose ops read and write at the plane's edges (tests/
    torch_gops.py)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    ops, resid, ring0, h, s = _source(source)
    ring_t = torch.from_numpy(ring0.copy())
    frames = executor.run_gop(torch.from_numpy(ops), resid, ring_t, F, h, s)
    for smem_plane in (True, False):
        ring_h = ring0.copy()
        frames_h = executor.run_gop_host(ops, resid.numpy(), ring_h, F, h, s,
                                         smem_plane=smem_plane)
        np.testing.assert_array_equal(frames_h, frames.numpy(),
                                      err_msg=f"smem_plane={smem_plane}")
        np.testing.assert_array_equal(ring_h, ring_t.numpy(),
                                      err_msg=f"smem_plane={smem_plane}")


@pytest.mark.parametrize("C", [2, 4, 8])
@pytest.mark.parametrize("source", [*SOURCES, *NARROW])
def test_host_build_of_cluster_form_matches(source, C):
    """The cluster form (C blocks a stream, each with its own macroblock
    rows of the plane, csrc/exec_ops.cuh mobi_run_cluster built for the
    host) equals the one-block host form and the plain executor, frames
    and ring, with the blocks run in three legal orders that differ from
    the decode order: by level c + 2m with rows descending and ascending
    within a level, and the lowest row whose waits hold first."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    ops, resid, ring0, h, s = _source(source)
    ring_t = torch.from_numpy(ring0.copy())
    frames = executor.run_gop(torch.from_numpy(ops), resid, ring_t, F, h, s)
    ring_1 = ring0.copy()
    frames_1 = executor.run_gop_host(ops, resid.numpy(), ring_1, F, h, s)
    np.testing.assert_array_equal(frames_1, frames.numpy())
    for order in (0, 1, 2):
        ring_c = ring0.copy()
        frames_c = executor.run_gop_host(ops, resid.numpy(), ring_c, F, h, s,
                                         cluster=C, order=order)
        np.testing.assert_array_equal(frames_c, frames_1,
                                      err_msg=f"order {order}")
        np.testing.assert_array_equal(ring_c, ring_1,
                                      err_msg=f"order {order}")


@pytest.mark.parametrize("version", [MobiclipVersion.MODS_DS,
                                     MobiclipVersion.MOFLEX_3DS])
def test_scanner_ops_come_by_macroblock_row(version):
    """What the cluster form relies on, on the native scanner's output for
    synthesized I- and P-frames at the codec's three geometries: in each
    frame the ops of a macroblock row are contiguous and the rows come in
    order (K1 finds where each row starts from the op rows alone), every
    op's block lies inside the rows of the macroblock row it is counted in
    (luma rows (row - MR) >> 4, U|V rows (row - MR - H) >> 3), and a row's
    macroblock columns never decrease."""
    from mobiclipdecoder_tpu_torch.utils.native import NativePlanner
    MR, MCOL = packing.MR, packing.MCOL
    for (w, h), (s, _m) in GEOMETRIES.items():
        syn = StreamSynthesizer(w, h, version, seed=17)
        pkts = [syn.iframe(0x18) if f == 0 else syn.pframe()
                for f in range(3)]
        r = NativePlanner(w, h, int(version)).scan_gop_packed(pkts)
        assert r["done"] == len(pkts) and not r["err"]
        ops, _c, _s = packing._part_dense_arrays([packing._gop_part(r)])
        chunks = ops[0]
        frame = chunks[:, 0, 1]
        for f in range(len(pkts)):
            rows = np.concatenate([ck[1:1 + ck[0, 0]]
                                   for ck in chunks[frame == f]])
            w0, w1 = (rows[:, k].astype(np.int64) for k in range(2))
            typ, sl = w0 & 3, (w0 >> 2) & 7
            rr, cc = w1 & 0xFFFF, w1 >> 16
            luma = rr < MR + h
            mb = np.where(luma, (rr - MR) >> 4, (rr - MR - h) >> 3)
            col = np.where(luma, (cc - MCOL) >> 4,
                           ((cc - MCOL) & (s // 2 - 1)) >> 3)
            assert (np.diff(mb) >= 0).all() and set(mb) == set(
                range(h // 16)), (w, h, f)
            for m in range(h // 16):
                c = col[mb == m]
                assert (np.diff(c) >= 0).all(), (w, h, f, m)
            # rows each op writes: MC luma and U|V, residual and intra blocks
            bh = np.where(typ == 1, (w0 >> 21) & 0x1F, np.where(
                (typ == 2) & (sl < 4), 1 << np.minimum(sl, 3), np.where(
                    (typ == 2) & (sl == 4), 16, np.where(
                        typ == 2, 8, np.where(sl <= 4, 1 << np.minimum(
                            sl, 4), np.where(sl == 6, 16, 8))))))
            top = np.where(luma, MR + 16 * mb, MR + h + 8 * mb)
            assert (rr >= top).all()
            assert (rr + bh <= top + np.where(luma, 16, 8)).all(), (w, h, f)
            mc = typ == 1
            cy = MR + h + ((rr[mc] - MR) >> 1)
            assert (cy >= MR + h + 8 * mb[mc]).all()
            assert (cy + (bh[mc] >> 1) <= MR + h + 8 * mb[mc] + 8).all()


# (width, height) -> (stride, plane in shared memory): the codec's three
# geometries
GEOMETRIES = {(256, 192): (256, True), (400, 240): (512, True),
              (640, 480): (1024, False)}


def test_plane_form_by_geometry():
    """The wrapper keeps the working plane in shared memory at 256x192 and
    400x240 and in global memory at 640x480, and a block's shared memory
    stays within the H100's 232,448 bytes at each geometry."""
    for (w, h), (s, in_smem) in GEOMETRIES.items():
        assert executor.plane_in_smem(h, s) is in_smem, (w, h)
        assert executor.smem_bytes(h, s, in_smem) <= executor.SMEM_MAX
        assert executor.smem_bytes(h, s, True) == (
            executor.STAGE_BYTES + (h + h // 2) * (s + 16))
    assert executor.smem_bytes(192, 256, True) == 107_776
    assert executor.smem_bytes(240, 512, True) == 219_520
    assert executor.smem_bytes(480, 1024, False) == 29_440
    assert executor.smem_bytes(480, 1024, True) > executor.SMEM_MAX


def test_kernel_source_counts_the_same_shared_memory():
    """The wrapper's count of a block's shared memory is the kernel
    source's own (mobi_smem_bytes, through the host build), in both forms
    (mobi_cl_smem_bytes for the cluster form)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    for h, s in [(h, s) for (_w, h), (s, _m) in GEOMETRIES.items()] + [
            (H, S), (32, 512), (32, 1024)]:
        for smem_plane in (True, False):
            assert executor.host_smem_bytes(h, s, smem_plane) == \
                executor.smem_bytes(h, s, smem_plane), (h, s, smem_plane)
        for C in (2, 4, 8, 16):
            assert executor.host_cluster_smem_bytes(h, s, C) == \
                executor.cluster_smem_bytes(h, s, C), (h, s, C)


def test_form_by_batch_and_sm_count():
    """The wrapper takes the cluster form where the card (its SMs, as
    ``cudaOccupancyMaxActiveClusters`` counts them) runs every stream's
    cluster at once, and the one-block form otherwise: clusters of
    CLUSTER_WIDE where all B of them run at once, else of CLUSTER.  A
    cluster block's shared memory stays within the H100's 232,448 bytes at
    each geometry.  On the CPU the plain executor runs whatever the form."""
    C, CW = executor.CLUSTER, executor.CLUSTER_WIDE
    for (_w, h), (s, _m) in GEOMETRIES.items():
        assert executor.cluster_smem_bytes(h, s, C) <= executor.SMEM_MAX
        assert executor.cluster_smem_bytes(h, s, CW) <= executor.SMEM_MAX
        # an H100 with one cluster a GPC: 7 clusters of 16, 15 of 8
        card = {CW: 7, C: 15}
        assert executor.cluster_form(1, h, s, card) == CW
        assert executor.cluster_form(7, h, s, card) == CW
        assert executor.cluster_form(8, h, s, card) == C
        assert executor.cluster_form(15, h, s, card) == C
        assert executor.cluster_form(16, h, s, card) == 0
        assert executor.cluster_form(16, h, s, {CW: 16, C: 8}) == CW
        assert executor.cluster_form(1, h, s, {CW: 0, C: 1}) == C
        assert executor.cluster_form(1, h, s, {CW: 0, C: 0}) == 0
        assert executor.cluster_form(1, h, s, {}) == 0
    assert executor.cluster_smem_bytes(480, 1024, 8) == (
        executor.STAGE_BYTES + executor.CL_STATE_BYTES + 4 * 26 * 1040)
    assert executor.cluster_smem_bytes(192, 256, 8) == (
        29_440 + 288 + 2 * 26 * 272)
    # rows the form does not serve
    assert executor.cluster_form(1, 16 * (executor.CL_MAXR + 1), 256,
                                 {CW: 99, C: 99}) == 0


def test_launch_takes_the_form_the_sm_count_allows(monkeypatch):
    """The launch on a (stubbed) card: B no more than the clusters it runs
    at once launches the cluster form (``cluster_launches``,
    ``cluster_size``), more streams the one-block form (the plane
    counters); a refused cluster launch raises and is not retried in the
    other form."""
    calls = []

    class Lib:
        rc = 0

        def mobi_gop_executor_cluster_launch(self, *a):
            calls.append(("cluster", a[5], a[10]))
            return self.rc

        def mobi_gop_executor_launch(self, *a):
            calls.append(("block", a[5], a[10]))
            return 0

    lib = Lib()
    C, CW = executor.CLUSTER, executor.CLUSTER_WIDE
    monkeypatch.setattr(executor, "_load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))

    def launch(nb, active):
        monkeypatch.setattr(executor, "_active_clusters",
                            lambda d, h, s: active)
        ops = torch.zeros((nb, 1, 256, 4), dtype=torch.int32)
        executor._launch(ops, ops, ops, ops, ops, 1, H, S)

    counts = (executor.cluster_launches, executor.smem_plane_launches,
              executor.frame_launches)
    launch(1, {CW: 0, C: 16})
    launch(16, {CW: 0, C: 16})
    launch(17, {CW: 0, C: 16})
    launch(2, {CW: 0, C: 1})
    assert calls == [("cluster", 1, C), ("cluster", 16, C), ("block", 17, 1),
                     ("block", 2, 1)]
    assert (executor.cluster_launches - counts[0],
            executor.smem_plane_launches - counts[1],
            executor.frame_launches - counts[2]) == (2, 2, 4)
    assert executor.cluster_size == C
    launch(2, {CW: 2, C: 16})
    launch(3, {CW: 2, C: 16})
    assert calls[-2:] == [("cluster", 2, CW), ("cluster", 3, C)]
    assert executor.cluster_size == C
    del calls[-2:]
    lib.rc = 999
    with pytest.raises(RuntimeError, match="clusters of 8 blocks"):
        launch(1, {CW: 0, C: 16})
    assert calls[-1] == ("cluster", 1, C) and len(calls) == 5


@pytest.mark.parametrize("version", [MobiclipVersion.MODS_DS,
                                     MobiclipVersion.MOFLEX_3DS])
def test_scanner_ops_write_inside_the_plane_region(version):
    """Every op the native scanner emits writes inside rows [MR, MR + HH)
    and columns [MCOL, MCOL + S) of the plane, the region the kernel keeps
    in shared memory (where it reads 0 outside), at every stride and for
    frames as wide as their stride."""
    from mobiclipdecoder_tpu_torch.utils.native import NativePlanner
    MR, MCOL = packing.MR, packing.MCOL
    for w, h in ((64, 48), (256, 48), (272, 32), (512, 32), (528, 32),
                 (1024, 32)):
        s = 256 if w <= 256 else (512 if w <= 512 else 1024)
        for seed in (3, 4):
            syn = StreamSynthesizer(w, h, version, seed=seed)
            pkts = [syn.iframe(0x18) if f == 0 else syn.pframe()
                    for f in range(4)]
            r = NativePlanner(w, h, int(version)).scan_gop_packed(pkts)
            assert r["done"] == len(pkts) and not r["err"]
            ops, _c, _s = packing._part_dense_arrays([packing._gop_part(r)])
            rows = np.concatenate([ck[1:1 + ck[0, 0]] for ck in ops[0]])
            w0, w1 = (rows[:, k].astype(np.int64) for k in range(2))
            typ, sl = w0 & 3, (w0 >> 2) & 7
            rr, cc = w1 & 0xFFFF, w1 >> 16
            # (row, col, height, width) of each written block
            blocks = []
            mc = typ == 1
            bw, bh = (w0 >> 16) & 0x1F, (w0 >> 21) & 0x1F
            blocks.append((rr[mc], cc[mc], bh[mc], bw[mc]))
            cy = MR + h + ((rr - MR) >> 1)
            ccu = MCOL + ((cc - MCOL) >> 1)
            for off in (0, s // 2):
                blocks.append((cy[mc], ccu[mc] + off, bh[mc] >> 1,
                               bw[mc] >> 1))
            res = typ == 2
            n = np.where(sl < 4, 1 << np.minimum(sl, 3), np.where(sl == 4,
                                                                  16, 8))
            blocks.append((rr[res], cc[res], n[res], n[res]))
            pair = res & (sl == 5)
            blocks.append((rr[pair], cc[pair] + s // 2, 8, 8))
            it = typ == 3
            n = np.where(sl <= 4, 1 << np.minimum(sl, 4),
                         np.where(sl == 5, 8, np.where(sl == 6, 16, 8)))
            blocks.append((rr[it], cc[it], n[it], n[it]))
            pair = it & (sl == 7)
            blocks.append((rr[pair], cc[pair] + s // 2, 8, 8))
            assert mc.any() and res.any() and it.any()
            for r0, c0, bh_, bw_ in blocks:
                assert (r0 >= MR).all() and (r0 + bh_ <= MR + h + h // 2).all()
                assert (c0 >= MCOL).all() and (c0 + bw_ <= MCOL + s).all()


def test_wrapper_checks_inputs_and_never_falls_back():
    ops = torch.zeros((B, 16, 256, 4), dtype=torch.int32)
    resid = torch.zeros((B, 16, 256, 64), dtype=torch.int32)
    ring = _zero_ring()
    with pytest.raises(ValueError):
        executor.run_gop(ops.to(torch.int64), resid, ring, F, H, S)
    with pytest.raises(ValueError):
        executor.run_gop(ops, resid[:, :8].contiguous(), ring, F, H, S)
    with pytest.raises(ValueError):
        executor.run_gop(ops, resid, ring.to(torch.int32), F, H, S)
    with pytest.raises(ValueError, match="stride 384"):
        executor.run_gop(ops, resid, ring, F, H, 384)
    # a tensor on another device never takes the plain path silently
    meta = [t.to("meta") for t in (ops, resid, ring)]
    with pytest.raises(ValueError):
        executor.run_gop(*meta, F, H, S)


def test_failed_kernel_build_raises(monkeypatch, tmp_path):
    """A kernel that cannot be built raises from the wrapper's loader; no
    path falls back to the plain executor for a CUDA tensor."""
    from mobiclipdecoder_tpu_torch.utils import build

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(executor, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        executor._load()
    monkeypatch.setattr(build, "find_nvcc", lambda: "/bin/false")
    with pytest.raises(RuntimeError, match="failed building"):
        executor._load()
    assert executor._lib is None and not list(tmp_path.rglob("*.so"))
