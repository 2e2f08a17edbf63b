"""The wavefront engine's GOP kernel code (csrc/wavefront_ops.cuh, K6's
phases, built for the host with g++ as csrc/wavefront_host.cpp: streams,
rounds and the cluster's blocks taken in turn) against the JAX package's
``decode_gop_jit`` (a ``lax.scan`` of frame rounds with the ring as carry)
on the CPU, and against the port's plain versions ``decode_gop_plain`` and
``decode_frame_core_plain``: GOPs of more than 6 rounds (the ring's head
wraps), every cluster size, a level of mixed sizes with padding rows
between its ops, and MC references outside 1..5 under a rotated head.
Exact equality throughout.  The kernel itself runs on the card only
(tests/test_torch_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobiclipdecoder_tpu.models import pipeline as jp
from mobiclipdecoder_tpu.parallel import batch as jb

from mobiclipdecoder_tpu_torch.models import pipeline as pp
from mobiclipdecoder_tpu_torch.models.oracle_video import MobiclipVersion
from mobiclipdecoder_tpu_torch.ops import wavefront_kernels as wk
from mobiclipdecoder_tpu_torch.ops.intra_tables import DC as DC_KIND, KIND
from mobiclipdecoder_tpu_torch.parallel.batch import BatchVideoDecoder
from mobiclipdecoder_tpu_torch.testing.synth import StreamSynthesizer

DS, MF = MobiclipVersion.MODS_DS, MobiclipVersion.MOFLEX_3DS
W, H = 64, 48
HH = H + H // 2
NB, NF = 3, 8                  # 8 rounds: the head comes round past slot 0
KEYS = ("mc", "resid", "resid_coef", "iops", "icoef", "seqmap")


def _gop(version, seed):
    """(host rounds of NB synthesized streams x NF frames as
    BatchVideoDecoder.scan_packets() gives them, stride, a random ring)."""
    synths = [StreamSynthesizer(W, H, version, seed=seed + b)
              for b in range(NB)]
    bd = BatchVideoDecoder(W, H, version, batch=NB, device="cpu",
                           native=False)
    rounds = [bd.scan_packets([s.iframe(0x18) if f == 0 else s.pframe()
                               for s in synths]) for f in range(NF)]
    ring = np.random.default_rng(seed).integers(
        0, 256, (NB, 6, HH, bd.stride)).astype(np.int32)
    return rounds, bd.stride, ring


def _jax_gop(rounds, ring, S):
    """decode_gop_jit on the rounds padded to the GOP's shapes (the JAX
    package's BatchVideoDecoder.decode_gop): (logical ring, frames int32)."""
    stacked = {}
    for k in KEYS + ("n_levels",):
        arrs = [np.asarray(r[k]) for r in rounds]
        tgt = tuple(max(a.shape[d] for a in arrs) for d in range(arrs[0].ndim))
        stacked[k] = np.stack([jb._pad_to(a, tgt) for a in arrs])
    jring, bufs = jb.decode_gop_jit(
        jnp.asarray(ring), *(stacked[k] for k in KEYS), stacked["n_levels"],
        H, S)
    return np.asarray(jring), np.asarray(bufs)


@pytest.fixture(scope="module", params=[DS, MF], ids=["ds", "moflex"])
def gop(request):
    rounds, S, ring = _gop(request.param, 70)
    return rounds, S, ring, _jax_gop(rounds, ring, S)


def _logical(ring, head):
    return np.roll(ring, -head, axis=1)


def test_host_gop_kernel_matches_jax_decode_gop(gop):
    """The GOP (an I-frame and 7 P-frames of 3 streams, a random ring at
    head 0) in one host run of K6's code: every frame, as uint8 and int32,
    and the final ring (physical slots read in logical order) equal
    decode_gop_jit's."""
    rounds, S, ring, (jring, jbufs) = gop
    o8, o32, ring1 = wk.wavefront_gop_host(ring, 0, rounds, H, S)
    np.testing.assert_array_equal(o32, jbufs)
    np.testing.assert_array_equal(o8, jbufs.astype(np.uint8))
    np.testing.assert_array_equal(_logical(ring1, (5 * NF) % 6), jring)
    assert rounds[-1]["mc"][..., 2].max() > 0
    assert len({tuple(r["iops"].shape[1:3]) for r in rounds}) > 1


@pytest.mark.parametrize("clusters", [1, 2, 8])
def test_host_gop_kernel_cluster_sizes_agree(gop, clusters):
    """Clusters of 1, 2 and 8 blocks (each phase's share of the leaves,
    blocks, level items and pixels split among them) give the frames and
    the ring of decode_gop_jit, from a head other than 0."""
    rounds, S, ring, (jring, jbufs) = gop
    head = 3
    o8, o32, ring1 = wk.wavefront_gop_host(np.roll(ring, head, axis=1), head,
                                           rounds, H, S, clusters=clusters)
    np.testing.assert_array_equal(o32, jbufs)
    np.testing.assert_array_equal(_logical(ring1, (head + 5 * NF) % 6),
                                  jring)


def test_plain_gop_and_batch_decoder_match_the_host_kernel():
    """decode_gop_plain (the CPU path of decode_gop) and
    BatchVideoDecoder.decode_gop on the CPU equal the host build: frames,
    the ring in physical slots, and the logical ring the decoder shows."""
    rounds, S, ring = _gop(DS, 80)
    o8, _, ring1 = wk.wavefront_gop_host(ring, 4, rounds, H, S)
    r = torch.from_numpy(ring.copy())
    plans = wk.upload_gop(rounds, "cpu")
    np.testing.assert_array_equal(
        pp.decode_gop(r, 4, plans, H, S).numpy(), o8)
    np.testing.assert_array_equal(r.numpy(), ring1)
    synths = [StreamSynthesizer(W, H, DS, seed=80 + b) for b in range(NB)]
    frames = [[s.iframe(0x18) if f == 0 else s.pframe() for s in synths]
              for f in range(NF)]
    bd = BatchVideoDecoder(W, H, DS, batch=NB, device="cpu", native=False)
    got = bd.decode_gop(frames)
    zero = np.zeros_like(ring)
    z8, _, zring = wk.wavefront_gop_host(zero, 0, rounds, H, S)
    np.testing.assert_array_equal(got, z8)
    assert bd.head == (5 * NF) % 6
    np.testing.assert_array_equal(bd.ring.numpy(), _logical(zring, bd.head))


def _mixed_level(S, seed, sizes):
    """One stream's plan arrays: MC copies ref 1 over the picture, level 0
    holds 80 slots (more than a chunk of MOBI_WF_KC ops) of ``sizes`` in
    turn (0 a padding row), each op of mode 3 (DC with neither neighbour,
    0x80, in its top-left 8x8, the rest passing the current pixels) in its
    own 16x16 cell; level 1 mixes modes and residuals over the same
    cells."""
    rng = np.random.default_rng(seed)
    mc = np.array([(y, x, 16, 16, 1, 0, 0) for y in range(0, H, 16)
                   for x in range(0, W, 16)], np.int32)
    L, K = 2, 80
    iops = np.zeros((L, K, 11), np.int32)
    cells = [(16 * i, 16 * j) for i in range(4) for j in range(S // 16)]
    live = 0
    for k in range(K):
        size = sizes[k % len(sizes)]
        if size == 0:
            continue
        row, x = cells[live]
        live += 1
        pid, y = (0, row) if row < H else (1, row - H)
        iops[0, k] = (pid, y, x, size, 3, 0, 0, 0, 0, 1, 9)
        mode = int(rng.choice([0, 1, 3, 4, 5, 8, 9, 12 if size == 4 else 2]))
        iops[1, k] = (pid, y, x, size, mode, int(rng.integers(-60, 60)),
                      int(rng.integers(0, 2)), 1, 1, 2, 9)
    icoef = rng.integers(-300, 300, (L, K, 64)).astype(np.int32)
    seqmap = np.zeros((HH // 4, S // 4), np.int32)
    return dict(mc=mc, resid=np.zeros((1, 4), np.int32),
                resid_coef=np.zeros((1, 64), np.int32), iops=iops,
                icoef=icoef, seqmap=seqmap, n_levels=np.int32(L)), iops


@pytest.mark.parametrize("seed,S,sizes", [
    (0, 256, (4, 8, 16, 0)), (1, 256, (4, 8, 16, 0)), (2, 512, (16,))],
    ids=["mixed-0", "mixed-1", "spill"])
def test_host_kernel_level_of_mixed_sizes_and_pads(seed, S, sizes):
    """A level of 4x4, 8x8 and 16x16 ops with size-0 rows between them,
    over two chunks (and a level of 80 16x16 ops, more pixels than K6
    stages in shared memory: the rest go through the overflow).  Through
    the dense pixel map each op writes exactly its own n x n block (level 0
    alone: 0x80 where mode 3's table says DC) and nothing else; with level
    1 the frame equals the JAX engine's and the plain version's."""
    a, iops = _mixed_level(S, seed, sizes)
    ring = np.random.default_rng(seed).integers(0, 256, (6, HH, S)).astype(
        np.int32)
    got1 = wk.wavefront_frame_host(ring[None], *(a[k][None] for k in KEYS),
                                   np.int32([1]), H, S)[0]
    want1 = pp.decode_frame_core_plain(
        torch.from_numpy(ring[None]), *(torch.from_numpy(a[k][None])
                                        for k in KEYS), 0, H, S)[0].numpy()
    dc = (KIND[3].reshape(16, 16) == DC_KIND)
    for op in iops[0]:
        pid, y, x, size = op[:4]
        if size > 0:
            blk = want1[y + pid * H:y + pid * H + size, x:x + size]
            blk[dc[:size, :size]] = 0x80      # the rest passes MC's pixels
    np.testing.assert_array_equal(got1, want1)
    got = wk.wavefront_frame_host(ring[None], *(a[k][None] for k in KEYS),
                                  np.int32([2]), H, S)[0]
    plain = pp.decode_frame_core_plain(
        torch.from_numpy(ring[None]), *(torch.from_numpy(a[k][None])
                                        for k in KEYS), 2, H, S)[0]
    np.testing.assert_array_equal(got, plain.numpy())
    ref = np.asarray(jp._decode_frame_jit(
        jnp.asarray(ring), *(jnp.asarray(a[k]) for k in KEYS), a["n_levels"],
        H, S))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("head", [1, 4])
def test_host_kernel_mc_refs_outside_the_plans_range(head):
    """MC leaves with refs 0 (the stale slot), 6, 7, 40 and -1, -3 (past
    the ring's ends: the logical flat index clips to its first or last
    sample), half-pel MVs reaching past the frame's edges, under a head
    that rotates the physical slots: the frame and the ring equal
    decode_frame_core_plain's on the ring in logical order."""
    S = 256
    rng = np.random.default_rng(head)
    mc = np.array([
        # y, x, w, h, ref, dx, dy
        (0, 0, 16, 16, 0, 3, 5), (0, 16, 16, 16, 6, -7, 1),
        (0, 32, 8, 16, 7, 1, -9), (16, 0, 16, 8, -1, 2, 2),
        (16, 16, 16, 16, -3, 9, 3), (16, 32, 16, 16, 40, 0, 0),
        (32, 48, 16, 16, 5, 41, 37), (32, 0, 16, 16, 2, -45, -33),
        (H - 16, S - 16, 16, 16, 3, 7, 7)], np.int32)
    rounds = [dict(mc=mc[None], resid=np.zeros((1, 1, 4), np.int32),
                   resid_coef=np.zeros((1, 1, 64), np.int32),
                   iops=np.zeros((1, 1, 1, 11), np.int32),
                   icoef=np.zeros((1, 1, 1, 64), np.int32),
                   seqmap=np.zeros((1, HH // 4, S // 4), np.int32),
                   n_levels=np.int32([1]))]
    ring = rng.integers(0, 256, (1, 6, HH, S)).astype(np.int32)
    _, o32, ring1 = wk.wavefront_gop_host(ring, head, rounds, H, S)
    hd = (head + 5) % 6
    r = rounds[0]
    want = pp.decode_frame_core_plain(
        torch.from_numpy(_logical(ring, hd)),
        *(torch.from_numpy(r[k]) for k in KEYS), 1, H, S).numpy()
    np.testing.assert_array_equal(o32[0], want)
    expect = ring.copy()
    expect[:, hd] = want
    np.testing.assert_array_equal(ring1, expect)
    assert (want[0, :16, :16] != 0).any()
    assert (want[0, 16:24, 16:32] != 0).any()


def test_upload_gop_lays_out_one_blob_with_its_descriptors():
    """upload_gop: one tensor holds the descriptor table (addresses of the
    rounds' views, then M, N, L, K, SR) and every round's arrays, each
    view equal to its host array."""
    rounds, S, _ = _gop(DS, 90)
    plans = wk.upload_gop(rounds[:3], "cpu")
    assert plans.F == 3 and plans.desc.shape == (3, wk.DESC)
    base = plans.rounds[0]["mc"]
    for f, t in enumerate(plans.rounds):
        for i, k in enumerate(wk.KEYS):
            assert t[k].untyped_storage().data_ptr() == \
                base.untyped_storage().data_ptr()
            assert plans.desc[f, i] == t[k].data_ptr()
            np.testing.assert_array_equal(t[k].numpy(), rounds[f][k])
        B, M = t["mc"].shape[:2]
        assert tuple(plans.desc[f, 7:]) == (
            M, t["resid"].shape[1], *t["iops"].shape[1:3],
            t["seqmap"].shape[1])
    with pytest.raises(ValueError, match="expected ring"):
        wk.wavefront_gop_host(np.zeros((NB, 6, HH, S + 4), np.int32), 0,
                              rounds[:1], H, S + 4)
