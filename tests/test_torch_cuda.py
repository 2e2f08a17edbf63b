"""Tests of the port that need an NVIDIA GPU: the hand-written CUDA
executor, prologue, wavefront, SAD-volume and audio kernels against their
plain PyTorch versions, and
the decoder on the card against the decoder on the CPU.  They skip where no
CUDA device is present (the kernels have no CPU mode; their per-op and
per-row code is checked on the CPU through the host builds in
test_torch_executor.py, test_torch_prologue_kernel.py,
test_torch_wavefront_kernel.py, test_torch_sad_kernel.py and
test_torch_audio_kernel.py).  This file imports no
JAX and nothing of the JAX package, so it runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -q
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mobiclipdecoder_tpu_torch import state
from mobiclipdecoder_tpu_torch.models.oracle_video import MobiclipVersion
from mobiclipdecoder_tpu_torch.models.plan import PlanningDecoder
from mobiclipdecoder_tpu_torch.testing.synth import StreamSynthesizer
from mobiclipdecoder_tpu_torch.ops import (executor, packing, prologue,
                                           prologue_kernels)
from mobiclipdecoder_tpu_torch.ops import residuals as residuals_mod
from mobiclipdecoder_tpu_torch.ops.prologue import (unpack_gop_blob,
                                                    unpack_residuals_sblob)
from mobiclipdecoder_tpu_torch.ops.residuals import _residuals, residuals
from mobiclipdecoder_tpu_torch.utils.native import NativePlanner
from mobiclipdecoder_tpu_torch.ops.vmem_engine import VmemBatchDecoder

sys.path.insert(0, str(Path(__file__).parent))
from torch_gops import EDGE, edge_plans  # noqa: E402

W, H, S = 64, 48, 256


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _frames(version, seeds, nframes):
    synths = [StreamSynthesizer(W, H, version, seed=s) for s in seeds]
    return [[s.iframe(0x18) if f == 0 else s.pframe() for s in synths]
            for f in range(nframes)]


@pytest.mark.cuda
@pytest.mark.parametrize("version", [MobiclipVersion.MODS_DS,
                                     MobiclipVersion.MOFLEX_3DS])
def test_cuda_kernel_matches_plain(cuda, version):
    frames = _frames(version, (21, 22, 23), 7)
    planners = [PlanningDecoder(W, H, version) for _ in range(3)]
    plans = []
    for fp in frames:
        row = []
        for p, pkt in zip(planners, fp):
            p.data = pkt
            p.offset = 0
            p.decode_frame()
            row.append(p.unified_plan())
        plans.append(row)
    ops, coefs, sizes = packing._pack_gop_chunks(plans, 3)
    B, nct = ops.shape[:2]
    resid = _residuals(torch.from_numpy(coefs).view(-1, 64),
                       torch.from_numpy(sizes).view(-1)).view(B, nct, 256,
                                                               64)
    ring0 = np.random.default_rng(0).integers(
        0, 256, state.ring_shape(B, H, S)).astype(np.uint8)
    ring_c = torch.from_numpy(ring0).to(cuda)
    before = executor.launches
    frames_c = executor.run_gop(torch.from_numpy(ops).to(cuda),
                                resid.to(cuda), ring_c, len(frames), H, S)
    torch.cuda.synchronize()
    assert executor.launches == before + 1
    ring_p = torch.from_numpy(ring0.copy())
    frames_p = executor.run_gop(torch.from_numpy(ops), resid, ring_p,
                                len(frames), H, S)
    np.testing.assert_array_equal(frames_c.cpu().numpy(), frames_p.numpy())
    np.testing.assert_array_equal(ring_c.cpu().numpy(), ring_p.numpy())


@pytest.mark.cuda
def test_cuda_decoder_matches_cpu_decoder(cuda):
    v = MobiclipVersion.MODS_DS
    gops = [_frames(v, (31, 32), 4), _frames(v, (33, 34), 3)]
    gpu = VmemBatchDecoder(W, H, v, batch=2, device=cuda)
    cpu = VmemBatchDecoder(W, H, v, batch=2, device="cpu")
    before = executor.launches
    got = list(gpu.decode_gops(iter(gops)))
    assert executor.launches == before + 2
    exp = list(cpu.decode_gops(iter(gops)))
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g, e)
    np.testing.assert_array_equal(gpu.ring.cpu().numpy(), cpu.ring.numpy())


def _plane_counts():
    """K1 launches by form: (one block a stream, plane in shared memory;
    one block a stream, plane in global memory; a cluster a stream)."""
    return (executor.smem_plane_launches, executor.global_plane_launches,
            executor.cluster_launches)


def _take_form(monkeypatch, form, h, s):
    """Make K1 take `form` ("cluster": the wrapper's choice for a few
    streams; "one-block": a card stubbed to run no cluster at once) and
    return the _plane_counts step of one launch in it."""
    if form == "one-block":
        monkeypatch.setattr(executor, "_active_clusters",
                            lambda d, hh, ss: {})
        return (1, 0, 0) if executor.plane_in_smem(h, s) else (0, 1, 0)
    return (0, 0, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["cluster", "one-block"])
@pytest.mark.parametrize("nframes", [1, 4])
@pytest.mark.parametrize("size", [(272, 32), (528, 32), (400, 240),
                                  (640, 480)])
def test_cuda_kernel_matches_plain_at_wide_strides(cuda, monkeypatch, size,
                                                  nframes, form):
    """Strides 512 and 1024 (and the real 400x240 and 640x480), as a GOP
    and as the single-frame launch: kernel == plain executor, frames and
    ring, in each form of K1 (two streams take the cluster form; the
    one-block form keeps the plane in shared memory except at 640x480)."""
    w, h = size
    v = MobiclipVersion.MOFLEX_3DS
    synths = [StreamSynthesizer(w, h, v, seed=s) for s in (41, 42)]
    planners = [PlanningDecoder(w, h, v) for _ in synths]
    plans = []
    for f in range(nframes):
        row = []
        for syn, p in zip(synths, planners):
            p.data = syn.iframe(0x18) if f == 0 else syn.pframe()
            p.offset = 0
            p.decode_frame()
            row.append(p.unified_plan())
        plans.append(row)
    stride = planners[0].stride
    ops, coefs, sizes = packing._pack_gop_chunks(plans, 2)
    B, nct = ops.shape[:2]
    resid = _residuals(torch.from_numpy(coefs).view(-1, 64),
                       torch.from_numpy(sizes).view(-1)).view(B, nct, 256,
                                                               64)
    ring0 = np.random.default_rng(1).integers(
        0, 256, state.ring_shape(B, h, stride)).astype(np.uint8)
    ring_c = torch.from_numpy(ring0).to(cuda)
    step = _take_form(monkeypatch, form, h, stride)
    counts = (executor.launches, executor.frame_launches)
    planes = _plane_counts()
    frames_c = executor.run_gop(torch.from_numpy(ops).to(cuda),
                                resid.to(cuda), ring_c, nframes, h, stride)
    torch.cuda.synchronize()
    assert (executor.launches - counts[0],
            executor.frame_launches - counts[1]) == (
                (0, 1) if nframes == 1 else (1, 0))
    assert tuple(b - a for a, b in zip(planes, _plane_counts())) == step
    ring_p = torch.from_numpy(ring0.copy())
    frames_p = executor.run_gop(torch.from_numpy(ops), resid, ring_p,
                                nframes, h, stride)
    np.testing.assert_array_equal(frames_c.cpu().numpy(), frames_p.numpy())
    np.testing.assert_array_equal(ring_c.cpu().numpy(), ring_p.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["cluster", "one-block"])
@pytest.mark.parametrize("source", sorted(EDGE))
def test_cuda_kernel_matches_plain_on_edge_gops(cuda, monkeypatch, source,
                                                form):
    """GOPs whose ops read and write at the plane's edges (margins, pad
    columns, slack rows, clamped and wrapped MC windows; tests/
    torch_gops.py), frames as wide as their stride: kernel == plain, in
    each form of K1."""
    w, h, s = EDGE[source]
    nb, nf = 2, 4
    ops, coefs, sizes = packing._pack_gop_chunks(
        edge_plans(12, w, h, s, nb, nf), nb)
    nct = ops.shape[1]
    resid = _residuals(torch.from_numpy(coefs).view(-1, 64),
                       torch.from_numpy(sizes).view(-1)).view(nb, nct, 256,
                                                               64)
    ring0 = np.random.default_rng(3).integers(
        0, 256, state.ring_shape(nb, h, s)).astype(np.uint8)
    ring_c = torch.from_numpy(ring0).to(cuda)
    step = _take_form(monkeypatch, form, h, s)
    planes = _plane_counts()
    frames_c = executor.run_gop(torch.from_numpy(ops).to(cuda),
                                resid.to(cuda), ring_c, nf, h, s)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(planes, _plane_counts())) == step
    ring_p = torch.from_numpy(ring0.copy())
    frames_p = executor.run_gop(torch.from_numpy(ops), resid, ring_p, nf, h,
                                s)
    np.testing.assert_array_equal(frames_c.cpu().numpy(), frames_p.numpy())
    np.testing.assert_array_equal(ring_c.cpu().numpy(), ring_p.numpy())


@pytest.mark.cuda
def test_cuda_wavefront_batch_matches_cpu(cuda):
    """The wavefront engine on the card (K6) == on the CPU (plain torch)."""
    from mobiclipdecoder_tpu_torch.parallel.batch import BatchVideoDecoder
    frames = _frames(MobiclipVersion.MODS_DS, (5, 6, 7), 4)
    got = BatchVideoDecoder(W, H, MobiclipVersion.MODS_DS, batch=3,
                            device=cuda).decode_gop(frames)
    want = BatchVideoDecoder(W, H, MobiclipVersion.MODS_DS, batch=3,
                             device="cpu").decode_gop(frames)
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_cuda_sad_volume_and_audio_match_cpu(cuda):
    """The SAD volume (K7), the IMA scans (K9) and the FastAudio lattice
    (K8) on the card == their plain versions on the CPU, each call a launch
    of its kernel."""
    from mobiclipdecoder_tpu_torch.ops import audio_kernels, mesearch_kernels
    from mobiclipdecoder_tpu_torch.ops.adpcm import decode_packets
    from mobiclipdecoder_tpu_torch.ops.audio_lpc import fastaudio_synth
    from mobiclipdecoder_tpu_torch.ops.mesearch import SadVolume
    rng = np.random.default_rng(4)
    cur = rng.integers(0, 256, (H, W)).astype(np.uint8)
    refs = [rng.integers(0, 256, (H, W)).astype(np.uint8) for _ in range(3)]
    before = (mesearch_kernels.sad_launches, audio_kernels.ima_launches,
              audio_kernels.fastaudio_launches)
    np.testing.assert_array_equal(
        SadVolume(cur, refs, range_=8, device=cuda).vol,
        SadVolume(cur, refs, range_=8, device="cpu").vol)
    body = rng.integers(0, 256, (6, 300), dtype=np.uint8)
    i0 = rng.integers(0, 89, 6).astype(np.int32)
    l0 = rng.integers(-32768, 32768, 6).astype(np.int32)
    np.testing.assert_array_equal(
        decode_packets(body, i0, l0, device=cuda),
        decode_packets(body, i0, l0, device="cpu"))
    args = [rng.integers(-2**20, 2**20, (4, 32)),
            rng.integers(-32767, 32768, (4, 8)),
            rng.integers(-2**24, 2**24, (4, 8)),
            rng.integers(-2**24, 2**24, 4)]
    args = [torch.from_numpy(a.astype(np.int32)) for a in args]
    for a, b in zip(fastaudio_synth(*(a.to(cuda) for a in args)),
                    fastaudio_synth(*args)):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())
    assert (mesearch_kernels.sad_launches, audio_kernels.ima_launches,
            audio_kernels.fastaudio_launches) == tuple(n + 1 for n in before)


@pytest.mark.cuda
def test_cuda_ima_final_state_matches_plain(cuda):
    """K9 given each row's length: the samples of the whole rows and the
    state after each row's own nibbles (none, odd, all, past the end) ==
    the plain version's, one launch."""
    from mobiclipdecoder_tpu_torch.ops import audio_kernels
    from mobiclipdecoder_tpu_torch.ops.adpcm import (decode_nibbles,
                                                     decode_nibbles_plain)
    rng = np.random.default_rng(6)
    M, N = 12, 4096
    args = [rng.integers(0, 16, (M, N)), rng.integers(0, 89, M),
            rng.integers(-32768, 32768, M), rng.integers(0, N + 1, M)]
    args[3][:4] = [0, 1, N, N + 3]
    args = [torch.from_numpy(a.astype(np.int32)) for a in args]
    before = audio_kernels.ima_launches
    got = decode_nibbles(*(a.to(cuda) for a in args))
    for g, p in zip(got, decode_nibbles_plain(*args)):
        np.testing.assert_array_equal(g.cpu().numpy(), p.numpy())
    assert audio_kernels.ima_launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("container", ["mods", "moflex"])
def test_cuda_transcoder_audio_goes_through_k9(cuda, container):
    """decode_mods and decode_moflex with engine="cuda" on a 48-frame file
    (launches of 1, 3, 12, 16 and 16 frames): PCM == the oracle engine's
    (the host ImaAdpcmDecoder), one K9 launch per launch whose frames carry
    IMA: all 5 in MODS, 4 in Moflex, whose first frame has no audio (its
    chunk follows it)."""
    from mobiclipdecoder_tpu_torch.ops import audio_kernels
    from mobiclipdecoder_tpu_torch.runtime import transcode
    from torch_av import moflex_ima, mods_ima
    blob = (mods_ima(48, key_at=(0, 24, 40), seed=17)
            if container == "mods" else moflex_ima(48, seed=19))
    decode = getattr(transcode, f"decode_{container}")
    before = audio_kernels.ima_launches
    got = list(decode(blob, engine="cuda"))
    assert audio_kernels.ima_launches - before == (
        len(transcode.launch_lengths(48)) - (container == "moflex"))
    want = list(decode(blob, engine="oracle"))
    assert len(got) == len(want) == 48
    assert sum(f.pcm is not None for f in got) >= 47
    for k, (a, b) in enumerate(zip(got, want)):
        assert (a.pcm is None) == (b.pcm is None), k
        if a.pcm is not None:
            np.testing.assert_array_equal(a.pcm, b.pcm, err_msg=f"frame {k}")


@pytest.mark.cuda
def test_cuda_fastaudio_per_packet_matches_plain(cuda):
    """K8 with a coefficient set per packet and each row's packet count
    (none, one, all, past the end): each row's samples of its packets and
    its state after them == the plain version's, one launch."""
    from mobiclipdecoder_tpu_torch.ops import audio_kernels
    from mobiclipdecoder_tpu_torch.ops.audio_lpc import (
        fastaudio_synth, fastaudio_synth_plain)
    rng = np.random.default_rng(8)
    B, P = 6, 5
    args = [rng.integers(-2**20, 2**20, (B, P * 256)),
            rng.integers(-32767, 32768, (B, P, 8)),
            rng.integers(-2**24, 2**24, (B, 8)),
            rng.integers(-2**24, 2**24, B), rng.integers(0, P + 1, B)]
    args[4][:4] = [0, 1, P, P + 2]
    args = [torch.from_numpy(a.astype(np.int32)) for a in args]
    before = audio_kernels.fastaudio_launches
    got = fastaudio_synth(*(a.to(cuda) for a in args))
    want = fastaudio_synth_plain(*args)
    for b, n in enumerate(args[4].clamp(0, P).tolist()):
        np.testing.assert_array_equal(got[0][b, :256 * n].cpu().numpy(),
                                      want[0][b, :256 * n].numpy())
    for g, p in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.cpu().numpy(), p.numpy())
    assert audio_kernels.fastaudio_launches == before + 1


@pytest.mark.cuda
def test_cuda_transcoder_fastaudio_goes_through_k8(cuda):
    """decode_moflex with engine="cuda" on a 48-frame file with FastAudio
    stereo (codec 0), each frame's chunk before its video, one with a
    round that runs past its payload: PCM == the oracle engine's (the host
    FastAudioDecoder), one K8 launch per launch (1, 3, 12, 16 and 16
    frames), every one of which carries FastAudio."""
    from mobiclipdecoder_tpu_torch.ops import audio_kernels
    from mobiclipdecoder_tpu_torch.runtime import transcode
    from torch_av import moflex_fastaudio
    sizes = [[80 * (5 + f % 2) + 39 * (f == 20)] for f in range(48)]
    blob = moflex_fastaudio(48, seed=23, sizes=sizes)
    before = audio_kernels.fastaudio_launches
    got = list(transcode.decode_moflex(blob, engine="cuda"))
    assert audio_kernels.fastaudio_launches - before == len(
        transcode.launch_lengths(48)) == 5
    want = list(transcode.decode_moflex(blob, engine="oracle"))
    assert len(got) == len(want) == 48
    assert [f.index for f in got if f.pcm is None] == [20]
    for k, (a, b) in enumerate(zip(got, want)):
        assert (a.pcm is None) == (b.pcm is None), k
        if a.pcm is not None:
            np.testing.assert_array_equal(a.pcm, b.pcm, err_msg=f"frame {k}")


def _wii_file(gop_frames, file=0):
    """(MOC5 bytes, GOPs) at 640x480 from the benchmark's frozen
    generator, GOPs of ``gop_frames`` frames each."""
    from benchmark.gen import moc5
    cfg = {"width": 640, "height": 480, "fps": 30, "version": "MOFLEX_3DS"}
    gops = [moc5.file_gop(cfg, 2 ** 31 + 7, file, g, n, 0x18)
            for g, n in enumerate(gop_frames)]
    return moc5.mux_file(cfg, gops), gops


@pytest.mark.cuda
def test_cuda_decode_moc5_at_640x480_takes_the_cluster_form(cuda):
    """decode_moc5 with engine="cuda" on a Wii file of two 10-frame GOPs
    (launches of 1, 3, 12 and 4 frames): frames == the oracle
    engine's, one K1 launch a launch, each in the cluster form (one
    stream: the plane spread over the cluster's shared memory)."""
    from mobiclipdecoder_tpu_torch.runtime import transcode
    data, _gops = _wii_file([10, 10])
    planes = _plane_counts()
    got = list(transcode.decode_moc5(data, engine="cuda"))
    assert tuple(b - a for a, b in zip(planes, _plane_counts())) == (
        0, 0, len(transcode.launch_lengths(20)))
    want = list(transcode.decode_moc5(data, engine="oracle"))
    assert len(got) == len(want) == 20
    for k, (a, b) in enumerate(zip(got, want)):
        assert a.y.shape == (480, 640) and a.u.shape == (240, 320)
        for p in ("y", "u", "v"):
            np.testing.assert_array_equal(getattr(a, p), getattr(b, p),
                                          err_msg=f"frame {k} {p}")


@pytest.mark.cuda
def test_cuda_decode_moc5_ramps_its_first_launches(cuda):
    """A 48-frame Wii file (two 24-frame GOPs) through decode_moc5 on the
    card: 5 K1 launches in the cluster form (1, 3, 12, 16 and 16
    frames), 1 of them a single-frame launch, and 3 ``ramp_launches``."""
    from mobiclipdecoder_tpu_torch.runtime import metrics, transcode
    data, _gops = _wii_file([24, 24])
    planes, frame_launches = _plane_counts(), executor.frame_launches
    ramp = metrics.TOTALS.ramp_launches
    assert len(list(transcode.decode_moc5(data, engine="cuda"))) == 48
    assert tuple(b - a for a, b in zip(planes, _plane_counts())) == (
        0, 0, len(transcode.launch_lengths(48))) == (0, 0, 5)
    assert executor.frame_launches - frame_launches == 1
    assert metrics.TOTALS.ramp_launches - ramp == 3


@pytest.mark.cuda
def test_cuda_batch_decodes_wii_files_like_the_oracle(cuda, tmp_path):
    """The corpus worker (``batch``) with engine="cuda", B=2, over two
    640x480 MOC5 files of two GOPs each: every shard == the oracle
    worker's, in the cluster form of K1."""
    from mobiclipdecoder_tpu_torch.parallel.distributed import run_worker
    files = []
    for f in range(2):
        files.append(tmp_path / f"wii{f}.moc5")
        files[-1].write_bytes(_wii_file([4, 4], file=f)[0])
    planes = _plane_counts()
    st = run_worker(files, tmp_path / "cuda", engine="cuda", batch=2)
    assert st["shards_decoded"] == 4 and st["frames"] == 16
    assert tuple(b - a for a, b in zip(planes, _plane_counts())) == (0, 0, 2)
    run_worker(files, tmp_path / "oracle", engine="oracle")
    for f in range(2):
        for g in range(2):
            name = f"f{f}_g{g}.npy"
            np.testing.assert_array_equal(
                np.load(tmp_path / "cuda" / name),
                np.load(tmp_path / "oracle" / name), err_msg=name)


# the codec's three geometries: (width, height) -> (stride, version)
GEOMS = {(256, 192): (256, MobiclipVersion.MODS_DS),
         (400, 240): (512, MobiclipVersion.MOFLEX_3DS),
         (640, 480): (1024, MobiclipVersion.MOFLEX_3DS)}


def _native_gop(size, nb, nf, seed):
    """(ops, resid, stride) of nb streams x nf frames (an I-frame, then
    P-frames) at a real geometry, scanned by the native scanner; two
    streams are synthesized and repeated to nb."""
    w, h = size
    s, v = GEOMS[size]
    parts = []
    for b in range(min(nb, 2)):
        syn = StreamSynthesizer(w, h, v, seed=seed + b)
        pkts = [syn.iframe(0x18) if f == 0 else syn.pframe()
                for f in range(nf)]
        parts.append(packing._gop_part(
            NativePlanner(w, h, int(v)).scan_gop_packed(pkts)))
    ops, coefs, sizes = packing._part_dense_arrays(
        [parts[b % len(parts)] for b in range(nb)])
    nct = ops.shape[1]
    resid = _residuals(torch.from_numpy(coefs).view(-1, 64),
                       torch.from_numpy(sizes).view(-1)).view(nb, nct, 256,
                                                               64)
    return ops, resid, s


@pytest.mark.cuda
@pytest.mark.parametrize("nb,nf", [(1, 1), (1, 16), (8, 24)])
@pytest.mark.parametrize("size", sorted(GEOMS))
def test_cuda_cluster_form_matches_one_block_form(cuda, monkeypatch, size,
                                                  nb, nf):
    """K1's cluster form (each stream a cluster decoding its frame as a
    wavefront over macroblock rows) == its one-block form (taken here on
    a card stubbed to run no cluster at once), frames and ring, at the three geometries: a lone
    I-frame, 16 frames of one stream and 8 streams x 24 frames; each
    launch is counted in its form."""
    ops, resid, s = _native_gop(size, nb, nf, 61)
    h = size[1]
    ring0 = np.random.default_rng(4).integers(
        0, 256, state.ring_shape(nb, h, s)).astype(np.uint8)
    args = (torch.from_numpy(ops).to(cuda), resid.to(cuda))
    counts = _plane_counts()
    ring_c = torch.from_numpy(ring0).to(cuda)
    frames_c = executor.run_gop(*args, ring_c, nf, h, s)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(counts, _plane_counts())) == (0, 0, 1)
    dev = torch.device("cuda", torch.cuda.current_device())
    assert executor.cluster_size == executor.cluster_form(
        nb, h, s, executor._active_clusters(dev, h, s)) > 0
    step = _take_form(monkeypatch, "one-block", h, s)
    counts = _plane_counts()
    ring_b = torch.from_numpy(ring0).to(cuda)
    frames_b = executor.run_gop(*args, ring_b, nf, h, s)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(counts, _plane_counts())) == step
    assert torch.equal(frames_c, frames_b)
    assert torch.equal(ring_c, ring_b)


@pytest.mark.cuda
@pytest.mark.parametrize("container", ["mods", "moflex", "moc5"])
def test_cuda_transcoder_takes_only_the_cluster_form(cuda, container):
    """A transcoder run of each container on the card (one stream a
    launch): every K1 launch is in the cluster form."""
    from mobiclipdecoder_tpu_torch.runtime import transcode
    from torch_av import moflex_ima, mods_ima
    blob = {"mods": lambda: mods_ima(20, key_at=(0, 10), seed=17),
            "moflex": lambda: moflex_ima(20, seed=19),
            "moc5": lambda: _wii_file([10, 10])[0]}[container]()
    decode = getattr(transcode, f"decode_{container}")
    counts = _plane_counts()
    launches = executor.launches + executor.frame_launches
    assert len(list(decode(blob, engine="cuda"))) == 20
    n = executor.launches + executor.frame_launches - launches
    assert n == len(transcode.launch_lengths(20))
    assert tuple(b - a for a, b in zip(counts, _plane_counts())) == (0, 0, n)


@pytest.mark.cuda
@pytest.mark.parametrize("ndev", [1, 2])
def test_cuda_sharded_decode_matches_unsharded(cuda, ndev):
    """The whole-GOP executor and the wavefront engine with 4 streams
    split in two shards, both on cuda:0 or on cuda:0 and cuda:1 (skips
    with fewer than 2 GPUs): equal to the unsharded decode on the card,
    each shard's output on its own device."""
    from mobiclipdecoder_tpu_torch.ops.vmem_engine import (
        _decode_gop_fused, decode_gop_fused_sharded, gather_shards,
        sharded_rings)
    from mobiclipdecoder_tpu_torch.parallel.batch import BatchVideoDecoder
    if torch.cuda.device_count() < ndev:
        pytest.skip(f"needs {ndev} GPUs")
    devices = ["cuda:0", f"cuda:{ndev - 1}"]
    v = MobiclipVersion.MODS_DS
    frames = _frames(v, (51, 52, 53, 54), 4)
    scan = VmemBatchDecoder(W, H, v, batch=4, device="cpu", native=False)
    arrays = packing._pack_gop_chunks([scan._scan_all(fp) for fp in frames],
                                      4)
    before = executor.launches
    rings, yuvs = decode_gop_fused_sharded(
        devices, sharded_rings(devices, 4, H, S), *arrays, 4, H, S)
    assert executor.launches == before + 2
    assert [y.device for y in yuvs] == [torch.device(d) for d in devices]
    ring1 = torch.zeros(state.ring_shape(4, H, S), dtype=torch.uint8,
                        device=cuda)
    ring1, yuv1 = _decode_gop_fused(
        ring1, *(torch.from_numpy(a).to(cuda) for a in arrays), 4, H, S)
    np.testing.assert_array_equal(gather_shards(yuvs), yuv1.cpu().numpy())
    np.testing.assert_array_equal(gather_shards(rings, 0),
                                  ring1.cpu().numpy())
    np.testing.assert_array_equal(
        BatchVideoDecoder(W, H, v, batch=4, devices=devices).decode_gop(
            frames),
        BatchVideoDecoder(W, H, v, batch=4, device=cuda).decode_gop(frames))


def _prologue_counts():
    """(K5 launches, K4 launches)."""
    return (prologue_kernels.prologue_launches,
            prologue_kernels.residual_launches)


def _plain_prologue(blob, B, nct, nnzb):
    ops, coefs, sizes = unpack_gop_blob(blob, B, nct, nnzb)
    resid = _residuals(coefs.reshape(-1, 64), sizes.reshape(-1))
    return ops, resid.view(B, nct, 256, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("version,size,nb", [
    (MobiclipVersion.MODS_DS, (64, 48), 3),
    (MobiclipVersion.MOFLEX_3DS, (272, 32), 2),
    (MobiclipVersion.MOFLEX_3DS, (528, 32), 2)])
def test_cuda_prologue_kernels_match_plain(cuda, version, size, nb):
    """The blob of native-scanned GOPs: K5 on the card == the plain
    unpack + _residuals on the card, exact int32; one launch of K5 and
    none of K4."""
    parts = []
    for b in range(nb):
        syn = StreamSynthesizer(*size, version, seed=60 + b)
        pkts = [syn.iframe(0x18) if f == 0 else syn.pframe()
                for f in range(5)]
        parts.append(packing._gop_part(
            NativePlanner(*size, int(version)).scan_gop_packed(pkts)))
    blob, nct, nnzb = packing._assemble_gop_parts(parts)
    blob_c = torch.from_numpy(blob).to(cuda)
    before = _prologue_counts()
    ops, resid = unpack_residuals_sblob(blob_c, nb, nct, nnzb)
    torch.cuda.synchronize()
    assert _prologue_counts() == (before[0] + 1, before[1])
    pops, presid = _plain_prologue(blob_c, nb, nct, nnzb)
    assert ops.device == blob_c.device and resid.device == blob_c.device
    assert torch.equal(ops, pops) and torch.equal(resid, presid)
    assert resid.any()


@pytest.mark.cuda
def test_cuda_prologue_kernels_on_extremes_and_pads(cuda):
    """int16 extremes, random op words and sizes, pad, out-of-range and
    negative indices: K5 == plain, exact."""
    rng = np.random.default_rng(9)
    nb, nct = 3, 2
    rows = nct * 256
    ops = rng.integers(0, 1 << 12, (nb, nct, 256, 4)).astype(np.int32)
    coefs = rng.integers(-32768, 32768, (nb, nct, 256, 64)).astype(np.int32)
    coefs[rng.random(coefs.shape) < 0.9] = 0
    coefs[0, 0, 0, :2] = (-32768, 32767)
    sizes = rng.choice([4, 8], (nb, rows)).astype(np.int32)
    blob, nnzb = packing._pack_gop_blob_sparse(ops, coefs, sizes)
    idx = prologue.blob_sections(torch.from_numpy(blob), nb, nct,
                                 nnzb)[2].numpy()
    idx[1, -4:] = (-1, rows * 64 + 1, 2 ** 31 - 1, -(2 ** 31))
    blob_c = torch.from_numpy(blob).to(cuda)
    got = unpack_residuals_sblob(blob_c, nb, nct, nnzb)
    want = _plain_prologue(blob_c, nb, nct, nnzb)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_cuda_residual_rows_match_plain(cuda):
    """The dense form of K4: random rows of both sizes, zero rows, int16
    extremes and a row count that is not a multiple of the block's."""
    rng = np.random.default_rng(10)
    n = 1000
    flat = rng.integers(-32768, 32768, (n, 64)).astype(np.int32)
    flat[rng.random((n, 64)) < 0.6] = 0
    flat[:10] = 0
    flat[10:20] = rng.choice([-32768, 32767], (10, 64))
    sz = rng.choice([4, 8], n).astype(np.int32)
    c, s = torch.from_numpy(flat).to(cuda), torch.from_numpy(sz).to(cuda)
    before = _prologue_counts()
    got = residuals(c, s)
    torch.cuda.synchronize()
    assert _prologue_counts() == (before[0], before[1] + 1)
    assert torch.equal(got, _residuals(c, s))


@pytest.mark.cuda
def test_cuda_decode_goes_through_the_prologue_kernels(cuda, monkeypatch):
    """decode_gop on the card launches K5 once (and K4 not) and never runs
    the plain versions on a CUDA tensor; its frames equal the CPU
    decoder's."""
    def refuse(*args, **kwargs):
        raise AssertionError("a plain prologue version ran on the card")
    monkeypatch.setattr(prologue, "unpack_gop_blob", refuse)
    monkeypatch.setattr(prologue, "_residuals", refuse)
    monkeypatch.setattr(residuals_mod, "_residuals", refuse)
    v = MobiclipVersion.MOFLEX_3DS
    frames = _frames(v, (71, 72), 4)
    before = _prologue_counts()
    got = VmemBatchDecoder(W, H, v, batch=2, device=cuda).decode_gop(frames)
    assert _prologue_counts() == (before[0] + 1, before[1])
    monkeypatch.undo()
    want = VmemBatchDecoder(W, H, v, batch=2, device="cpu").decode_gop(
        frames)
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_cuda_blob_path_launches_one_prologue_kernel_and_no_fill(cuda):
    """The blob path launches exactly one prologue kernel (K5) per GOP and
    per F=1 round, and no fill of resid: counted by the wrappers, and by
    the kernel names a torch.profiler trace of one decode_gop shows."""
    from torch.profiler import ProfilerActivity, profile
    from mobiclipdecoder_tpu_torch.ops.vmem_engine import VmemVideoDecoder
    v = MobiclipVersion.MODS_DS
    pkts = [fr[0] for fr in _frames(v, (81,), 6)]
    vd = VmemVideoDecoder(W, H, v, native=True, device=cuda)
    before = (_prologue_counts(), executor.launches, executor.frame_launches)
    vd.decode_stream_chunk(pkts[:4])
    for p in pkts[4:]:
        vd.decode_frame(p)
    torch.cuda.synchronize()
    k5, k4 = _prologue_counts()
    gops = executor.launches - before[1]
    rounds = executor.frame_launches - before[2]
    assert rounds == 2 and gops >= 1
    assert (k5 - before[0][0], k4 - before[0][1]) == (gops + rounds, 0)
    frames = _frames(v, (82, 83), 4)
    dec = VmemBatchDecoder(W, H, v, batch=2, device=cuda)
    dec.decode_gop(frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dec.decode_gop(frames)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("mobi_prologue_sblob" in n for n in names) == 1, names
    assert not [n for n in names if "fill" in n.lower()
                or "mobi_residual_rows" in n], names


def _wavefront_rounds(cuda, version, size, nb, nframes):
    """(BatchVideoDecoder on the card, the host arrays of the frame rounds
    of nb synthesized streams)."""
    from mobiclipdecoder_tpu_torch.parallel.batch import BatchVideoDecoder
    synths = [StreamSynthesizer(*size, version, seed=40 + b)
              for b in range(nb)]
    bd = BatchVideoDecoder(*size, version, batch=nb, device=cuda)
    return bd, [bd.scan_packets([s.iframe(0x18) if f == 0 else s.pframe()
                                 for s in synths]) for f in range(nframes)]


def _wavefront_round(cuda, version, size, nb, nframes):
    """The frame rounds of nb synthesized streams, scanned and uploaded
    once: (BatchVideoDecoder, per round its plan tensors on the card)."""
    from mobiclipdecoder_tpu_torch.parallel.batch import upload_rounds
    bd, rounds = _wavefront_rounds(cuda, version, size, nb, nframes)
    return bd, upload_rounds(rounds, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("version,size,nb,nframes", [
    (MobiclipVersion.MODS_DS, (256, 192), 8, 2),
    (MobiclipVersion.MOFLEX_3DS, (640, 480), 1, 1)], ids=["ds-b8", "640x480"])
def test_cuda_wavefront_kernel_matches_plain(cuda, version, size, nb,
                                             nframes):
    """K6 == decode_frame_core_plain on the card, exact, for a DS B=8 I-frame
    round and the P-frame round after it (a random ring under both), and a
    640x480 I-frame; one K6 launch per round."""
    from mobiclipdecoder_tpu_torch.models import pipeline as pp
    from mobiclipdecoder_tpu_torch.ops import wavefront_kernels as wk
    bd, ups = _wavefront_round(cuda, version, size, nb, nframes)
    h, s = size[1], bd.stride
    ring = torch.randint(0, 256, bd.rings[0].shape, dtype=torch.int32,
                         device=cuda)
    for t in ups:
        args = (ring, t["mc"], t["resid"], t["resid_coef"], t["iops"],
                t["icoef"], t["seqmap"], t["n_levels"], h, s)
        before = wk.wavefront_launches
        got = pp.decode_frame_core(*args)
        assert wk.wavefront_launches == before + 1
        want = pp.decode_frame_core_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        ring = torch.roll(ring, 1, dims=1)
        ring[:, 0] = got


@pytest.mark.cuda
@pytest.mark.parametrize("version,size,nb,nframes", [
    (MobiclipVersion.MODS_DS, (256, 192), 8, 8),
    (MobiclipVersion.MOFLEX_3DS, (640, 480), 1, 1)], ids=["ds-b8", "640x480"])
def test_cuda_gop_kernel_matches_plain_round_loop(cuda, version, size, nb,
                                                  nframes, monkeypatch):
    """K6 over a whole GOP (8 DS rounds of 8 streams, the head wrapping;
    a 640x480 I-frame) in one launch == decode_gop_plain's round loop on
    the card, frames and ring, from a random ring at head 2, for every
    cluster size."""
    from mobiclipdecoder_tpu_torch.models import pipeline as pp
    from mobiclipdecoder_tpu_torch.ops import wavefront_kernels as wk
    bd, rounds = _wavefront_rounds(cuda, version, size, nb, nframes)
    plans = wk.upload_gop(rounds, cuda)
    h, s = size[1], bd.stride
    ring0 = torch.randint(0, 256, bd.rings[0].shape, dtype=torch.int32,
                          device=cuda)
    want_ring = ring0.clone()
    want = pp.decode_gop_plain(want_ring, 2, plans.rounds, h, s)
    for c in (1, 2, 4, 8):
        monkeypatch.setattr(wk, "CLUSTER", c)
        ring = ring0.clone()
        before = wk.wavefront_launches
        got = pp.decode_gop(ring, 2, plans, h, s)
        assert wk.wavefront_launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, want), c
        assert torch.equal(ring, want_ring), c


@pytest.mark.cuda
def test_cuda_batch_decoder_launches_k6_once_per_round(cuda, monkeypatch):
    """BatchVideoDecoder on the card: one K6 launch per GOP and shard
    (decode_gop) and per frame round and shard (decode_frames), and the
    plain version never runs (patched to raise); frames == the CPU
    decoder's."""
    from mobiclipdecoder_tpu_torch.models import pipeline as pp
    from mobiclipdecoder_tpu_torch.ops import wavefront_kernels as wk
    from mobiclipdecoder_tpu_torch.parallel.batch import BatchVideoDecoder
    v = MobiclipVersion.MODS_DS
    frames = _frames(v, (61, 62, 63, 64), 3)
    want = BatchVideoDecoder(W, H, v, batch=4, device="cpu").decode_gop(frames)

    def plain(*a, **k):
        raise AssertionError("the plain version ran on the card's path")

    monkeypatch.setattr(pp, "decode_frame_core_plain", plain)
    before = wk.wavefront_launches
    got = BatchVideoDecoder(W, H, v, batch=4, device=cuda).decode_gop(frames)
    assert wk.wavefront_launches == before + 1      # one launch per GOP
    np.testing.assert_array_equal(got, want)
    two = BatchVideoDecoder(W, H, v, batch=4, devices=[cuda, cuda])
    before = wk.wavefront_launches
    np.testing.assert_array_equal(
        np.stack([two.decode_frames(fp) for fp in frames]), want)
    assert wk.wavefront_launches == before + 6
    dec = pp.WavefrontVideoDecoder(W, H, v, device=cuda)
    before = wk.wavefront_launches
    dec.decode_frame(frames[0][0])
    assert wk.wavefront_launches == before + 1
