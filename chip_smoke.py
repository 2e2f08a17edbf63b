"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--kernel-only | --multi-device]

Builds the executor kernel, the prologue kernels, the wavefront engine's
kernel, the encoder's SAD-volume kernel and the audio kernels from
mobiclipdecoder_tpu_torch/csrc with nvcc (one nvcc per source, five
started together), holds them against their plain PyTorch
versions, drives the main path (the fused whole-GOP decode of 8 DS MODS
256x192 streams, 2 GOPs of 24 frames) and the per-frame path, checks both
against the sequential oracle, and times the kernels and the decoder.
Then it covers the other geometries and the user's entry points:

  [prologue]   the prologue kernels (csrc/prologue.cu: K5 the whole
               sparse-blob prologue, blob -> ops and resid in one launch;
               K4 the IDCT pre-pass of dense rows) == the plain chain
               (unpack_gop_blob + _residuals) on the card, exact int32, on
               the blobs of DS 256x192 B=8 F=24, 400x240 B=4 F=12 and
               640x480 B=2 F=8 (the bench's sizes; the two wide GOPs are
               synthesized in spawned processes from the start of the run)
               and in K4 on their dense arrays, and on a blob of int16
               extremes with pad, out-of-range and negative indices; each
               kernel's ms (median of 20, in turns with the plain chain
               and with Tensor.scatter_ of the blob's values, the one
               PyTorch call for the scatter part of K5's work), its bound
               and the plain chain's ms;
  [geometry]   3DS 400x240 (stride 512) and Wii 640x480 (stride 1024, the
               Moflex profile): kernel == plain executor, the format-
               surface streams through decode_stream_chunk == oracle, and
               the executor's ms/GOP at B=8, F=24;
  [k2]         the single-frame launch (F=1) == plain at all three sizes;
  [k1_forms]   K1's cluster form (a thread-block cluster a stream, its
               frame a wavefront over macroblock rows) == its one-block
               form, frames and ring, at the three sizes on a lone I-frame
               (B=1 F=1) and a 24-frame GOP repeated to B=8, 16 and 32;
               both timed in turns behind the spin, the cluster form also
               at C = 4, 8 and 16; the clusters the card runs at once and
               the form the wrapper takes; each form's launches (also in
               --kernel-only); [kernel_vs_plain] holds both forms against
               the plain executor;
  [transcode]  `python -m mobiclipdecoder_tpu_torch decode` (in process)
               of a MODS 256x192 with IMA audio, a Moflex 400x240 with
               IMA audio, a Moflex 400x240 with FastAudio stereo at
               32,728 Hz (each frame's chunk before its video) and a MOC5
               640x480, 20 frames each: the .y4m and .wav bytes equal
               those of `--engine oracle`, one K9 launch per launch that
               carries IMA audio and one K8 launch per launch that
               carries FastAudio;
  [batch]      the corpus worker over 8 MODS files of 2 GOPs each, 8
               streams per launch: every shard equals the oracle worker's;
  [wavefront]  the wavefront engine (the JAX package's tpu-xla; on the
               card K6, csrc/wavefront.cu, one launch per GOP and shard):
               K6 == its plain version on the card frame round by frame
               round for GOP 0 of the main path and a 640x480 I-frame,
               both timed per GOP in turns, with K6's bound, its phase
               split (I-frame and P rounds alone, no levels, levels
               only) and the sweep of its cluster size C = 1, 2, 4, 8;
               BatchVideoDecoder.decode_gop over the main path's 8 streams
               x 2 GOPs == the oracle and the executor's frames, one K6
               launch per GOP; WavefrontVideoDecoder at 400x240 and
               640x480 == oracle, one launch per frame;
               `decode --engine wavefront` of the three [transcode]
               containers == `--engine oracle` bytes; K6 launches per path,
               ms and wall per GOP, frames/s, intra levels per round and
               device activities per GOP (at most 4);
  [encode]     K7 (csrc/sad.cu, the SAD volume) == its plain version on
               the card, exact int32, at all three sizes with the encoder's
               defaults (range 16, 5 references of encoder_frames, the
               oldest 0/255 noise), K7 and the plain version timed in turns
               beside K7's bound, and the whole SadVolume call (its copy to
               host memory included); the encoder at all three sizes
               (quantizer 0x14, gop 4, refs 2, me_range 6, 3 frames, Moflex
               profile): its SAD volumes on the card == on the CPU, its
               bytes == the CPU encoder's, its packets decoded by the
               executor and by the wavefront engine == oracle; a 640x480
               encode at the encoder's defaults (3 frames): its packets
               decoded by the executor == oracle, its s per frame; `encode`
               then `decode --engine cuda` == `decode --engine oracle`
               bytes; K7's launches on each path;
  [audio]      K9 (the IMA ADPCM scans) == its plain version on the card at
               64 channels x 1 s on random bytes and the four pinned cases
               of tests/test_torch_audio.py, and decode_packets on the card
               == the host decoder on each; K9 given row lengths at the
               transcoder's shapes (4 x 4,096 and 32 x 256 nibbles) ==
               the plain version, samples and final states, each timed;
               K8 (the FastAudio lattice) == its plain version on the
               card over 4 rounds of 256 channels; K8 with a coefficient
               set per packet and each row's packet count at the
               transcoder's shapes (2 channels x 5 and x 85 packets, rows
               one packet apart) == the plain version, samples and final
               states, each timed; and
               FastAudioBatchDecoder on the card (16 channels x 50
               packets) == the host decoders and the plain version round
               by round; each kernel and its plain version
               timed in turns beside its bound; K8's and K9's launches;
  [sharded]    decode_gop_fused_sharded over every visible GPU (cuda:0
               twice on a one-card machine): the main path's 8 streams x 2
               GOPs == the unsharded executor's frames and ring, and the
               400x240 and 640x480 24-frame GOPs doubled to B=2 the same
               way; ms per GOP, sharded against one launch on cuda:0;
  [entry]      graft_entry.entry("cuda") == the oracle's I-frame, and
               dryrun_multichip over the same devices (every sharded
               result == one device);
  [warm]       tools/warm_kernels at the three geometries, every library
               already built: the seconds of a warm call;
  [multi_gpu]  with two or more GPUs, run_worker in two spawned processes
               through init_distributed (NCCL): each rank on its own GPU,
               its shards == the oracle worker's; with one GPU it prints
               that it was skipped;
  [trace]      torch.profiler (CPU and CUDA activity) over decode_gops of
               20 of the main path's GOPs, then one decode_gop: the
               engine's mobiclip.scan / .pack / .dispatch /
               .device_decode spans must appear; their host ms per GOP, and the device's busy share
               of the window (the union of its kernel, memcpy and memset
               intervals over the wall), under the profiler;
  [bench]      the port's bench (mobiclipdecoder_tpu_torch/bench.py) on the
               main path's GOP 0: its e2e GOP == the main path's frames
               and the oracle; its JSON line;
  [scaling]    tools/scaling_bench on cuda:0 (n = 1): a worker process and
               the in-process sharded decode, every last GOP == the
               unsharded executor's; its JSON line.

The CPU references of [wavefront] and [encode] (the oracle of streams 2-7,
the encoder with device="cpu") run in a pool of spawned processes, started
when [wavefront] starts and shut down after [encode].

Every phase raises on a mismatch.  Before each run of a user path that
reaches the executor or K6 the launch counters of the executor, the
prologue kernels and K6-K9 are set to 0, and they are read after it (the
kernels line gives each
kernel's launches by path); they also show which form of the executor ran
(the cluster form on every path here, at most 8 streams a launch; the
one-block form keeps the working plane in shared memory at 256x192 and
400x240, in global memory at 640x480).  ``--kernel-only`` stops after
the build (whose ptxas report it prints), [prologue], K6 against its plain version, the
executor-vs-plain checks at every geometry, as a GOP and at F=1, and K7,
K8 and K9 against their plain versions, and prints no result line.
``--multi-device`` runs the build, the main path's decode and then only
[sharded], [entry], [multi_gpu] and
[scaling] over every visible GPU (on a machine with several GPUs: the
sharded paths across cards, a launch for another card refused, two NCCL
ranks, the worker and mesh scaling at n = 1, 2, 4, 8 up to the GPUs),
and prints no result line.  The kernels line's launches by path count
the bench's launches at all three of its geometries under "bench" (and
its F=1 rounds under "bench_per_round"), and [scaling]'s launches in this
process (the mesh) under "scaling"; each worker process counts its own.

Prints one line per phase with its seconds, then a JSON line describing
each kernel, the card's name and power limit, and last a JSON line
{"ok": true, "device": {...}}.  Needs a CUDA device; without one it exits
non-zero and prints no result.  Imports nothing of JAX and nothing of the
JAX package: the codec's host modules are the port's own copies.

Besides the checks it measures, on the same card in the same run: the
executor's time at B = 8, 32, 128 and 256 streams, the time of each stage
of one GOP's dispatch (the prologue kernel K5, the plain chain's two
stages beside it), the device activities and the kernels by name per GOP
under the profiler, the plain executor on the card against the kernel
at the Moflex shape, the sustained frames/s of decode_gops over three
windows of SUSTAIN_GOPS GOPs, the executor at each geometry, and the
frames/s of the transcoder and of the corpus worker.  For each
geometry it prints the ops per stream per GOP (the length of the serial
chain), the kernel's ns per op, its plane form and shared memory, and
bound_ms: the least time the card could take for the same work.
"""
from __future__ import annotations

import concurrent.futures as _cf
import contextlib
import io
import json
import multiprocessing
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from mobiclipdecoder_tpu_torch.runtime.transcode import (CHUNK_FRAMES,
                                                       launch_lengths,
                                                       width_stride)

W, H = 256, 192
B, F = 8, 24
NGOPS = 2
SUSTAIN_GOPS = 120          # about 3 s of decode_gops per window
SWEEP_B = (8, 32, 128, 256)
WIDE = ((400, 240), (640, 480))     # strides 512 and 1024, Moflex profile
TRANSCODE_FRAMES = 20               # crosses one CHUNK_FRAMES (16) seam
BATCH_FILES, BATCH_GOP = 8, 5       # [batch]: 8 files x 2 GOPs of 5 frames
WF_FRAMES = 4                       # [wavefront] streams at 400x240, 640x480
ENC = dict(quantizer=0x14, gop=4, refs=2, me_range=6)   # [encode]
ENC_FRAMES = 3
IMA_CHANNELS, IMA_SAMPLES = 64, 32768     # [audio]: 1 s at 32768 Hz
# [audio]: K9's rows on the transcoder's path, one launch per 16 frames:
# DS (2-4 runs of 16 packets of 256 nibbles), Moflex (30-32 channel blocks)
IMA_CHUNK_SHAPES = ((4, 4096), (32, 256))
FA_CHANNELS, FA_PACKETS = 16, 50
FA_CORPUS, FA_CORPUS_ROUNDS = 256, 4      # [audio]: a corpus job's streams
# [audio]: K8's rows on the transcoder's path, one launch per launch of
# frames: 2 channels of a first launch's 5 packets and of a 16-frame
# launch's 85 (FastAudio at 32,728 Hz, 24 fps)
FA_TRANSCODER_PACKETS = (5, 85)
SAD_RANGE, SAD_REFS = 16, 5               # the encoder's defaults
ENC_WIDE = (640, 480)                     # [encode] at the defaults
TRACE_GOPS = 20                     # [trace]: decode_gops under the profiler
SPAN_NAMES = ("mobiclip.scan", "mobiclip.pack", "mobiclip.dispatch",
              "mobiclip.device_decode")
TRACE_WINDOW = "chip_smoke.decode_gops"
# H100 SXM peaks: memory rate, and the 32-bit rate outside the tensor
# cores (no int32 peak is published; the executor's arithmetic is 32-bit
# integer)
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    log(f"[{name}] phase took {time.perf_counter() - t0:.1f} s")


def smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def zero_counts() -> None:
    from mobiclipdecoder_tpu_torch.ops import (audio_kernels, executor,
                                               mesearch_kernels,
                                               prologue_kernels,
                                               wavefront_kernels)
    mesearch_kernels.sad_launches = 0
    audio_kernels.fastaudio_launches = 0
    audio_kernels.ima_launches = 0
    wavefront_kernels.wavefront_launches = 0
    executor.launches = 0
    executor.frame_launches = 0
    executor.smem_plane_launches = 0
    executor.global_plane_launches = 0
    executor.cluster_launches = 0
    prologue_kernels.prologue_launches = 0
    prologue_kernels.residual_launches = 0


def read_counts() -> tuple[int, int]:
    """(whole-GOP launches, single-frame launches) since zero_counts."""
    from mobiclipdecoder_tpu_torch.ops import executor
    return executor.launches, executor.frame_launches


def read_prologue_counts() -> tuple[int, int]:
    """(K5 sparse-blob prologue launches, K4 dense row-transform
    launches) since zero_counts."""
    from mobiclipdecoder_tpu_torch.ops import prologue_kernels
    return (prologue_kernels.prologue_launches,
            prologue_kernels.residual_launches)


def read_wavefront_count() -> int:
    """K6 launches since zero_counts."""
    from mobiclipdecoder_tpu_torch.ops import wavefront_kernels
    return wavefront_kernels.wavefront_launches


def read_plane_counts() -> tuple[int, int, int]:
    """K1 launches since zero_counts: (one block a stream with the plane in
    shared memory, the same with it in global memory, a cluster a
    stream)."""
    from mobiclipdecoder_tpu_torch.ops import executor
    return (executor.smem_plane_launches, executor.global_plane_launches,
            executor.cluster_launches)


def check_plane_form(label: str, h: int, S: int) -> tuple[int, int, int]:
    """The launches since zero_counts all took one form of K1, and at
    least one did: the cluster form (every path here runs at most 8
    streams a launch, and the card runs every one of their clusters at
    once), or the one-block form with this geometry's plane."""
    from mobiclipdecoder_tpu_torch.ops import executor
    sm, gl, cl = read_plane_counts()
    one = (sm > 0 and gl == 0) if executor.plane_in_smem(h, S) else (
        gl > 0 and sm == 0)
    if not ((cl > 0 and sm == gl == 0) or (cl == 0 and one)):
        raise AssertionError(f"{label}: K1 launches one-block smem {sm}, "
                             f"one-block global {gl}, cluster {cl}")
    return sm, gl, cl


def _popc(x):
    return sum((x >> k) & 1 for k in range(8))


def gop_work(ops, F: int, h: int, S: int) -> dict:
    """What one executor launch on these op chunks (B, nct, CHUNK, 4) must
    do.  ``ops_max``/``ops_mean``: op rows per stream (the serial chain).
    ``bytes``: each input read once (the op rows in use, the coefficient
    rows the ops reference, the ring slots read before this launch
    writes them, the intra tables) and each output written once (the
    frames, the ring slots written).  ``ops``: the pixels the ops write,
    one operation each at least.  ``bound_ms`` is the larger of bytes over
    the memory rate and ops over the 32-bit rate."""
    from mobiclipdecoder_tpu_torch.ops.packing import CHUNK, _geom
    ops = np.asarray(ops).astype(np.int64)
    nb = ops.shape[0]
    _hh, G8, SP = _geom(h, S)
    plane = G8 * 8 * SP
    fid = ops[:, :, 0, 1]
    live = (fid >= 0) & (fid < F)
    count = np.where(live, np.clip(ops[:, :, 0, 0], 0, CHUNK - 1), 0)
    used = (np.arange(CHUNK) >= 1) & (np.arange(CHUNK) <= count[..., None])
    w0 = ops[..., 0]
    typ, sl = w0 & 3, (w0 >> 2) & 7
    bw, bh = (w0 >> 16) & 0x1F, (w0 >> 21) & 0x1F
    one = np.ones_like(w0)
    nrows = np.select(
        [typ == 1, (typ == 2) & (sl == 4), (typ == 2) & (sl == 5), typ == 2,
         (typ == 3) & ((sl == 5) | (sl == 6)), (typ == 3) & (sl == 7),
         typ == 3],
        [_popc((w0 >> 3) & 0x3F), _popc((w0 >> 5) & 0xF),
         _popc((w0 >> 5) & 0x3), one, _popc((w0 >> 21) & 0xF),
         _popc((w0 >> 10) & 0x3), (w0 >> 10) & 1], 0)
    side = np.where(sl <= 4, 1 << np.minimum(sl, 4), 0)
    pixels = np.select(
        [typ == 1, (typ == 2) & (sl == 4), (typ == 2) & (sl == 5), typ == 2,
         (typ == 3) & (sl == 5), (typ == 3) & (sl == 7), typ == 3],
        [bw * bh + 2 * (bw >> 1) * (bh >> 1), 256 * one, 128 * one,
         side * side, 64 * one, 128 * one,
         np.where(sl == 6, 256, side * side)], 0)
    # ring slots read as inputs: frame f's reference r is frame f - r (its
    # own slot, r = 0, holds frame f - 6), made before this launch if < 0
    f = np.broadcast_to(fid[..., None], w0.shape)
    ref = (w0 >> 13) & 7
    src = np.where(ref >= 1, f - ref, f - 6)
    mc_in = used & (typ == 1) & (src < 0)
    slots_in = sum(len(set(((5 - f[b] % 6 + ref[b]) % 6)[mc_in[b]].tolist()))
                   for b in range(nb))
    nbytes = int((count + live).sum() * 16 + (nrows * used).sum() * 256
                 + slots_in * plane + (20 * 256 * 4 if (used & (typ == 3)).any()
                                       else 0)
                 + F * nb * plane + min(F, 6) * nb * plane)
    nops = int((pixels * used).sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / OPS_PER_S
    per = count.sum(axis=1)
    return {"streams": nb, "ops_max": int(per.max()),
            "ops_mean": float(per.mean()),
            "bytes": nbytes, "ops": nops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def kernel_facts(ms: float, work: dict, h: int, S: int) -> dict:
    """The kernel's form, shared memory and ns per op of the longest
    stream's ops, beside its bound."""
    from mobiclipdecoder_tpu_torch.ops import executor
    sm = executor.plane_in_smem(h, S)
    dev = torch.device("cuda", torch.cuda.current_device())
    C = executor.cluster_form(work["streams"], h, S,
                              executor._active_clusters(dev, h, S))
    return {"ms": ms,
            "plane": (f"a cluster's ({C} blocks) shared" if C
                      else "shared" if sm else "global"),
            "smem_bytes": (executor.cluster_smem_bytes(h, S, C) if C
                           else executor.smem_bytes(h, S, sm)),
            "ops_per_stream": work["ops_max"],
            "ns_per_op": ms * 1e6 / max(work["ops_max"], 1),
            "bound_ms": work["bound_ms"], "bound_by": work["bound_by"],
            "bytes": work["bytes"]}


def facts_line(label: str, shape: str, k: dict) -> str:
    return (f"{label} {shape}: plane in {k['plane']} memory, "
            f"{k['smem_bytes']} B shared memory per block; "
            f"{k['ops_per_stream']} ops per stream (longest); kernel "
            f"{k['ms']:.3f} ms = {k['ns_per_op']:.1f} ns/op; bound "
            f"{k['bound_ms'] * 1e3:.2f} us ({k['bound_by']}: "
            f"{k['bytes'] / 1e6:.2f} MB), kernel/bound "
            f"{k['ms'] / k['bound_ms']:.0f}x")


def synth_gops(version, seeds, ngops, nframes, size=(W, H)):
    """gops[g][f][b]: packet of frame f of stream b in GOP g (each GOP
    starts with an I-frame)."""
    from mobiclipdecoder_tpu_torch.testing.synth import StreamSynthesizer
    synths = [StreamSynthesizer(*size, version, seed=s) for s in seeds]
    return [[[s.iframe(0x18) if f == 0 else s.pframe() for s in synths]
             for f in range(nframes)] for _ in range(ngops)]


def oracle_frames(version, packets, size=(W, H)):
    """(len(packets), HH, S) uint8 from the sequential oracle."""
    from mobiclipdecoder_tpu_torch.models.oracle_video import OracleDecoder
    o = OracleDecoder(*size, version)
    S = o.stride
    out = []
    for pkt in packets:
        o.data = pkt
        o.offset = 0
        o.decode_frame()
        out.append(np.concatenate([o.y_planes[0].reshape(-1, S),
                                   o.uv_planes[0].reshape(-1, S)]))
    return np.stack(out)


def scanned_parts(version, gop, size=(W, H)) -> list[dict]:
    """Native scan of one GOP -> one packed part per stream."""
    from mobiclipdecoder_tpu_torch.utils.native import NativePlanner
    from mobiclipdecoder_tpu_torch.ops.packing import _gop_part
    nb = len(gop[0])
    parts = []
    for b in range(nb):
        r = NativePlanner(*size, int(version)).scan_gop_packed(
            [fr[b] for fr in gop])
        if r["err"] or r["val_overflow"] or r["done"] != len(gop):
            raise RuntimeError(f"native scan of stream {b} failed")
        parts.append(_gop_part(r))
    return parts


def packed_gop(version, gop, size=(W, H)):
    """Native scan of one GOP -> (ops, coefs, sizes) host arrays, the
    executor's inputs before the residual pre-pass."""
    from mobiclipdecoder_tpu_torch.ops.packing import _part_dense_arrays
    return _part_dense_arrays(scanned_parts(version, gop, size))


def kernel_vs_plain(version, gop, label, seed, size=(W, H)):
    """Run one packed GOP through the CUDA kernel, in each of its forms
    (the wrapper's choice first, then the other), and through the plain
    executor on the CPU, from the same random ring; frames and ring must
    be equal.  Returns (max_abs_err, kernel_ms, plain_ms, inputs) with the
    time and the ring of the wrapper's form."""
    from mobiclipdecoder_tpu_torch import state
    from mobiclipdecoder_tpu_torch.ops import executor
    from mobiclipdecoder_tpu_torch.ops.residuals import _residuals
    ops, coefs, sizes = packed_gop(version, gop, size)
    nb, nct = ops.shape[:2]
    nf = len(gop)
    h, S = size[1], width_stride(size[0])
    ring0 = np.random.default_rng(seed).integers(
        0, 256, state.ring_shape(nb, h, S)).astype(np.uint8)

    def resid(on_card):
        c = torch.from_numpy(coefs).view(-1, 64)
        s = torch.from_numpy(sizes).view(-1)
        if on_card:
            c, s = c.cuda(), s.cuda()
        return _residuals(c, s).view(nb, nct, 256, 64)

    ops_c = torch.from_numpy(ops).cuda()
    res_c = resid(True)
    ring_p = torch.from_numpy(ring0.copy())
    t0 = time.perf_counter()
    frames_p = executor.run_gop(torch.from_numpy(ops), resid(False), ring_p,
                                nf, h, S)
    p_ms = (time.perf_counter() - t0) * 1e3
    # the form the wrapper takes first (its ring and time are returned),
    # then the other: each form of K1 against the plain executor
    dev = ops_c.device
    first = ("cluster" if executor.cluster_form(
        nb, h, S, executor._active_clusters(dev, h, S)) else "one-block")
    k_ms, err = {}, 0
    for form in (first, {"cluster": "one-block"}.get(first, "cluster")):
        ring = torch.from_numpy(ring0).cuda()
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with k1_form(form):
            e0.record()
            frames_c = executor.run_gop(ops_c, res_c, ring, nf, h, S)
            e1.record()
        torch.cuda.synchronize()
        k_ms[form] = e0.elapsed_time(e1)
        if form == first:
            ring_c = ring
        e = max(
            int((frames_c.cpu().to(torch.int32)
                 - frames_p.to(torch.int32)).abs().max()),
            int((ring.cpu().to(torch.int32)
                 - ring_p.to(torch.int32)).abs().max()))
        if e != 0:
            raise AssertionError(f"{label}: kernel ({form} form) != plain, "
                                 f"max abs err {e}")
        err = max(err, e)
    log(f"[kernel_vs_plain] {label} B={nb} F={nf} nct={nct}: frames and "
        f"ring equal (max abs err 0) in both forms of the kernel; kernel "
        f"(first launch) " + ", ".join(f"{k} {v:.3f} ms" for k, v in
                                      k_ms.items())
        + f" (the wrapper takes the {first} form), plain {p_ms:.1f} ms "
        f"(CPU)")
    k_ms = k_ms[first]
    return err, k_ms, p_ms, (ops_c, res_c, ring_c, nf, h, S)


def plain_on_card(inputs) -> float:
    """The plain executor run on CUDA tensors (the same inputs as the
    kernel's); its frames must equal the kernel's.  Returns its ms."""
    from mobiclipdecoder_tpu_torch import state
    from mobiclipdecoder_tpu_torch.ops import executor
    from mobiclipdecoder_tpu_torch.ops.executor_ref import run_gop_ref
    ops_c, res_c, ring_c, nf, h, S = inputs
    ring_k, ring_p = ring_c.clone(), ring_c.clone()
    frames_k = executor.run_gop(ops_c, res_c, ring_k, nf, h, S)
    frames_p = torch.empty_like(frames_k)
    tabs = state.kernel_tables(ops_c.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_gop_ref(ops_c, res_c, ring_p, frames_p, tabs, h, S)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if not (torch.equal(frames_k, frames_p) and torch.equal(ring_k, ring_p)):
        raise AssertionError("plain executor on the card != kernel")
    return ms


def time_kernel(inputs, reps=20) -> float:
    """Mean kernel time (ms) over `reps` launches, device-resident."""
    from mobiclipdecoder_tpu_torch.ops import executor
    ops_c, res_c, ring_c, nf, h, S = inputs
    for _ in range(3):
        executor.run_gop(ops_c, res_c, ring_c, nf, h, S)
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        executor.run_gop(ops_c, res_c, ring_c, nf, h, S)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def replicate(inputs, nb, reps=20) -> float:
    """Kernel ms/GOP with a GOP's streams replicated to `nb` streams (in
    the form the wrapper takes for nb streams), from a zero ring."""
    ops_c, res_c, _ring, nf, h, S = inputs
    k = nb // ops_c.shape[0]
    ring = torch.zeros((nb,) + tuple(_ring.shape[1:]), dtype=torch.uint8,
                       device=_ring.device)
    return time_kernel((ops_c.repeat(k, 1, 1, 1).contiguous(),
                        res_c.repeat(k, 1, 1, 1).contiguous(), ring, nf, h,
                        S), reps)


def fixed_cost_ms(size, nf=16, reps=10) -> float:
    """Kernel ms per frame of a B=1 GOP whose frames hold no op: the
    executor's fixed cost per frame (finding the frame's rows, zeroing the
    working plane and writing it to the frames and the ring, 16 bytes per
    store; in the cluster form, which B=1 takes)."""
    from mobiclipdecoder_tpu_torch import state
    from mobiclipdecoder_tpu_torch.ops.packing import CHUNK
    h, S = size[1], width_stride(size[0])
    ops = torch.zeros((1, nf, CHUNK, 4), dtype=torch.int32)
    ops[0, :, 0, 1] = torch.arange(nf)          # header [0, f, first, last]
    ops[0, :, 0, 2:] = 1
    resid = torch.zeros((1, nf, CHUNK, 64), dtype=torch.int32)
    ring = torch.zeros(state.ring_shape(1, h, S), dtype=torch.uint8)
    return time_kernel((ops.cuda(), resid.cuda(), ring.cuda(), nf, h, S),
                       reps) / nf


# [k1_forms]: cluster sizes timed beside the one the wrapper takes
K1_CLUSTER_SWEEP = (4, 8, 16)


@contextlib.contextmanager
def k1_form(form: str, C: int | None = None):
    """K1 in `form` whatever the batch: "one-block", or "cluster" with
    clusters of C blocks (default: the wrapper's own choice, or CLUSTER
    where it takes the one-block form); None: the wrapper's choice."""
    from mobiclipdecoder_tpu_torch.ops import executor
    choose = executor.cluster_form
    if form == "one-block":
        executor.cluster_form = lambda *a: 0
    elif form == "cluster":
        executor.cluster_form = (
            lambda *a: C or choose(*a) or executor.CLUSTER)
    try:
        yield
    finally:
        executor.cluster_form = choose


def k1_inputs(version, gop, size, nb, seed):
    """K1's inputs on the card for a GOP's first stream repeated to nb
    streams, from a random ring: (ops, resid, ring, F, h, S)."""
    from mobiclipdecoder_tpu_torch import state
    from mobiclipdecoder_tpu_torch.ops.residuals import _residuals
    ops, coefs, sizes = packed_gop(version, [fr[:1] for fr in gop], size)
    ops, coefs, sizes = (np.tile(a, (nb,) + (1,) * (a.ndim - 1))
                         for a in (ops, coefs, sizes))
    nct = ops.shape[1]
    h, S = size[1], width_stride(size[0])
    resid = _residuals(torch.from_numpy(coefs).cuda().view(-1, 64),
                       torch.from_numpy(sizes).cuda().view(-1)
                       ).view(nb, nct, 256, 64)
    ring = np.random.default_rng(seed).integers(
        0, 256, state.ring_shape(nb, h, S)).astype(np.uint8)
    return (torch.from_numpy(ops).cuda(), resid.contiguous(),
            torch.from_numpy(ring).cuda(), len(gop), h, S)


def k1_forms_case(label: str, inputs, smi, reps: int = 20) -> dict:
    """K1's cluster form and its one-block form on the same inputs: their
    frames and rings must be equal; each form's launches; both timed in
    turns behind the spin (median of reps), and the cluster form at each
    size of K1_CLUSTER_SWEEP (a size the card refuses is reported)."""
    from mobiclipdecoder_tpu_torch.ops import executor
    ops_c, res_c, ring_c, nf, h, S = inputs
    out, counts = {}, {}
    for form in ("cluster", "one-block"):
        ring = ring_c.clone()
        zero_counts()
        with k1_form(form):
            frames = executor.run_gop(ops_c, res_c, ring, nf, h, S)
        torch.cuda.synchronize()
        out[form], counts[form] = (frames, ring), read_plane_counts()
    C = executor.cluster_size
    if not (torch.equal(out["cluster"][0], out["one-block"][0])
            and torch.equal(out["cluster"][1], out["one-block"][1])):
        raise AssertionError(f"[k1_forms] {label}: the cluster form's frames "
                             f"or ring != the one-block form's")
    rings = {}

    def call(form, size=None):
        rings[(form, size)] = ring_c.clone()

        def fn():
            with k1_form(form, size):
                executor.run_gop(ops_c, res_c, rings[(form, size)], nf, h, S)
        return fn

    ms = timed_turns({"cluster": call("cluster"),
                      "one-block": call("one-block")}, reps=reps)
    sweep = {}
    for size in K1_CLUSTER_SWEEP:
        try:
            sweep[size] = timed_turns({size: call("cluster", size)},
                                      reps=reps)[size]
        except RuntimeError as e:
            sweep[size] = f"refused ({e})"
    nb = ops_c.shape[0]
    active = executor._active_clusters(ops_c.device, h, S)
    took = executor.cluster_form(nb, h, S, active)
    log(f"[k1_forms] {label} B={nb} F={nf}: cluster form (C={C}; the card "
        f"runs " + ", ".join(f"{n} clusters of {k}" for k, n in
                             active.items())
        + f" at once; the wrapper takes "
        + (f"C={took}" if took else "the one-block form")
        + f") == one-block form, frames and ring; K1 cluster "
        f"{ms['cluster']:.4f} "
        f"ms, one-block {ms['one-block']:.4f} ms (median of {reps} in "
        f"turns, behind the spin), one-block/cluster "
        f"{ms['one-block'] / ms['cluster']:.2f}x; launches (one-block "
        f"smem, one-block global, cluster) {counts['cluster']} and "
        f"{counts['one-block']}; cluster sweep "
        + ", ".join(f"C={k} " + (f"{v:.4f} ms" if isinstance(v, float)
                                 else v) for k, v in sweep.items())
        + f" | {smi}")
    return {"B": nb, "F": nf, "C": C, "took": took, "ms": ms,
            "sweep": sweep, "counts": counts}


def k1_forms_phase(smi, reps: int = 20) -> dict:
    """[k1_forms]: K1 in both forms at the three geometries, on a lone
    I-frame (B=1 F=1, a file's first launch) and on a 24-frame GOP
    repeated to B=8 (the CLI's batch), 16 and 32 (either side of the
    clusters the card runs at once, where the wrapper's choice of form
    turns)."""
    from mobiclipdecoder_tpu_torch.models.oracle_video import MobiclipVersion
    ds, mf = MobiclipVersion.MODS_DS, MobiclipVersion.MOFLEX_3DS
    res = {}
    for size, version in (((W, H), ds), (WIDE[0], mf), (WIDE[1], mf)):
        label = f"{size[0]}x{size[1]}"
        gop = synth_gops(version, [19], 1, F, size)[0]
        for nb, nf in ((1, 1), (B, F), (16, F), (32, F)):
            res[f"{label} B={nb} F={nf}"] = k1_forms_case(
                label, k1_inputs(version, gop[:nf], size, nb, 5), smi, reps)
    return res


# op forms of the executor, by the first op word w0: type w0 & 3 (1 MC,
# 2 residual, 3 intra) and form (w0 >> 2) & 7 (intra: < 5 one block,
# 5 and 6 a luma quad batch, 7 the chroma U+V pair)
OP_FORMS = {
    "MC": lambda t, f: t == 1,
    "residual": lambda t, f: t == 2,
    "intra block": lambda t, f: (t == 3) & (f < 5),
    "intra quad": lambda t, f: (t == 3) & ((f == 5) | (f == 6)),
    "intra pair": lambda t, f: (t == 3) & (f == 7),
}


def op_form_times(inputs) -> dict:
    """Where the executor's time goes by op form: the main-path GOP's
    chunks cut down to the ops of one form (each chunk keeps its own, in
    order; the frames are not checked), timed from a zero ring, as ms and
    ns per op of the longest stream.  "no-op" keeps every op row with its
    type set to 0: what each op costs beyond its work (loop, barrier,
    copies of nothing)."""
    from mobiclipdecoder_tpu_torch.ops.packing import CHUNK
    ops_c, res_c, ring_c, nf, h, S = inputs
    ops = ops_c.cpu().numpy()
    count = np.clip(ops[:, :, 0, 0], 0, CHUNK - 1)
    live = np.arange(1, CHUNK) <= count[..., None]
    w0 = ops[:, :, 1:, 0]
    out = {}
    for name, keep in [("no-op", None), *OP_FORMS.items()]:
        sub = ops.copy()
        if keep is None:
            sub[:, :, 1:, 0] = 0
        else:
            sel = live & keep(w0 & 3, (w0 >> 2) & 7)
            for b, c in zip(*np.nonzero(count > 0)):
                rows = ops[b, c, 1:][sel[b, c]]
                sub[b, c, 1:] = 0
                sub[b, c, 1:1 + len(rows)] = rows
                sub[b, c, 0, 0] = len(rows)
        n = int(np.clip(sub[:, :, 0, 0], 0, CHUNK - 1).sum(axis=1).max())
        ms = time_kernel((torch.from_numpy(sub).cuda(), res_c,
                          torch.zeros_like(ring_c), nf, h, S), reps=10)
        out[name] = {"ms": ms, "ops_per_stream": n,
                     "ns_per_op": ms * 1e6 / max(n, 1)}
    return out


def b_sweep(inputs) -> dict:
    """Kernel ms/GOP with the main-path GOP replicated to each B of
    SWEEP_B streams."""
    return {nb: replicate(inputs, nb) for nb in SWEEP_B}


# ------------------------------------------------------------ prologue
# [prologue]: the bench's sizes at each geometry (DS 256x192 B=8 F=24 is
# the main path's GOP 0; the other two are synthesized in spawned
# processes from the start of the run)
PROLOGUE_WIDE = (((400, 240), 4, 12), ((640, 480), 2, 8))
# integer operations per row of the IDCT pre-pass (csrc/prologue_ops.cuh):
# size 8 is 16 8-point butterflies of 42 operations, the +32 and 64
# shifts; size 4 is 32 4-point butterflies of 10, four +32s and 64 shifts
ROW_OPS = {8: 16 * 42 + 1 + 64, 4: 32 * 10 + 4 + 64}
OPS_PER_NONZERO = 8         # bounds check, int16 decode, address, store
OPS_PER_OP_ROW = 12         # the widening of one packed op row


def prologue_work(blob, nb: int, nct: int, nnzb: int) -> dict:
    """What each prologue kernel must do for this blob: bytes (each input
    read once, each output written once) and operations, and bound_ms,
    the larger of bytes over the memory rate and operations over the
    32-bit rate.  K5 reads the op rows, the size bits and every index
    and value slot, and writes ops and resid; K4 reads coefs and sizes
    and writes resid."""
    from mobiclipdecoder_tpu_torch.ops.packing import CHUNK
    from mobiclipdecoder_tpu_torch.ops.prologue import blob_sections
    ops3, sbits, idx, _v = (t.cpu().numpy() for t in blob_sections(
        torch.from_numpy(np.asarray(blob)), nb, nct, nnzb))
    nrows = nb * nct * CHUNK
    rows64 = nct * CHUNK * 64
    nnz = int(((idx >= 0) & (idx < rows64)).sum())
    n4 = int(np.unpackbits(sbits.view(np.uint8), bitorder="little")[
        :nrows].sum())
    row_ops = n4 * ROW_OPS[4] + (nrows - n4) * ROW_OPS[8]
    return {
        "rows": nrows, "nnz": nnz, "nnzb": nnzb, "size4_rows": n4,
        "sblob": roofline(nrows * (12 + 16 + 256) + sbits.size * 4
                          + nb * nnzb * 6,
                          row_ops + nrows * OPS_PER_OP_ROW
                          + nb * nnzb * OPS_PER_NONZERO),
        "rows_dense": roofline(nrows * (256 + 4 + 256), row_ops)}


def roofline(nbytes: int, nops: int) -> dict:
    """bound_ms: the larger of the bytes over the memory rate and the
    operations over the 32-bit rate, and which of the two it is."""
    tb, to = nbytes / HBM_BYTES_PER_S, nops / OPS_PER_S
    return {"bytes": nbytes, "ops": nops, "bound_ms": max(tb, to) * 1e3,
            "bound_by": "bytes" if tb >= to else "operations"}


def extreme_blob(seed: int):
    """A two-chunk blob of 3 streams from _pack_gop_blob_sparse with random
    op words, sizes and coefficients (int16 extremes included), then pad,
    out-of-range and negative indices: (blob, B, nct, nnzb)."""
    from mobiclipdecoder_tpu_torch.ops import packing
    rng = np.random.default_rng(seed)
    nb, nct = 3, 2
    rows = nct * packing.CHUNK
    ops = rng.integers(0, 1 << 12, (nb, nct, packing.CHUNK, 4)).astype(
        np.int32)
    coefs = rng.integers(-32768, 32768, (nb, nct, packing.CHUNK, 64)).astype(
        np.int32)
    coefs[rng.random(coefs.shape) < 0.9] = 0
    coefs[0, 0, 0, :2] = (-32768, 32767)
    sizes = rng.choice([4, 8], (nb, rows)).astype(np.int32)
    blob, nnzb = packing._pack_gop_blob_sparse(ops, coefs, sizes)
    c = nb * rows * 3 + nb * rows // 32
    blob[c + nnzb - 4:c + nnzb] = (-1, rows * 64 + 1, 2 ** 31 - 1, -(2 ** 31))
    return blob, nb, nct, nnzb


def plain_prologue(blob_d, nb: int, nct: int, nnzb: int):
    """The plain chain on the card: unpack_gop_blob, then _residuals."""
    from mobiclipdecoder_tpu_torch.ops.prologue import unpack_gop_blob
    from mobiclipdecoder_tpu_torch.ops.residuals import _residuals
    ops, coefs, sizes = unpack_gop_blob(blob_d, nb, nct, nnzb)
    resid = _residuals(coefs.reshape(-1, 64), sizes.reshape(-1))
    return ops, resid.view(nb, nct, 256, 64)


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{tuple(a.shape)} {a.dtype} vs "
                             f"{tuple(b.shape)} {b.dtype}")
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


# GPU cycles of the spin that runs ahead of each timed call in [prologue]
# (about 1 ms): the host enqueues the call while the card spins, so a
# kernel of tens of us is timed without the host's launch cost in front
SPIN_CYCLES = 2_000_000


def timed_turns(fns: dict, reps: int = 20, warm: int = 2) -> dict:
    """Median CUDA-event ms of each function, the functions called in
    turns (one call each per round, reps rounds) after warm calls each;
    each call is enqueued behind a spin of SPIN_CYCLES on the card.  A
    function of many launches (the plain chain) still waits for the host
    once the spin has run out: its time is what its launches cost."""
    for fn in fns.values():
        for _ in range(warm):
            fn()
    torch.cuda.synchronize()
    evs = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(SPIN_CYCLES)
            e0.record()
            fn()
            e1.record()
            evs[k].append((e0, e1))
    torch.cuda.synchronize()
    return {k: float(np.median([a.elapsed_time(b) for a, b in v]))
            for k, v in evs.items()}


def prologue_case(label: str, blob: np.ndarray, nb: int, nct: int,
                  nnzb: int, dense=None) -> dict:
    """One blob through the prologue on the card (the wrapper
    unpack_residuals_sblob, one launch of K5) and through the plain chain
    on the card: ops and resid must be equal, exact int32; with the GOP's
    dense arrays, K4 == _residuals too.  Then K5, K4, the wrapper, the
    plain chain and Tensor.scatter_ (the blob's values into a zeroed
    (B, rows * 64 + 1) buffer, the pad clamp done beforehand and untimed;
    the one PyTorch call for the scatter part of K5's work), timed in
    turns."""
    from mobiclipdecoder_tpu_torch.ops import prologue_kernels as pk
    from mobiclipdecoder_tpu_torch.ops.prologue import (
        blob_sections, unpack_gop_blob, unpack_residuals_sblob)
    from mobiclipdecoder_tpu_torch.ops.residuals import _residuals, residuals
    blob_d = torch.from_numpy(blob).cuda()
    ops_k, resid_k = unpack_residuals_sblob(blob_d, nb, nct, nnzb)
    ops_p, resid_p = plain_prologue(blob_d, nb, nct, nnzb)
    err = max(max_err(ops_k, ops_p), max_err(resid_k, resid_p))
    res = {"B": nb, "nct": nct, "nnzb": nnzb}
    if dense is not None:
        coefs_d, sizes_d = (torch.from_numpy(a).cuda() for a in dense[1:])
        rd_k = residuals(coefs_d, sizes_d)
        rd_p = _residuals(coefs_d.view(-1, 64), sizes_d.view(-1)).view(
            rd_k.shape)
        err = max(err, max_err(rd_k, rd_p), max_err(rd_k, resid_k),
                  max_err(ops_k.cpu(), torch.from_numpy(dense[0])))
    if err != 0:
        raise AssertionError(f"[prologue] {label}: kernels != plain chain, "
                             f"max abs err {err}")
    res["max_abs_err"] = err
    if dense is None:
        return res
    ops3, sbits, idx, v32 = blob_sections(blob_d, nb, nct, nnzb)
    ops_o, resid_o = torch.empty_like(ops_k), torch.empty_like(resid_k)
    rd_o = torch.empty_like(rd_k)
    flat_c, flat_s = coefs_d.view(-1, 64), sizes_d.view(-1)
    rows64 = nct * 256 * 64
    sidx = idx.long()
    sidx = torch.where((sidx < 0) | (sidx > rows64), rows64, sidx)
    sval = torch.stack([((v32 & 0xFFFF) ^ 0x8000) - 0x8000, v32 >> 16],
                       dim=2).view(nb, nnzb)
    sdense = torch.zeros((nb, rows64 + 1), dtype=torch.int32,
                         device=blob_d.device)
    res["ms"] = timed_turns({
        "sblob": lambda: pk.prologue_sblob(ops3, sbits, idx, v32,
                                           ops_o.view(-1, 4),
                                           resid_o.view(-1, 64)),
        "rows_dense": lambda: pk.residual_rows(flat_c, flat_s,
                                               rd_o.view(-1, 64)),
        "kernel_chain": lambda: unpack_residuals_sblob(blob_d, nb, nct,
                                                       nnzb),
        "scatter_": lambda: sdense.scatter_(1, sidx, sval),
        "plain_unpack": lambda: unpack_gop_blob(blob_d, nb, nct, nnzb),
        "plain_residuals": lambda: _residuals(flat_c, flat_s),
        "plain_chain": lambda: plain_prologue(blob_d, nb, nct, nnzb)})
    if not (torch.equal(sdense[:, :rows64], coefs_d.view(nb, -1))
            and torch.equal(resid_o, resid_k)):
        raise AssertionError(f"[prologue] {label}: the timed calls' "
                             f"results differ")
    res["work"] = prologue_work(blob, nb, nct, nnzb)
    return res


def prologue_phase(ds, main_gop, wide_futs, smi) -> dict:
    """[prologue]: K5 == the plain chain on the card, exact int32, on the
    blobs of the three geometries at the bench's sizes (and K4 on their
    dense arrays), and on a blob of int16 extremes with pad, out-of-range
    and negative indices; each kernel's time and bound, the plain chain's
    time and Tensor.scatter_'s."""
    from mobiclipdecoder_tpu_torch.models.oracle_video import MobiclipVersion
    from mobiclipdecoder_tpu_torch.ops.packing import (_assemble_gop_parts,
                                                       _part_dense_arrays)
    mf = MobiclipVersion.MOFLEX_3DS
    out = {}
    with phase("prologue"):
        cases = [(f"{W}x{H}", ds, main_gop, (W, H))]
        cases += [(f"{size[0]}x{size[1]}", mf, wide_futs[size].result()[0],
                   size) for size, _nb, _nf in PROLOGUE_WIDE]
        for label, version, gop, size in cases:
            parts = scanned_parts(version, gop, size)
            blob, nct, nnzb = _assemble_gop_parts(parts)
            r = prologue_case(label, blob, len(parts), nct, nnzb,
                              _part_dense_arrays(parts))
            r["F"] = len(gop)
            out[label] = r
            ms, wk = r["ms"], r["work"]
            log(f"[prologue] {label} B={r['B']} F={r['F']} nct={nct} "
                f"({wk['rows']} rows, {wk['nnz']} nonzeros of nnzb "
                f"{nnzb} per stream): K5 == unpack_gop_blob + _residuals "
                f"on the card, and K4 == _residuals, exact int32 (max abs "
                f"err 0); median of 20 in turns, CUDA events: K5 "
                f"{ms['sblob']:.4f} ms (bound "
                f"{wk['sblob']['bound_ms'] * 1e3:.2f} us, "
                f"{wk['sblob']['bound_by']}, "
                f"{wk['sblob']['bound_ms'] / ms['sblob']:.3f} of it), K4 "
                f"{ms['rows_dense']:.4f} ms (bound "
                f"{wk['rows_dense']['bound_ms'] * 1e3:.2f} us); the wrapper "
                f"(K5) {ms['kernel_chain']:.4f} ms vs the plain chain "
                f"{ms['plain_chain']:.4f} ms (unpack "
                f"{ms['plain_unpack']:.4f} + _residuals "
                f"{ms['plain_residuals']:.4f}); Tensor.scatter_ of the "
                f"values {ms['scatter_']:.4f} ms | {smi}")
        blob, nb, nct, nnzb = extreme_blob(17)
        out["extremes"] = prologue_case("extremes", blob, nb, nct, nnzb)
        log(f"[prologue] int16 extremes, pad, out-of-range and negative "
            f"indices (B={nb}, nct={nct}): K5 == the plain chain, "
            f"exact int32 | {smi}")
    return out


STAGE_NAMES = ("host scan", "assemble blob", "upload blob",
               "prologue (K5)", "executor", "download", "plain unpack blob",
               "plain residuals")
DEVICE_STAGES = ("prologue (K5)", "executor", "download")


def stage_breakdown(version, gop, reps=10) -> dict:
    """Median ms of each stage of one fused GOP dispatch (B streams, F
    frames), run stage by stage with a sync between stages: host stages
    on the host clock, device stages with CUDA events.  The prologue runs
    as the decode runs it (unpack_residuals_sblob: one launch of K5); the
    plain chain's two stages (unpack_gop_blob, _residuals) run after it
    on the same blob, in each repetition, and are not part of the
    dispatch."""
    from mobiclipdecoder_tpu_torch.ops import executor
    from mobiclipdecoder_tpu_torch.ops.packing import (_assemble_gop_parts,
                                                       _gop_part)
    from mobiclipdecoder_tpu_torch.ops.prologue import (
        crop_frames, unpack_gop_blob, unpack_residuals_sblob)
    from mobiclipdecoder_tpu_torch.ops.residuals import _residuals
    from mobiclipdecoder_tpu_torch.ops.vmem_engine import VmemBatchDecoder
    dec = VmemBatchDecoder(W, H, version, batch=B, native=True,
                           device="cuda")
    per = [[fr[b] for fr in gop] for b in range(B)]
    hhs = H + H // 2
    host = torch.empty((F, B, hhs, 256), dtype=torch.uint8, pin_memory=True)
    names = STAGE_NAMES
    times = {k: [] for k in names}
    for _ in range(reps):
        for nv in dec.natives:
            nv.checkpoint()
        t0 = time.perf_counter()
        res = list(dec._pool.map(
            lambda b: dec.natives[b].scan_gop_packed(per[b]), range(B)))
        t1 = time.perf_counter()
        for nv in dec.natives:
            nv.rollback()
        blob, nct, nnzb = _assemble_gop_parts([_gop_part(r) for r in res])
        t2 = time.perf_counter()
        blob_d = dec._upload(blob)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        ev[0].record()
        ops, resid = unpack_residuals_sblob(blob_d, B, nct, nnzb)
        ev[1].record()
        frames = executor.run_gop(ops, resid, dec.ring, F, H, 256)
        ev[2].record()
        host.copy_(crop_frames(frames, H, 256), non_blocking=True)
        ev[3].record()
        torch.cuda.synchronize()
        ev[4].record()
        _o, coefs, sizes = unpack_gop_blob(blob_d, B, nct, nnzb)
        ev[5].record()
        _residuals(coefs.reshape(-1, 64), sizes.reshape(-1))
        ev[6].record()
        torch.cuda.synchronize()
        for k, v in zip(names, [(t1 - t0) * 1e3, (t2 - t1) * 1e3,
                                (t3 - t2) * 1e3]
                        + [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
                        + [ev[i].elapsed_time(ev[i + 1]) for i in (4, 5)]):
            times[k].append(v)
    return {k: float(np.median(v)) for k, v in times.items()}


def sustained(version, gops, windows=3) -> list[float]:
    """decode_gops frames/s over `windows` runs of SUSTAIN_GOPS GOPs (the
    synthesized GOPs in turn), each after a one-GOP warm-up.  Every GOP
    must take exactly one executor launch (no split, no plan fallback)."""
    from mobiclipdecoder_tpu_torch.ops import executor
    from mobiclipdecoder_tpu_torch.ops.vmem_engine import VmemBatchDecoder
    rates = []
    for _ in range(windows):
        dec = VmemBatchDecoder(W, H, version, batch=B, native=True,
                               device="cuda")
        list(dec.decode_gops(iter(gops[:1])))
        n0 = executor.launches
        t0 = time.perf_counter()
        n = 0
        for out in dec.decode_gops(gops[g % len(gops)]
                                   for g in range(SUSTAIN_GOPS)):
            if out.shape != (F, B, H + H // 2, 256):
                raise AssertionError(f"sustained: shape {out.shape}")
            n += 1
        rates.append(n * F * B / (time.perf_counter() - t0))
        if n != SUSTAIN_GOPS or executor.launches - n0 != SUSTAIN_GOPS:
            raise AssertionError(f"sustained: {n} GOPs took "
                                 f"{executor.launches - n0} launches")
    return rates


def surface_streams(version, size):
    """The format-surface streams of the JAX package's on-chip verify
    (tools/verify_onchip.py): default, VLC table 1 with a dQP ladder, the
    Moflex QP-clamp edges, and big escape levels (the dense upload)."""
    from mobiclipdecoder_tpu_torch.testing.synth import StreamSynthesizer
    s1 = StreamSynthesizer(*size, version, seed=1234)
    s2 = StreamSynthesizer(*size, version, seed=77)
    s3 = StreamSynthesizer(*size, version, seed=78)
    s4 = StreamSynthesizer(*size, version, seed=79, big_levels=0.3)
    return {
        "default": [s1.iframe(0x18) if i == 0 else s1.pframe()
                    for i in range(6)],
        "table1+dqp": [s2.iframe(0x18, table=1), s2.pframe(dq=2),
                       s2.pframe(dq=-1), s2.pframe(dq=3)],
        "qp-clamp": [s3.iframe(2), s3.pframe(dq=-3),
                     s3.iframe(0x3F, table=1), s3.pframe(dq=7)],
        "big-levels": [s4.iframe(0x18), s4.pframe()],
    }


def format_surface(version, size) -> int:
    """decode_stream_chunk on the card == oracle for every surface
    stream, through one decoder (each stream starts with an I-frame).
    Returns the frames checked."""
    from mobiclipdecoder_tpu_torch.ops.vmem_engine import VmemVideoDecoder
    dec = VmemVideoDecoder(*size, version, native=True, device="cuda")
    n = 0
    for name, pkts in surface_streams(version, size).items():
        yuv, offs, err = dec.decode_stream_chunk(pkts)
        if err is not None or offs != [len(p) for p in pkts]:
            raise AssertionError(f"{size} {name}: err {err}, offsets {offs}")
        exp = oracle_frames(version, pkts, size)
        if yuv.shape != exp.shape or not (yuv == exp).all():
            bad = np.argwhere((yuv != exp).any(axis=(1, 2))).ravel()
            raise AssertionError(f"{size} {name}: frames {bad.tolist()} "
                                 f"differ from the oracle")
        n += len(pkts)
    return n


# ------------------------------------------------------------ containers
def ima_packets(nframes, channels, key_at):
    """Per-frame IMA ADPCM audio packets of a MODS file: each channel's
    stream restarts at every keyframe, the first packet of a segment
    carrying its 4-byte state header."""
    from mobiclipdecoder_tpu_torch.models.audio_ima import encode_ima
    segments = sorted(key_at) + [nframes]
    per_frame = [[] for _ in range(nframes)]
    for s in range(len(segments) - 1):
        f0, f1 = segments[s], segments[s + 1]
        for c in range(channels):
            t = np.arange((f1 - f0) * 256) + f0 * 256
            blob = encode_ima((4000 * np.sin(t / (5 + c))).astype(np.int16),
                              index0=8)
            hdr, body = blob[:4], blob[4:]
            for i in range(f1 - f0):
                chunk = body[i * 128:(i + 1) * 128]
                chunk = chunk + bytes(128 - len(chunk))
                per_frame[f0 + i].append((hdr + chunk) if i == 0 else chunk)
    return per_frame


def mods_container(nframes, seed, key_at) -> bytes:
    """DS MODS 256x192 with 2-channel IMA audio, keyframes at `key_at`."""
    from mobiclipdecoder_tpu_torch.containers.mods import ModsMuxer
    from mobiclipdecoder_tpu_torch.models.oracle_video import MobiclipVersion
    from mobiclipdecoder_tpu_torch.testing.synth import StreamSynthesizer
    synth = StreamSynthesizer(W, H, MobiclipVersion.MODS_DS, seed=seed)
    mux = ModsMuxer(W, H, fps=24.0, audio_codec=3, nb_channel=2,
                    frequency=16384)
    audio = ima_packets(nframes, 2, key_at)
    for i in range(nframes):
        if i in key_at:
            video = synth.iframe(0x18, pad=False)
            synth.frame_idx = 1         # P-frames restart their references
        else:
            video = synth.pframe(pad=False)
        mux.add_frame(video, audio[i], keyframe=i in key_at)
    return mux.to_bytes()


def moflex_container(nframes, seed, size) -> bytes:
    """Moflex with one video stream and 2-channel IMA audio."""
    from mobiclipdecoder_tpu_torch.containers.moflex import (
        AudioStream, MoflexMuxer, VideoStream)
    from mobiclipdecoder_tpu_torch.models.audio_ima import encode_ima
    from mobiclipdecoder_tpu_torch.models.oracle_video import MobiclipVersion
    from mobiclipdecoder_tpu_torch.testing.synth import StreamSynthesizer
    synth = StreamSynthesizer(*size, MobiclipVersion.MOFLEX_3DS, seed=seed)
    mux = MoflexMuxer([
        VideoStream(stream_index=0, codec_id=0, fps_rate=24, fps_scale=1,
                    width=size[0], height=size[1]),
        AudioStream(stream_index=1, codec_id=1, frequency=16384,
                    channels=2)])
    for i in range(nframes):
        mux.add_frame(0, synth.iframe(0x18, pad=False) if i == 0
                      else synth.pframe(pad=False))
        frame, bodies = bytearray(), []
        for c in range(2):
            t = np.arange(512) + i * 512
            blob = encode_ima((3000 * np.sin(t / (6 + c))).astype(np.int16),
                              index0=4)
            frame += blob[:4]
            bodies.append(blob[4:4 + 256])
        for k in range(0, 256, 128):
            for c in range(2):
                frame += bodies[c][k:k + 128]
        mux.add_frame(1, bytes(frame))
    return mux.to_bytes()


def fa_rounds(f: int, rate: int = 32728, fps: int = 24) -> int:
    """The 256-sample rounds of FastAudio that frame f's chunk carries,
    a channel: the whole rounds up to frame f + 1's start less those up
    to frame f's."""
    return (f + 1) * rate // (256 * fps) - f * rate // (256 * fps)


def moflex_fastaudio_container(nframes, seed, size) -> bytes:
    """Moflex with one video stream and 2-channel FastAudio (codec 0) at
    32,728 Hz: frame f's chunk of fa_rounds(f) rounds of random 40-byte
    packets (any bits decode) muxed before its video, so every frame
    carries FastAudio."""
    from mobiclipdecoder_tpu_torch.containers.moflex import (
        AudioStream, MoflexMuxer, VideoStream)
    from mobiclipdecoder_tpu_torch.models.oracle_video import MobiclipVersion
    from mobiclipdecoder_tpu_torch.testing.synth import StreamSynthesizer
    synth = StreamSynthesizer(*size, MobiclipVersion.MOFLEX_3DS, seed=seed)
    rng = np.random.default_rng(seed)
    mux = MoflexMuxer([
        VideoStream(stream_index=0, codec_id=0, fps_rate=24, fps_scale=1,
                    width=size[0], height=size[1]),
        AudioStream(stream_index=1, codec_id=0, frequency=32728,
                    channels=2)])
    for i in range(nframes):
        mux.add_frame(1, rng.integers(0, 256, 80 * fa_rounds(i),
                                      np.uint8).tobytes())
        mux.add_frame(0, synth.iframe(0x18, pad=False) if i == 0
                      else synth.pframe(pad=False))
    return mux.to_bytes()


def moc5_container(nframes, seed, size) -> bytes:
    from mobiclipdecoder_tpu_torch.containers.moc5 import Moc5Muxer
    from mobiclipdecoder_tpu_torch.models.oracle_video import MobiclipVersion
    from mobiclipdecoder_tpu_torch.testing.synth import StreamSynthesizer
    synth = StreamSynthesizer(*size, MobiclipVersion.MOFLEX_3DS, seed=seed)
    mux = Moc5Muxer(*size, fps=30.0)
    for i in range(nframes):
        mux.add_frame(synth.iframe(0x18) if i == 0 else synth.pframe())
    return mux.to_bytes()


def cli(argv) -> dict:
    """`python -m mobiclipdecoder_tpu_torch <argv>` in this process;
    returns the JSON stats it prints."""
    from mobiclipdecoder_tpu_torch.__main__ import main as cli_main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    if rc != 0:
        raise AssertionError(f"{argv}: exit {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def transcode_case(tmp: Path, name: str, blob: bytes, suffix: str,
                   size, ima_chunks: int, fa_chunks: int = 0) -> dict:
    """Decode one container of frame size ``size`` with the CLI, engine
    cuda (the default) and oracle; every output file's bytes must be
    equal, the cuda engine must launch K9 once for each of the
    ``ima_chunks`` launches whose frames carry IMA audio and K8 once for
    each of the ``fa_chunks`` launches whose frames carry FastAudio, and
    the launches must follow the transcoder's schedule
    (``launch_lengths``): every one shorter than CHUNK_FRAMES but the last
    counted in ``ramp_launches``."""
    from mobiclipdecoder_tpu_torch.runtime.metrics import TOTALS
    w, h = size
    src = tmp / f"{name}{suffix}"
    src.write_bytes(blob)
    zero_counts()
    ramp0 = TOTALS.ramp_launches
    st = cli(["decode", str(src), str(tmp / f"{name}_cuda")])
    launches = read_counts()
    pro = read_prologue_counts()
    _sad, fa, ima = read_side_counts()
    ramp = TOTALS.ramp_launches - ramp0
    if sum(launches) < 1:
        raise AssertionError(f"{name}: the cuda engine launched no kernel")
    if ima != ima_chunks:
        raise AssertionError(f"{name}: {ima} K9 launches for {ima_chunks} "
                             f"launches that carry IMA audio")
    if fa != fa_chunks:
        raise AssertionError(f"{name}: {fa} K8 launches for {fa_chunks} "
                             f"launches that carry FastAudio")
    schedule = launch_lengths(TRANSCODE_FRAMES)
    if (sum(launches) != len(schedule) or launches[1] != schedule.count(1)
            or ramp != sum(n < CHUNK_FRAMES for n in schedule[:-1])):
        raise AssertionError(f"{name}: launches {launches}, ramp_launches "
                             f"{ramp} for the schedule {schedule}")
    planes = check_plane_form(name, h, width_stride(w))
    so = cli(["decode", str(src), str(tmp / f"{name}_oracle"), "--engine",
              "oracle"])
    outs = {}
    for eng in ("cuda", "oracle"):
        outs[eng] = {p.suffix: p.read_bytes()
                     for p in sorted(tmp.glob(f"{name}_{eng}.*"))}
    if sorted(outs["cuda"]) != sorted(outs["oracle"]) or not outs["cuda"]:
        raise AssertionError(f"{name}: outputs {sorted(outs['cuda'])} vs "
                             f"{sorted(outs['oracle'])}")
    for ext, data in outs["cuda"].items():
        if data != outs["oracle"][ext]:
            raise AssertionError(f"{name}: {ext} bytes differ from the "
                                 f"oracle engine's")
    if st["frames"] != so["frames"] or st["frames"] != TRANSCODE_FRAMES:
        raise AssertionError(f"{name}: {st['frames']} vs {so['frames']}")
    return {"stats": st, "oracle": so, "launches": launches,
            "prologue": pro, "ima_launches": ima, "fa_launches": fa,
            "ramp_launches": ramp,
            "planes": planes, "src": src, "oracle_bytes": outs["oracle"],
            "files": {k: len(v) for k, v in outs["cuda"].items()}}


# ------------------------------------------------- wavefront, encode, audio
def oracle_task(version: int, size, packets) -> np.ndarray:
    """oracle_frames in a pool process (one host thread)."""
    from mobiclipdecoder_tpu_torch.models.oracle_video import MobiclipVersion
    torch.set_num_threads(1)
    return oracle_frames(MobiclipVersion(version), packets, size)


def encoder_frames(size, n=ENC_FRAMES):
    """The frames of the JAX package's on-chip verify's encoder case
    (tools/verify_onchip.py): a moving sine pattern with noise."""
    w, h = size
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for f in range(n):
        y = (128 + 60 * np.sin(xx / 11 + f / 2) * np.cos(yy / 7)
             + rng.normal(0, 4, (h, w))).clip(0, 255).astype(np.uint8)
        u = (128 + 40 * np.sin(xx[::2, ::2] / 13)).clip(0, 255).astype(
            np.uint8)
        v = (128 + 40 * np.cos(yy[::2, ::2] / 9)).clip(0, 255).astype(
            np.uint8)
        out.append((y, u, v))
    return out


def encode_task(size, device: str):
    """Encode encoder_frames(size) in the Moflex profile on ``device``;
    returns (packets + 2 pad bytes each, each frame's SAD volume or None,
    seconds)."""
    from mobiclipdecoder_tpu_torch.models.encoder import MobiclipEncoder
    from mobiclipdecoder_tpu_torch.models.oracle_video import MobiclipVersion
    if device == "cpu":
        torch.set_num_threads(1)
    enc = MobiclipEncoder(*size, MobiclipVersion.MOFLEX_3DS, device=device,
                          **ENC)
    pkts, vols = [], []
    t0 = time.perf_counter()
    for y, u, v in encoder_frames(size):
        enc._sadvol = None
        pkts.append(enc.encode_frame(y, u, v) + b"\x00\x00")
        vols.append(None if enc._sadvol is None else enc._sadvol.vol)
    return pkts, vols, time.perf_counter() - t0


def device_launches(fn) -> tuple[int | None, str]:
    """(device activities (kernels, copies, fills) that torch.profiler sees
    while fn() runs, or None, and why not).  fn() runs either way; a
    profiler that cannot trace leaves the count unmeasured.  The trace
    takes CPU and CUDA activity, as [trace]'s does."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    try:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
    except (RuntimeError, AssertionError) as e:
        fn()
        return None, f"the profiler did not start: {e}"
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        prof.__exit__(None, None, None)
    n = sum(len(v) for v in device_intervals(prof.events()).values())
    return (n, "") if n else (None, "the profiler saw no device activity")


def gop_activities_task(gop) -> tuple:
    """In a spawned process, where no profiler session ran before: the
    device activities of a BatchVideoDecoder's decode_gop of one DS
    256x192 GOP (gop[f][b] the packets), after one warm GOP on another
    decoder (builds loaded, K6's tables uploaded).  (count, why not)."""
    from mobiclipdecoder_tpu_torch.models.oracle_video import MobiclipVersion
    from mobiclipdecoder_tpu_torch.parallel.batch import BatchVideoDecoder
    ds = MobiclipVersion.MODS_DS
    nb = len(gop[0])
    BatchVideoDecoder(W, H, ds, batch=nb, native=True,
                      device="cuda").decode_gop(gop)
    pd = BatchVideoDecoder(W, H, ds, batch=nb, native=True, device="cuda")
    return device_launches(lambda: pd.decode_gop(gop))


def write_y4m(path: Path, size, n: int) -> None:
    from mobiclipdecoder_tpu_torch.utils.rawio import Y4MWriter
    wr = Y4MWriter(path, *size, 24.0)
    for y, u, v in encoder_frames(size, n):
        wr.add_frame(y, u, v)
    wr.close()


def wavefront_work(rounds: list[dict], h: int, S: int) -> dict:
    """What K6 must do for these frame rounds (BatchVideoDecoder.
    scan_packets() host arrays, one per round).  ``bytes``: each input read
    once (the MC, residual and intra rows in use, each stream's sequence
    map and level count, the ring samples its MC leaves need: the block
    plus a row and a column where the half-pel case reads them) and each
    output written once (each stream's frame into its ring slot, int32,
    and into the uint8 frames).  ``ops``: the pixels the
    rows write, one operation each at least.  ``bound_ms`` is the larger of
    bytes over the memory rate and ops over the 32-bit rate.  ``levels``:
    each round's serial depth, the deepest stream's intra levels."""
    nbytes = nops = 0
    levels = []
    for r in rounds:
        mc = r["mc"].astype(np.int64)
        nb = mc.shape[0]
        _y, _x, w, hh, _ref, dx, dy = np.moveaxis(mc, -1, 0)
        live = w > 0
        cw, ch = w >> 1, hh >> 1
        chroma = np.where((cw > 0) & (ch > 0),
                          2 * (ch + ((dy >> 1) & 1)) * (cw + ((dx >> 1) & 1)),
                          0)
        samples = np.where(live, (hh + (dy & 1)) * (w + (dx & 1)) + chroma,
                           0)
        rsize = r["resid"][..., 3].astype(np.int64)
        nl = np.minimum(r["n_levels"].reshape(nb), r["iops"].shape[1])
        isize = r["iops"][..., 3].astype(np.int64)
        ilive = (isize > 0) & (np.arange(r["iops"].shape[1])[None, :, None]
                               < nl[:, None, None])
        nbytes += (4 * (7 * int(live.sum()) + int(samples.sum())
                        + 68 * int((rsize > 0).sum())
                        + 75 * int(ilive.sum()) + r["seqmap"].size + nb
                        + nb * (h + h // 2) * S)
                   + nb * (h + h // 2) * S)
        nops += (int(np.where(live, w * hh + 2 * cw * ch, 0).sum())
                 + int(np.where(rsize > 0, rsize ** 2, 0).sum())
                 + int(np.where(ilive, isize ** 2, 0).sum()))
        levels.append(int(nl.max()))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": nops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "levels": levels}


def wavefront_variants(rounds: list[dict]) -> dict[str, list[dict]]:
    """The inputs of K6's phase split, from a GOP's frame rounds
    (scan_packets() host arrays): the GOP; its I-frame round and its
    P-frame rounds alone (for a GOP of several rounds); every round with
    n_levels 0 (the zero fill, MC and the residuals left); every round
    with its MC and residual rows of size 0 (the intra levels left)."""
    def no_levels(r):
        return dict(r, n_levels=np.zeros_like(r["n_levels"]))

    def levels_only(r):
        mc, resid = r["mc"].copy(), r["resid"].copy()
        mc[..., 2] = 0
        resid[..., 3] = 0
        return dict(r, mc=mc, resid=resid)

    out = {"gop": rounds}
    if len(rounds) > 1:
        out.update(iframe=rounds[:1], pframes=rounds[1:])
    out.update(no_levels=[no_levels(r) for r in rounds],
               levels_only=[levels_only(r) for r in rounds])
    return out


def wavefront_split(run, rounds: list[dict], device, reps: int = 5) -> dict:
    """ms of ``run(plans)`` on the GopPlans of each of
    wavefront_variants(rounds), timed in turns behind the spin (median of
    ``reps``)."""
    from mobiclipdecoder_tpu_torch.ops.wavefront_kernels import upload_gop
    ups = {k: upload_gop(v, device)
           for k, v in wavefront_variants(rounds).items()}
    return timed_turns({k: (lambda u=u: run(u)) for k, u in ups.items()},
                       reps=reps, warm=1)


CLUSTER_SWEEP = (1, 2, 4, 8)


def wavefront_kernel_check(ds, mf, main_gop, wide_gop, smi) -> dict:
    """K6 == the plain version on the card, exact int32, for GOP 0 of the
    main path (DS B=8 F=24) and a Moflex 640x480 I-frame (B=1, ``wide_gop``
    [[packet]]): one K6 launch from a random ring at head 2, its frames
    round by round (int32 and uint8) and its final ring against
    decode_frame_core_plain's rounds; then K6 (one launch per GOP) and the
    plain round loop (decode_gop_plain) timed in turns (median of 3
    CUDA-event times, each call behind the spin), beside K6's bound; K6's
    phase split (wavefront_split) and the cluster sweep (C over
    CLUSTER_SWEEP, in turns, median of 5)."""
    from mobiclipdecoder_tpu_torch.models.pipeline import (
        decode_frame_core_plain, decode_gop_plain)
    from mobiclipdecoder_tpu_torch.ops import wavefront_kernels as wk
    from mobiclipdecoder_tpu_torch.parallel.batch import BatchVideoDecoder
    res = {}
    cluster = wk.CLUSTER
    for version, size, gop in ((ds, (W, H), main_gop),
                               (mf, WIDE[1], wide_gop)):
        label = f"{size[0]}x{size[1]}"
        bd = BatchVideoDecoder(*size, version, batch=len(gop[0]), native=True,
                               device="cuda")
        rounds = [bd.scan_packets(fp) for fp in gop]
        plans = wk.upload_gop(rounds, bd.device)
        h, S = size[1], bd.stride
        ring0 = torch.from_numpy(np.random.default_rng(12).integers(
            0, 256, tuple(bd.rings[0].shape)).astype(np.int32)).cuda()

        zero_counts()
        ring = ring0.clone()
        got8, got32 = wk.wavefront_gop(ring, 2, plans, h, S, frames32=True)
        launches = read_wavefront_count()
        want = ring0.clone()
        err = 0
        for f, t in enumerate(plans.rounds):
            hd = (2 + 5 * (f + 1)) % 6
            buf = decode_frame_core_plain(
                torch.roll(want, -hd, dims=1), t["mc"], t["resid"],
                t["resid_coef"], t["iops"], t["icoef"], t["seqmap"],
                t["n_levels"], h, S)
            want[:, hd] = buf
            err = max(err, max_err(got32[f], buf),
                      max_err(got8[f], buf.to(torch.uint8)))
        err = max(err, max_err(ring, want))
        if err != 0 or launches != 1:
            raise AssertionError(f"[wavefront] K6 {label}: max abs err "
                                 f"{err} against the plain version, "
                                 f"{launches} launches for one GOP")
        rk, rp = ring0.clone(), ring0.clone()
        ms = timed_turns(
            {"k6": lambda: wk.wavefront_gop(rk, 0, plans, h, S),
             "plain": lambda: decode_gop_plain(rp, 0, plans.rounds, h, S)},
            reps=3, warm=1)
        work = wavefront_work(rounds, h, S)
        split = wavefront_split(
            lambda u: wk.wavefront_gop(rk, 0, u, h, S), rounds, bd.device)
        log(f"[wavefront] K6 phase split {label}, ms (median of 5 in turns, "
            f"behind the spin): " + ", ".join(f"{k} {v:.4f}"
                                              for k, v in split.items())
            + f" | {smi}")

        def at(c):
            wk.CLUSTER = c
            wk.wavefront_gop(rk, 0, plans, h, S)

        try:
            sweep = timed_turns({f"C={c}": (lambda c=c: at(c))
                                 for c in CLUSTER_SWEEP}, reps=5, warm=1)
        finally:
            wk.CLUSTER = cluster
        log(f"[wavefront] K6 cluster sweep {label}, ms per GOP (median of 5 "
            f"in turns, behind the spin): " + ", ".join(
                f"{k} {v:.4f}" for k, v in sweep.items())
            + f"; the kernel's constant C={cluster} | {smi}")
        res[label] = {"B": len(gop[0]), "F": len(gop), "max_abs_err": err,
                      "ms": ms["k6"], "plain_ms": ms["plain"],
                      "split": split, "cluster_sweep": sweep, **work}
        log(f"[wavefront] K6 == the plain version on the card, frame round "
            f"by frame round and the ring, {label} B={len(gop[0])} "
            f"F={len(gop)} in one launch (levels per round "
            f"{work['levels'][:4]}{'...' if len(gop) > 4 else ''}): K6 "
            f"{ms['k6']:.4f} ms vs plain {ms['plain']:.1f} ms per GOP "
            f"(median of 3 in turns, behind the spin); bound "
            f"{work['bound_ms'] * 1e3:.2f} us ({work['bound_by']}: "
            f"{work['bytes'] / 1e6:.2f} MB), K6/bound "
            f"{ms['k6'] / work['bound_ms']:.0f}x | {smi}")
    return res


def wavefront_phase(ds, gops, k1_outs, main_oracle, oracle_futs, wide_pkts,
                    wide_futs, trans, smi) -> dict:
    """[wavefront]: K6 == the plain version on the card and both timed
    (wavefront_kernel_check); the main path's streams through
    BatchVideoDecoder on the card == the oracle and the executor's frames;
    WavefrontVideoDecoder at the wide sizes == oracle; the CLI's wavefront
    engine == oracle bytes.  Each path's K6 launches, counted from 0."""
    from mobiclipdecoder_tpu_torch.models.pipeline import (
        WavefrontVideoDecoder)
    from mobiclipdecoder_tpu_torch.parallel.batch import BatchVideoDecoder
    from mobiclipdecoder_tpu_torch.models.oracle_video import MobiclipVersion
    mf = MobiclipVersion.MOFLEX_3DS
    res = {"launches": {}}
    with phase("wavefront"):
        res["kernel"] = wavefront_kernel_check(
            ds, mf, gops[0], [[wide_pkts[WIDE[1]][0]]], smi)
        bd = BatchVideoDecoder(W, H, ds, batch=B, native=True, device="cuda")
        zero_counts()
        wf, ms, wall = [], [], []
        for g in range(NGOPS):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            e0.record()
            wf.append(bd.decode_gop(gops[g]))
            e1.record()
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
            ms.append(e0.elapsed_time(e1))
        # one K6 launch per GOP (one shard)
        res["launches"]["batch"] = read_wavefront_count()
        if res["launches"]["batch"] != NGOPS:
            raise AssertionError(f"[wavefront] BatchVideoDecoder: "
                                 f"{res['launches']['batch']} K6 launches "
                                 f"for {NGOPS} GOPs")
        for g in range(NGOPS):
            if wf[g].shape != k1_outs[g].shape or not (
                    wf[g] == k1_outs[g]).all():
                bad = np.argwhere((wf[g] != k1_outs[g]).any(axis=(2, 3)))
                raise AssertionError(f"wavefront GOP {g}: (frame, stream) "
                                     f"{bad[:8].tolist()} differ from the "
                                     f"executor's")
        t0 = time.perf_counter()
        for b in range(B):
            exp = main_oracle[b] if b in main_oracle else oracle_futs[
                b].result()
            got = np.concatenate([wf[g][:, b] for g in range(NGOPS)])
            bad = np.argwhere((got != exp).any(axis=(1, 2))).ravel()
            if bad.size:
                raise AssertionError(f"wavefront stream {b}: frames "
                                     f"{bad.tolist()} differ from the oracle")
        t_wait = time.perf_counter() - t0
        # levels per frame round (the loop runs the deepest stream's)
        probe = BatchVideoDecoder(W, H, ds, batch=B, native=True,
                                  device="cpu")
        levels = [int(probe.scan_packets(fp)["n_levels"].max())
                  for fp in gops[0]]
        # device activities of one decode_gop of GOP 0, in a fresh
        # process: at this point of a whole run, a profiler session in this
        # process records no device events on the card, while one in a
        # fresh process does
        with _cf.ProcessPoolExecutor(
                1, mp_context=multiprocessing.get_context("spawn")) as one:
            acts, why = one.submit(gop_activities_task, gops[0]).result()
        # one upload, one K6 launch and one download per GOP and shard
        if acts is not None and acts > 4:
            raise AssertionError(f"[wavefront] device activities per GOP: "
                                 f"{acts}")
        res["main"] = {
            "shape": f"B={B} F={F} {W}x{H}", "ms_per_gop": ms,
            "wall_s_per_gop": wall,
            "frames_per_s": [B * F / w for w in wall],
            "levels_per_frame_round": float(np.mean(levels)),
            "levels_iframe": levels[0],
            "levels_first_4": levels[:4],
            "device_activities_per_gop": acts}
        log(f"[wavefront] BatchVideoDecoder.decode_gop B={B} {NGOPS}x{F} "
            f"frames == the executor's frames and the oracle on all {B} "
            f"streams (oracle wait {t_wait:.1f} s); ms per GOP (CUDA events) "
            + ", ".join(f"{m:.1f}" for m in ms) + "; wall s per GOP "
            + ", ".join(f"{w:.4f}" for w in wall) + "; frames/s "
            + ", ".join(f"{B * F / w:.1f}" for w in wall)
            + f"; intra levels per frame round {np.mean(levels):.1f} "
            f"(I-frame {levels[0]}); K6 launches {res['launches']['batch']}"
            f"; device activities per GOP "
            + (f"not measured ({why})" if acts is None
               else f"{acts}, torch.profiler")
            + f" | {smi}")
        for size, pkts in wide_pkts.items():
            dec = WavefrontVideoDecoder(*size, mf, native=True, device="cuda")
            zero_counts()
            t0 = time.perf_counter()
            got = np.stack([np.concatenate(dec.decode_frame(p))
                            for p in pkts])
            t_dec = time.perf_counter() - t0
            wlabel = f"decoder_{size[0]}x{size[1]}"
            res["launches"][wlabel] = read_wavefront_count()
            if res["launches"][wlabel] != len(pkts):
                raise AssertionError(f"[wavefront] {wlabel}: "
                                     f"{res['launches'][wlabel]} K6 launches "
                                     f"for {len(pkts)} frames")
            exp = wide_futs[size].result()
            if got.shape != exp.shape or not (got == exp).all():
                bad = np.argwhere((got != exp).any(axis=(1, 2))).ravel()
                raise AssertionError(f"wavefront {size}: frames "
                                     f"{bad.tolist()} differ from the oracle")
            res[f"{size[0]}x{size[1]}"] = {"frames": len(pkts),
                                           "s_per_frame": t_dec / len(pkts)}
            log(f"[wavefront] WavefrontVideoDecoder {size[0]}x{size[1]}: "
                f"{len(pkts)} frames == oracle, {t_dec / len(pkts):.3f} s "
                f"per frame | {smi}")
        for cname, r in trans.items():
            src = r["src"]
            zero_counts()
            st = cli(["decode", str(src), str(src.parent / f"{cname}_wf"),
                      "--engine", "wavefront"])
            res["launches"][f"cli_{cname}"] = read_wavefront_count()
            if res["launches"][f"cli_{cname}"] != st["frames"]:
                raise AssertionError(f"[wavefront] {cname}: "
                                     f"{res['launches'][f'cli_{cname}']} K6 "
                                     f"launches for {st['frames']} frames")
            got = {p.suffix: p.read_bytes()
                   for p in sorted(src.parent.glob(f"{cname}_wf.*"))}
            if got != r["oracle_bytes"]:
                raise AssertionError(f"{cname}: decode --engine wavefront "
                                     f"bytes differ from --engine oracle's")
            res[cname] = {"fps": st["fps"], "frames": st["frames"]}
            log(f"[wavefront] {cname}: decode --engine wavefront -> "
                f"{ {k: len(v) for k, v in got.items()} } bytes, equal to "
                f"--engine oracle; {st['frames']} frames at {st['fps']} "
                f"frames/s; K6 launches {res['launches'][f'cli_{cname}']} "
                f"| {smi}")
    return res


# ------------------------------------------------ K7, K8, K9: side kernels

def read_side_counts() -> tuple[int, int, int]:
    """(K7, K8, K9) launches since zero_counts."""
    from mobiclipdecoder_tpu_torch.ops import audio_kernels, mesearch_kernels
    return (mesearch_kernels.sad_launches, audio_kernels.fastaudio_launches,
            audio_kernels.ima_launches)


def sad_work(H: int, W: int, R: int, r: int) -> dict:
    """What K7 must do for one volume: each input read once (cur and the
    R references) and the volume written once, int32; one operation per
    absolute difference at least."""
    side = 2 * r + 1
    return roofline(4 * (H * W * (1 + R) + side * side * R * (H // 8)
                         * (W // 8)), side * side * R * H * W)


def fastaudio_work(B: int, N: int) -> dict:
    """What K8 must do for B channels of N samples: excit read and pcm
    (int16) written, coef and the state read and written once; per sample
    17 multiply-shifts, 17 adds or subtracts and 2 clamps, one operation
    each at least.  ``serial_steps``: each channel's chain, N samples of
    17 dependent multiply-shifts."""
    return {**roofline(B * N * (4 + 2) + B * 4 * (8 + 8 + 8 + 2),
                       36 * B * N), "serial_steps": N}


def ima_work(M: int, N: int, lengths: bool = False) -> dict:
    """What K9 must do for M rows of N nibbles: nibbles read and samples
    written (int32), the two states and the 97 table entries read once
    (with ``lengths``, each row's length read and its two final states
    written too); two clamped adds per nibble (the two chains), one
    operation each at least."""
    return roofline(4 * (2 * M * N + (5 if lengths else 2) * M + 97),
                    2 * M * N)


def sad_planes(size):
    """cur (H, W) and SAD_REFS references of encoder_frames(size), uint8:
    frame SAD_REFS the target, frames SAD_REFS - 1 .. 0 the references
    (most recent first), the oldest replaced by 0/255 noise."""
    w, h = size
    fr = [f[0] for f in encoder_frames(size, SAD_REFS + 1)]
    refs = fr[SAD_REFS - 1::-1]
    refs[-1] = (255 * (np.random.default_rng(w).random((h, w)) < 0.5)
                ).astype(np.uint8)
    return fr[SAD_REFS], refs


def sad_kernel_check(sizes, smi) -> dict:
    """K7 == _sad8_volume_plain on the card, exact int32, at each size with
    the encoder's defaults (range SAD_RANGE, SAD_REFS references, sad_planes);
    K7 and the plain version timed in turns (median of 20, each behind the
    spin), beside K7's bound; the whole SadVolume call (upload, K7, the
    copy of the volume to pageable host memory; host clock, median of 5)."""
    from mobiclipdecoder_tpu_torch.ops import mesearch_kernels as mk
    from mobiclipdecoder_tpu_torch.ops.mesearch import (SadVolume,
                                                        _sad8_volume_plain)
    res = {}
    for size in sizes:
        label = f"{size[0]}x{size[1]}"
        cur_np, refs_np = sad_planes(size)
        cur = torch.from_numpy(cur_np.astype(np.int32)).cuda()
        refs = torch.from_numpy(np.stack(refs_np).astype(np.int32)).cuda()
        vol = mk.sad_volume(cur, refs, SAD_RANGE)
        err = max_err(vol, _sad8_volume_plain(cur, refs, SAD_RANGE))
        if err != 0:
            raise AssertionError(f"K7 {label}: max abs err {err} against "
                                 f"the plain version")
        ms = timed_turns({
            "k7": lambda: mk.sad_volume(cur, refs, SAD_RANGE),
            "plain": lambda: _sad8_volume_plain(cur, refs, SAD_RANGE)})
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            sv = SadVolume(cur_np, refs_np, SAD_RANGE, device="cuda")
            walls.append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(sv.vol, vol.cpu().numpy()):
            raise AssertionError(f"K7 {label}: SadVolume's volume differs")
        work = sad_work(size[1], size[0], SAD_REFS, SAD_RANGE)
        res[label] = {"range": SAD_RANGE, "R": SAD_REFS, "max_abs_err": err,
                      "top_sad": int(vol[:, -1].max()), "ms": ms["k7"],
                      "plain_ms": ms["plain"],
                      "sad_volume_call_ms": float(np.median(walls)), **work}
        log(f"[sad] K7 == the plain version on the card, {label} range "
            f"{SAD_RANGE} R={SAD_REFS} (0/255 reference, top SAD "
            f"{res[label]['top_sad']}): K7 {ms['k7']:.4f} ms vs plain "
            f"{ms['plain']:.3f} ms (median of 20 in turns, behind the "
            f"spin); bound {work['bound_ms'] * 1e3:.2f} us "
            f"({work['bound_by']}: {work['bytes'] / 1e6:.2f} MB), "
            f"K7/bound {ms['k7'] / work['bound_ms']:.1f}x; the whole "
            f"SadVolume call {res[label]['sad_volume_call_ms']:.3f} ms "
            f"(host clock, median of 5) | {smi}")
    return res


def ima_cases() -> list:
    """(label, body (IMA_CHANNELS, IMA_SAMPLES / 2) uint8, index0, last0):
    random bytes, then the four pinned cases of tests/test_torch_audio.py
    _case at full length: one nibble repeated over the first 3/4 of each
    row (0 walks the step index down to 0, 7 up to 88 and the samples up,
    15 the samples down), a random tail."""
    rng = np.random.default_rng(21)
    shape = (IMA_CHANNELS, IMA_SAMPLES // 2)
    out = [("random", rng.integers(0, 256, shape, dtype=np.uint8),
            rng.integers(0, 89, IMA_CHANNELS).astype(np.int32),
            rng.integers(-32768, 32768, IMA_CHANNELS).astype(np.int32))]
    for name, run, last in (("index-floor", 0, None),
                            ("index-ceiling", 7, None),
                            ("clamp-high", 7, 32000),
                            ("clamp-low", 15, -32000)):
        nib = np.full((IMA_CHANNELS, IMA_SAMPLES), run, np.uint8)
        nib[:, 3 * IMA_SAMPLES // 4:] = rng.integers(
            0, 16, (IMA_CHANNELS, IMA_SAMPLES // 4))
        body = (nib[:, 0::2] | (nib[:, 1::2] << 4)).astype(np.uint8)
        index0 = rng.integers(0, 89, IMA_CHANNELS).astype(np.int32)
        last0 = rng.integers(-32768, 32768, IMA_CHANNELS).astype(np.int32)
        if last is not None:
            last0[:] = last
        out.append((name, body, index0, last0))
    return out


def ima_chunk_case(M: int, N: int, seed: int) -> list[np.ndarray]:
    """[nibbles (M, N), index0, last0, lengths], int32, as the transcoder
    hands them to K9: rows of their own lengths (none, odd, whole, the rest
    random), zero nibbles after each; starts at the step table's ends and
    at the sample clamps."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(N // 2, N + 1, M)
    lengths[:3] = [0, 2 * (N // 4) + 1, N]
    nib = rng.integers(0, 16, (M, N))
    nib[np.arange(N)[None, :] >= lengths[:, None]] = 0
    index0 = rng.integers(0, 89, M)
    last0 = rng.integers(-32768, 32768, M)
    index0[:2], last0[:2] = (0, 88), (-32768, 32767)
    return [a.astype(np.int32) for a in (nib, index0, last0, lengths)]


def nibbles_on_card(body: np.ndarray) -> torch.Tensor:
    """(C, L) uint8 packet bytes -> (C, 2L) int32 nibbles on the card, low
    first (decode_packets' order)."""
    b = torch.from_numpy(body.astype(np.int32)).cuda()
    return torch.stack([b & 0xF, b >> 4], dim=-1).reshape(b.shape[0], -1)


def fa_round(decs, pkts) -> tuple[np.ndarray, np.ndarray]:
    """The host half of a FastAudio round (FastAudioBatchDecoder.decode's):
    each channel's packet -> (excitation (C, 256), coefs (C, 8)) int32."""
    ex = np.zeros((len(decs), 256), np.int32)
    cf = np.zeros((len(decs), 8), np.int32)
    for ch, d in enumerate(decs):
        d.data, d.offset = pkts[ch], 0
        out, coef = d.excitation()
        ex[ch], cf[ch] = out, coef
    return ex, cf


def fa_packet_case(P: int, seed: int) -> list[torch.Tensor]:
    """K8's operands at the transcoder's shape on the card: 2 rows of P
    random packets, unpacked (excitation and a coefficient set a packet),
    from the zero state; the rows' lengths P and P - 1."""
    from mobiclipdecoder_tpu_torch.models.audio_fastaudio_unpack import (
        unpack)
    rng = np.random.default_rng(seed)
    excit, coef = unpack(rng.integers(0, 256, (2, P, 40), dtype=np.uint8))
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (
        excit.reshape(2, -1), coef, np.zeros((2, 8), np.int32),
        np.zeros(2, np.int32), np.array([P, P - 1], np.int32))]


def audio_kernel_check(smi) -> dict:
    """K9 == decode_nibbles_plain on the card, exact int32, on each of
    ima_cases; K8 == fastaudio_synth_plain on the card over FA_CORPUS_ROUNDS
    rounds of FA_CORPUS channels (random packets, the state carried), and
    on the rounds' state after the last; each kernel and its plain version
    timed in turns behind the spin, beside the kernel's bound: K9 at
    IMA_CHANNELS x IMA_SAMPLES, K8 one round at FA_CHANNELS and at
    FA_CORPUS channels."""
    from mobiclipdecoder_tpu_torch.models.audio_fastaudio import (
        FastAudioDecoder)
    from mobiclipdecoder_tpu_torch.ops import audio_kernels as ak
    from mobiclipdecoder_tpu_torch.ops.adpcm import decode_nibbles_plain
    from mobiclipdecoder_tpu_torch.ops.audio_lpc import fastaudio_synth_plain
    res = {"ima": {"cases": {}}, "fastaudio": {}}
    for label, body, idx0, last0 in ima_cases():
        nib = nibbles_on_card(body)
        i0, l0 = (torch.from_numpy(x).cuda() for x in (idx0, last0))
        err = max_err(ak.ima_scan(nib, i0, l0),
                      decode_nibbles_plain(nib, i0, l0))
        if err != 0:
            raise AssertionError(f"K9 {label}: max abs err {err} against "
                                 f"the plain version")
        res["ima"]["cases"][label] = err
        if label == "random":
            ms = timed_turns({"k9": lambda: ak.ima_scan(nib, i0, l0),
                              "plain": lambda: decode_nibbles_plain(nib, i0,
                                                                    l0)})
            res["ima"].update(shape=f"{IMA_CHANNELS}x{IMA_SAMPLES}",
                              ms=ms["k9"], plain_ms=ms["plain"],
                              **ima_work(IMA_CHANNELS, IMA_SAMPLES))
    res["ima"]["chunk_shapes"] = {}
    for M, N in IMA_CHUNK_SHAPES:
        args = [torch.from_numpy(a).cuda()
                for a in ima_chunk_case(M, N, 23 + M)]
        got = ak.ima_scan(*args)
        err = max(max_err(a, b) for a, b in
                  zip(got, decode_nibbles_plain(*args)))
        if err != 0:
            raise AssertionError(f"K9 {M}x{N} with lengths: max abs err "
                                 f"{err} (samples, final index and last) "
                                 f"against the plain version")
        ms = timed_turns({"k9": lambda: ak.ima_scan(*args),
                          "plain": lambda: decode_nibbles_plain(*args)})
        res["ima"]["cases"][f"lengths-{M}x{N}"] = err
        res["ima"]["chunk_shapes"][f"{M}x{N}"] = {
            "ms": ms["k9"], "plain_ms": ms["plain"],
            **ima_work(M, N, lengths=True)}
    k9 = res["ima"]
    k9["max_abs_err"] = max(k9["cases"].values())
    log(f"[audio] K9 == the plain version on the card, {k9['shape']} "
        f"({', '.join(k9['cases'])}): K9 {k9['ms']:.4f} ms vs "
        f"plain {k9['plain_ms']:.3f} ms (median of 20 in turns, behind the "
        f"spin); bound {k9['bound_ms'] * 1e3:.2f} us ({k9['bound_by']}), "
        f"K9/bound {k9['ms'] / k9['bound_ms']:.1f}x; the transcoder's "
        f"shapes with lengths (samples and final states exact): "
        + ", ".join(f"{k} K9 {v['ms'] * 1e3:.2f} us vs plain "
                    f"{v['plain_ms']:.3f} ms, bound "
                    f"{v['bound_ms'] * 1e3:.3f} us ({v['bound_by']})"
                    for k, v in k9["chunk_shapes"].items())
        + f" | {smi}")
    rng = np.random.default_rng(22)
    decs = [FastAudioDecoder() for _ in range(FA_CORPUS)]
    state_k = [torch.zeros((FA_CORPUS, 8), dtype=torch.int32).cuda(),
               torch.zeros(FA_CORPUS, dtype=torch.int32).cuda()]
    state_p = [t.clone() for t in state_k]
    err = 0
    for _ in range(FA_CORPUS_ROUNDS):
        pkts = [rng.integers(0, 256, 40, dtype=np.uint8).tobytes()
                for _ in range(FA_CORPUS)]
        ex, cf = (torch.from_numpy(a).cuda() for a in fa_round(decs, pkts))
        pk, *state_k = ak.fastaudio_synth(ex, cf, *state_k)
        pp, *state_p = fastaudio_synth_plain(ex, cf, *state_p)
        err = max(err, max_err(pk, pp), *(max_err(a, b) for a, b in
                                           zip(state_k, state_p)))
    if err != 0:
        raise AssertionError(f"K8 {FA_CORPUS} channels: max abs err {err} "
                             f"against the plain version")
    for nch in (FA_CHANNELS, FA_CORPUS):
        args = (ex[:nch].contiguous(), cf[:nch].contiguous(),
                state_k[0][:nch].contiguous(), state_k[1][:nch].contiguous())
        ms = timed_turns({"k8": lambda: ak.fastaudio_synth(*args),
                          "plain": lambda: fastaudio_synth_plain(*args)},
                         reps=3, warm=1)
        res["fastaudio"][f"{nch}x256"] = {
            "ms": ms["k8"], "plain_ms": ms["plain"],
            **fastaudio_work(nch, 256)}
    res["fastaudio"]["transcoder_shapes"] = {}
    for P in FA_TRANSCODER_PACKETS:
        args = fa_packet_case(P, 31 + P)
        got, want = ak.fastaudio_synth(*args), fastaudio_synth_plain(*args)
        err = max(max(max_err(got[0][b, :256 * n], want[0][b, :256 * n])
                      for b, n in enumerate((P, P - 1))),
                  *(max_err(a, b) for a, b in zip(got[1:], want[1:])))
        if err != 0:
            raise AssertionError(f"K8 2 x {P} packets with lengths: max abs "
                                 f"err {err} (samples, final states) "
                                 f"against the plain version")
        ms = timed_turns({"k8": lambda: ak.fastaudio_synth(*args),
                          "plain": lambda: fastaudio_synth_plain(*args)},
                         reps=3, warm=1)
        res["fastaudio"]["transcoder_shapes"][f"2x{256 * P}"] = {
            "ms": ms["k8"], "plain_ms": ms["plain"],
            **fastaudio_work(2, 256 * P)}
    res["fastaudio"]["max_abs_err"] = err
    fa = res["fastaudio"]
    log(f"[audio] K8 == the plain version on the card over "
        f"{FA_CORPUS_ROUNDS} rounds of {FA_CORPUS} channels, state carried; "
        f"one round of 256 samples: "
        + ", ".join(f"{k} channels K8 {fa[k]['ms']:.4f} ms vs plain "
                    f"{fa[k]['plain_ms']:.1f} ms (bound "
                    f"{fa[k]['bound_ms'] * 1e3:.3f} us, {fa[k]['bound_by']})"
                    for k in (f"{FA_CHANNELS}x256", f"{FA_CORPUS}x256"))
        + "; the transcoder's shapes, a set per packet, with lengths "
        "(samples and final states exact): "
        + ", ".join(f"{k} K8 {v['ms']:.4f} ms vs plain {v['plain_ms']:.1f} "
                    f"ms (bound {v['bound_ms'] * 1e3:.3f} us, "
                    f"{v['bound_by']}; {v['ms'] * 1e3 / v['serial_steps']:.4f}"
                    f" us a serial sample)"
                    for k, v in fa["transcoder_shapes"].items())
        + f" (median of 3 in turns, behind the spin) | {smi}")
    return res


def encode_phase(mf, sizes, enc_futs, smi) -> dict:
    """[encode]: K7 == the plain version on the card at every size, timed
    (sad_kernel_check); the encoder on the card == on the CPU (volumes and
    bytes); its packets through the executor and the wavefront engine ==
    oracle; a 640x480 encode at the encoder's defaults on the card, its
    packets through the executor == oracle, its seconds per frame; the
    CLI's encode then decode.  K7's launches on each path, counted from 0:
    one per SAD volume."""
    from mobiclipdecoder_tpu_torch.models.encoder import MobiclipEncoder
    from mobiclipdecoder_tpu_torch.models.pipeline import (
        WavefrontVideoDecoder)
    from mobiclipdecoder_tpu_torch.ops.vmem_engine import VmemVideoDecoder
    res = {"launches": {}}
    with phase("encode"):
        res["sad"] = sad_kernel_check(sizes, smi)
        for size in sizes:
            label = f"{size[0]}x{size[1]}"
            zero_counts()
            pkts, vols, t_enc = encode_task(size, "cuda")
            k7 = read_side_counts()[0]
            cpk, cvols, t_cpu = enc_futs[size].result()
            if pkts != cpk:
                raise AssertionError(f"encode {label}: bytes on the card "
                                     f"differ from the CPU encoder's")
            for k, (a, b) in enumerate(zip(vols, cvols)):
                if (a is None) != (b is None) or (
                        a is not None and not np.array_equal(a, b)):
                    raise AssertionError(f"encode {label} frame {k}: SAD "
                                         f"volume differs from the CPU's")
            nvol = sum(v is not None for v in vols)
            if k7 != nvol:
                raise AssertionError(f"encode {label}: {k7} K7 launches for "
                                     f"{nvol} SAD volumes")
            res["launches"][f"encode_{label}"] = k7
            exp = oracle_frames(mf, pkts, size)
            vd = VmemVideoDecoder(*size, mf, native=True, device="cuda")
            zero_counts()
            yuv, offs, err = vd.decode_stream_chunk(pkts)
            k1_launches = sum(read_counts())
            wd = WavefrontVideoDecoder(*size, mf, native=True, device="cuda")
            wfy = np.stack([np.concatenate(wd.decode_frame(p)) for p in pkts])
            if (err is not None or k1_launches < 1
                    or offs != [len(p) for p in pkts]
                    or not (yuv == exp).all() or not (wfy == exp).all()):
                raise AssertionError(f"encode {label}: decoded packets differ "
                                     f"from the oracle (err {err}, launches "
                                     f"{k1_launches})")
            res[label] = {"bytes": [len(p) for p in pkts], "s_card": t_enc,
                          "s_cpu": t_cpu, "volumes": nvol}
            log(f"[encode] {label}: {len(pkts)} frames, "
                f"{sum(map(len, pkts))} bytes, equal to the CPU encoder's "
                f"with {nvol} equal SAD volumes (K7 launches {k7}); "
                f"executor ({k1_launches} launches) and wavefront decode == "
                f"oracle; encode {t_enc:.1f} s (card) vs {t_cpu:.1f} s "
                f"(CPU, spawned) | {smi}")
        # full width at the encoder's defaults (refs 5, me_range 16)
        label = f"{ENC_WIDE[0]}x{ENC_WIDE[1]}"
        enc = MobiclipEncoder(*ENC_WIDE, mf, device="cuda")
        zero_counts()
        t0 = time.perf_counter()
        pkts = [enc.encode_frame(*f) + b"\x00\x00"
                for f in encoder_frames(ENC_WIDE)]
        t_wide = time.perf_counter() - t0
        k7 = read_side_counts()[0]
        exp = oracle_frames(mf, pkts, ENC_WIDE)
        zero_counts()
        yuv, offs, err = VmemVideoDecoder(
            *ENC_WIDE, mf, native=True, device="cuda").decode_stream_chunk(
                pkts)
        k1_launches = sum(read_counts())
        if (err is not None or k1_launches < 1 or k7 != len(pkts) - 1
                or offs != [len(p) for p in pkts] or not (yuv == exp).all()):
            raise AssertionError(f"encode {label} at the defaults: decoded "
                                 f"packets differ from the oracle (err "
                                 f"{err}, K1 launches {k1_launches}, K7 "
                                 f"launches {k7})")
        res["launches"][f"encode_{label}_defaults"] = k7
        res[f"{label}_defaults"] = {
            "frames": len(pkts), "bytes": [len(p) for p in pkts],
            "refs": enc.max_refs, "me_range": enc.me_range,
            "s_per_frame": t_wide / len(pkts)}
        log(f"[encode] {label} at the encoder's defaults (refs "
            f"{enc.max_refs}, me_range {enc.me_range}) on the card: "
            f"{len(pkts)} frames, {sum(map(len, pkts))} bytes, "
            f"{t_wide / len(pkts):.2f} s per "
            f"frame; K7 launches {k7}; decoded by the executor "
            f"({k1_launches} launches) == oracle | {smi}")
        with tempfile.TemporaryDirectory() as d:
            tmp = Path(d)
            write_y4m(tmp / "in.y4m", (W, H), ENC_FRAMES)
            zero_counts()
            st = cli(["encode", str(tmp / "in.y4m"), str(tmp / "e.moflex")])
            res["launches"]["cli_encode"] = read_side_counts()[0]
            zero_counts()
            cli(["decode", str(tmp / "e.moflex"), str(tmp / "cuda")])
            n = sum(read_counts())
            cli(["decode", str(tmp / "e.moflex"), str(tmp / "oracle"),
                 "--engine", "oracle"])
            a = (tmp / "cuda.y4m").read_bytes()
            if n < 1 or a != (tmp / "oracle.y4m").read_bytes():
                raise AssertionError(f"encode CLI: decode --engine cuda "
                                     f"(launches {n}) differs from oracle")
        res["cli"] = {"frames": st["frames"], "bytes": st["bytes"],
                      "s": st["seconds"]}
        log(f"[encode] CLI encode of a {ENC_FRAMES}-frame {W}x{H} .y4m "
            f"({st['bytes']} bytes, {st['seconds']} s, K7 launches "
            f"{res['launches']['cli_encode']}) then decode --engine cuda "
            f"== --engine oracle | {smi}")
    return res


def audio_phase(smi) -> dict:
    """[audio]: K9 and K8 == their plain versions on the card, timed
    (audio_kernel_check); decode_packets on the card (one K9 launch per
    call) == the host ImaAdpcmDecoder on each of ima_cases;
    FastAudioBatchDecoder on the card (one K8 launch per round) == the
    host decoders over FA_PACKETS rounds of FA_CHANNELS channels, and ==
    the plain version on the card fed the same rounds, state carried.  K8's
    and K9's launches on each path, counted from 0."""
    from mobiclipdecoder_tpu_torch.models.audio_fastaudio import (
        FastAudioDecoder)
    from mobiclipdecoder_tpu_torch.models.audio_ima import ImaAdpcmDecoder
    from mobiclipdecoder_tpu_torch.ops.adpcm import decode_packets
    from mobiclipdecoder_tpu_torch.ops.audio_lpc import (
        FastAudioBatchDecoder, fastaudio_synth_plain)
    with phase("audio"):
        res = audio_kernel_check(smi)
        calls, t_host = {}, 0.0
        zero_counts()
        for label, body, idx0, last0 in ima_cases():
            t0 = time.perf_counter()
            got = decode_packets(body, idx0, last0, device="cuda")
            calls[label] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            for c in range(IMA_CHANNELS):
                dec = ImaAdpcmDecoder()
                dec.is_init = True
                dec.index, dec.last = int(idx0[c]), int(last0[c])
                raw = body[c].tobytes()
                want = np.concatenate([dec.decode(raw, o, 128)
                                       for o in range(0, len(raw), 128)])
                if not np.array_equal(got[c], want):
                    raise AssertionError(f"IMA {label} channel {c} differs "
                                         f"from the host decoder")
            t_host += time.perf_counter() - t0
        ima_launches = read_side_counts()[2]
        if ima_launches != len(calls):
            raise AssertionError(f"IMA: {ima_launches} K9 launches for "
                                 f"{len(calls)} decode_packets calls")
        res["ima"].update(call_ms=calls, host_s=t_host,
                          launches={"audio_decode_packets": ima_launches})
        log(f"[audio] IMA decode_packets on the card, {IMA_CHANNELS} "
            f"channels x {IMA_SAMPLES} samples (128-byte packets), "
            f"{len(calls)} cases ({', '.join(calls)}) == host "
            f"ImaAdpcmDecoder; K9 launches {ima_launches}; whole call "
            + ", ".join(f"{v:.1f}" for v in calls.values())
            + f" ms; host decoder {t_host:.1f} s for all | {smi}")
        rng = np.random.default_rng(21)
        pk = rng.integers(0, 256, (FA_PACKETS, FA_CHANNELS, 40),
                          dtype=np.uint8)
        fa = FastAudioBatchDecoder(FA_CHANNELS, device="cuda")
        hosts = [FastAudioDecoder() for _ in range(FA_CHANNELS)]
        decs = [FastAudioDecoder() for _ in range(FA_CHANNELS)]
        plain_state = (torch.zeros_like(fa.hist), torch.zeros_like(fa.r9))
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t_dev = ms = 0.0
        err = 0
        fa_launches = 0
        for k in range(FA_PACKETS):
            pkts = [pk[k, c].tobytes() for c in range(FA_CHANNELS)]
            zero_counts()
            t0 = time.perf_counter()
            e0.record()
            got = fa.decode(pkts)
            e1.record()
            torch.cuda.synchronize()
            t_dev += time.perf_counter() - t0
            ms += e0.elapsed_time(e1)
            fa_launches += read_side_counts()[1]
            for c, h in enumerate(hosts):
                h.data = pkts[c]
                h.offset = 0
                if not np.array_equal(got[c], h.decode()):
                    raise AssertionError(f"FastAudio packet {k} channel {c} "
                                         f"differs from the host decoder")
            ex, cf = (torch.from_numpy(a).cuda() for a in fa_round(decs,
                                                                   pkts))
            pcm_p, *plain_state = fastaudio_synth_plain(ex, cf, *plain_state)
            err = max(err, int(np.abs(got.astype(np.int32) - pcm_p.cpu(
                ).numpy().astype(np.int32)).max()),
                      max_err(fa.hist, plain_state[0]),
                      max_err(fa.r9, plain_state[1]))
        if err != 0 or fa_launches != FA_PACKETS:
            raise AssertionError(f"FastAudio: K8 against the plain version "
                                 f"on the card, max abs err {err}; "
                                 f"{fa_launches} K8 launches for "
                                 f"{FA_PACKETS} rounds")
        res["fastaudio"]["max_abs_err"] = max(res["fastaudio"]["max_abs_err"],
                                              err)
        res["fastaudio"].update(
            batch_decoder={"shape": f"{FA_CHANNELS}x{FA_PACKETS}",
                           "ms_per_round": ms / FA_PACKETS,
                           "wall_ms_per_round": t_dev * 1e3 / FA_PACKETS},
            launches={"audio_fastaudio_batch": fa_launches})
        log(f"[audio] FastAudioBatchDecoder on the card, {FA_CHANNELS} "
            f"channels x {FA_PACKETS} packets == host FastAudioDecoders and "
            f"== the plain version on the card round by round (state "
            f"carried); K8 launches {fa_launches}; {ms / FA_PACKETS:.3f} ms "
            f"per round of 256 samples (CUDA events around decode), "
            f"{t_dev * 1e3 / FA_PACKETS:.3f} ms wall | {smi}")
    return res


# ------------------------------------------- sharded, entry, warm, multi-GPU
def shard_devices() -> list[str]:
    """The devices the sharded phases split over: every visible GPU (the
    largest power of two of them, so that 8 streams split evenly), or
    cuda:0 twice on a one-card machine."""
    n = torch.cuda.device_count()
    k = max(d for d in (1, 2, 4, 8) if d <= n)
    return ["cuda:0", "cuda:0"] if k == 1 else [f"cuda:{i}" for i in range(k)]


def sync_all() -> None:
    for k in range(torch.cuda.device_count()):
        torch.cuda.synchronize(k)


def sharded_call_ms(devices, arrays, F: int, h: int, S: int,
                    reps: int = 5) -> float:
    """Host ms per decode_gop_fused_sharded call over ``devices`` (inputs
    already on the first device; every card synchronized at the end),
    mean of ``reps`` after a warm-up call."""
    from mobiclipdecoder_tpu_torch.ops.vmem_engine import (
        decode_gop_fused_sharded, sharded_rings)
    rings = sharded_rings(devices, arrays[0].shape[0], h, S)
    rings, _y = decode_gop_fused_sharded(devices, rings, *arrays, F, h, S)
    sync_all()
    t0 = time.perf_counter()
    for _ in range(reps):
        rings, _y = decode_gop_fused_sharded(devices, rings, *arrays, F, h,
                                             S)
    sync_all()
    return (time.perf_counter() - t0) * 1e3 / reps


def sharded_case(label, devices, gops_packed, h, S, want_frames, want_ring,
                 smi) -> dict:
    """GOPs (packed host arrays, ring carried across) through
    decode_gop_fused_sharded over ``devices``, counted; frames and ring
    must equal the unsharded ones exactly.  Then its ms per GOP against
    the same call on the first device alone."""
    from mobiclipdecoder_tpu_torch.ops.vmem_engine import (
        decode_gop_fused_sharded, gather_shards, sharded_rings)
    from mobiclipdecoder_tpu_torch.utils.device import check_device
    nb = gops_packed[0][0].shape[0]
    nf = len(want_frames[0])
    rings = sharded_rings(devices, nb, h, S)
    zero_counts()
    got = []
    for arrays in gops_packed:
        rings, yuvs = decode_gop_fused_sharded(devices, rings, *arrays, nf, h,
                                               S)
        if [y.device for y in yuvs] != [check_device(d) for d in devices]:
            raise AssertionError(f"[sharded] {label}: results on "
                                 f"{[y.device for y in yuvs]}")
        got.append(gather_shards(yuvs))
    sync_all()
    launches = read_counts()
    pro = read_prologue_counts()
    planes = check_plane_form(f"sharded {label}", h, S)
    if launches != (len(devices) * len(gops_packed), 0):
        raise AssertionError(f"[sharded] {label}: launches {launches}")
    for g, (a, b) in enumerate(zip(got, want_frames)):
        if a.shape != b.shape or not (a == b).all():
            raise AssertionError(f"[sharded] {label} GOP {g}: frames differ "
                                 f"from the unsharded executor's")
    if not np.array_equal(gather_shards(rings, 0), want_ring):
        raise AssertionError(f"[sharded] {label}: ring differs from the "
                             f"unsharded executor's")
    on_card = [torch.from_numpy(a).cuda() for a in gops_packed[0]]
    ms = sharded_call_ms(devices, on_card, nf, h, S)
    ms_one = sharded_call_ms(devices[:1], on_card, nf, h, S)
    names = ",".join(devices)
    log(f"[sharded] {label} B={nb} F={nf} over [{names}]: "
        f"{len(gops_packed)} GOPs, frames and ring == the unsharded "
        f"executor's; launches {launches[0]} (one-block shared/global, "
        f"cluster {planes[0]}/{planes[1]}, {planes[2]}); ms per GOP (prologue + executor, inputs "
        f"on cuda:0, host clock after syncing every card, mean of 5): "
        f"sharded {ms:.3f} vs one launch on cuda:0 {ms_one:.3f} | {smi}")
    return {"devices": list(devices), "B": nb, "F": nf,
            "launches": launches[0], "prologue": pro, "planes": planes,
            "ms_per_gop": ms,
            "ms_per_gop_one_device": ms_one}


def launch_guard(smi) -> int:
    """With two or more cards: the executor's launch given tensors and a
    stream of cuda:1 while cuda:0 is current must be refused
    (cudaErrorInvalidDevice), not run on cuda:0.  Returns its code."""
    from mobiclipdecoder_tpu_torch import state
    from mobiclipdecoder_tpu_torch.ops import executor
    from mobiclipdecoder_tpu_torch.ops.packing import CHUNK
    d1 = torch.device("cuda", 1)
    ops = torch.zeros((1, 1, CHUNK, 4), dtype=torch.int32, device=d1)
    resid = torch.zeros((1, 1, CHUNK, 64), dtype=torch.int32, device=d1)
    ring = torch.zeros(state.ring_shape(1, 48, 256), dtype=torch.uint8,
                       device=d1)
    frames = torch.empty_like(ring[:, 0])[None]
    tabs = state.kernel_tables(d1)
    with torch.cuda.device(0):
        rc = executor._load().mobi_gop_executor_launch(
            ops.data_ptr(), resid.data_ptr(), ring.data_ptr(),
            frames.data_ptr(), tabs.data_ptr(), 1, 1, 1, 48, 256, 1, 1,
            torch.cuda.current_stream(d1).cuda_stream)
    if rc != 101:
        raise AssertionError(f"[sharded] a launch for cuda:1 from cuda:0 "
                             f"returned {rc}, not cudaErrorInvalidDevice")
    log(f"[sharded] the executor's launch for cuda:1 tensors while cuda:0 "
        f"is current is refused: CUDA error {rc} | {smi}")
    return rc


def sharded_phase(ds, gops, k1_outs, main_ring, geo, smi) -> dict:
    """[sharded]: the main path's 8 streams x 2 GOPs through
    decode_gop_fused_sharded == the unsharded K1 output (frames and ring);
    the 400x240 and 640x480 GOPs of [geometry] with their stream doubled
    (B=2) the same way, against one launch on cuda:0."""
    from mobiclipdecoder_tpu_torch.ops.vmem_engine import (_decode_gop_fused,
                                                           sharded_rings)
    devs = shard_devices()
    res = {}
    with phase("sharded"):
        packed = [packed_gop(ds, gop, (W, H)) for gop in gops]
        res[f"{W}x{H}"] = sharded_case(f"{W}x{H}", devs, packed, H, 256,
                                       k1_outs, main_ring, smi)
        for size in WIDE:
            label = f"{size[0]}x{size[1]}"
            h, S = size[1], width_stride(size[0])
            arrays = [np.concatenate([a, a]) for a in geo[label]["packed"]]
            ring, yuv = _decode_gop_fused(
                sharded_rings(devs[:1], 2, h, S)[0],
                *(torch.from_numpy(a).cuda() for a in arrays), F, h, S)
            res[label] = sharded_case(label, devs[:2], [arrays], h, S,
                                      [yuv.cpu().numpy()],
                                      ring.cpu().numpy(), smi)
        if torch.cuda.device_count() > 1:
            res["refused_launch_rc"] = launch_guard(smi)
    return res


def multi_device_run(ds, mf, gops, smi, t_start) -> int:
    """``--multi-device``: the main path's decode (the unsharded K1
    frames and ring), then [sharded], [entry] and [multi_gpu] alone."""
    from mobiclipdecoder_tpu_torch.ops.vmem_engine import VmemBatchDecoder
    dec = VmemBatchDecoder(W, H, ds, batch=B, native=True, device="cuda")
    outs = list(dec.decode_gops(iter(gops)))
    geo = {f"{w}x{h}": {"packed": packed_gop(
        mf, synth_gops(mf, [7], 1, F, (w, h))[0], (w, h))} for w, h in WIDE}
    sharded_phase(ds, gops, outs, dec.ring.cpu().numpy(), geo, smi)
    entry_phase(ds, smi)
    multi_gpu_phase(smi)
    scaling_phase(ds, gops, outs, smi)
    log(f"[total] {time.perf_counter() - t_start:.1f} s; --multi-device: "
        f"no result line")
    return 0


def entry_phase(ds, smi) -> dict:
    """[entry]: the port's entry("cuda") == the oracle's I-frame; then
    dryrun_multichip over shard_devices(), counted."""
    from mobiclipdecoder_tpu_torch.graft_entry import dryrun_multichip, entry
    from mobiclipdecoder_tpu_torch.testing.synth import StreamSynthesizer
    with phase("entry"):
        fn, args = entry("cuda")
        got = fn(*args)
        torch.cuda.synchronize()
        pkt = StreamSynthesizer(64, 48, ds, seed=0).iframe(0x18)
        exp = oracle_frames(ds, [pkt], (64, 48)).astype(np.int32)
        if tuple(got.shape) != (1,) + exp.shape[1:] or not (
                got.cpu().numpy() == exp).all():
            raise AssertionError("[entry] entry('cuda') differs from the "
                                 "oracle's I-frame")
        devs = shard_devices()
        zero_counts()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            dryrun_multichip(len(devs), devices=devs)
        sync_all()
        t_dry = time.perf_counter() - t0
        launches = read_counts()
        pro = read_prologue_counts()
        wf = read_wavefront_count()
        if launches[0] < 1 or launches[1] < 1 or wf < 1:
            raise AssertionError(f"[entry] dryrun_multichip launches "
                                 f"{launches}, K6 {wf}")
        line = buf.getvalue().strip()
        log(f"[entry] entry('cuda') fn(*args) {tuple(got.shape)} int32 == "
            f"the oracle's 64x48 I-frame; {line} ({t_dry:.1f} s; launches "
            f"whole-GOP {launches[0]}, single-frame {launches[1]}, K6 {wf}) "
            f"| {smi}")
    return {"dryrun_s": t_dry, "launches": launches, "prologue": pro,
            "wavefront": wf, "devices": devs}


def warm_phase(smi) -> dict:
    """[warm]: tools/warm_kernels at the three geometries with nothing
    deleted (every library already built): a warm call, counted per
    geometry."""
    from mobiclipdecoder_tpu_torch.tools import warm_kernels
    res = {}
    with phase("warm"):
        t0 = time.perf_counter()
        for g in (f"{W}x{H}", "400x240", "640x480"):
            zero_counts()
            r = warm_kernels.warm([g], batch=2, frames=8, device="cuda")
            sync_all()
            launches = read_counts()
            pro = read_prologue_counts()
            if launches != (1, min(2, r[g]["frames"])):
                raise AssertionError(f"[warm] {g}: launches {launches}")
            res[g] = {"gop_s": r[g]["gop_s"], "frames_s": r[g]["frames_s"],
                      "launches": launches, "prologue": pro,
                      "builds": {k: v["s"] for k, v in r["builds"].items()}}
        total = time.perf_counter() - t0
        log(f"[warm] warm_kernels {' '.join(res)} --batch 2 --frames 8 with "
            f"every library built: {total:.1f} s in all (synthesis "
            f"included); first launches per geometry: "
            + ", ".join(f"{g} GOP {v['gop_s']:.3f} s + 2 frames "
                        f"{v['frames_s']:.3f} s" for g, v in res.items())
            + f" | {smi}")
    return {"total_s": total, **res}


def multi_gpu_worker(coord: str, pid: int, nproc: int, files: list,
                     out_dir: str, result: str) -> None:
    """One rank of [multi_gpu]: init_distributed (NCCL, pinned to its
    GPU), run_worker(engine="cuda"), then where its memory went."""
    import torch.distributed as dist
    from mobiclipdecoder_tpu_torch.ops import executor
    from mobiclipdecoder_tpu_torch.parallel.distributed import (
        init_distributed, run_worker)
    rank, world = init_distributed(coord, nproc, pid)
    stats = run_worker(files, out_dir, worker_id=rank, n_workers=world,
                       engine="cuda", batch=B)
    dev = torch.cuda.current_device()
    torch.cuda.synchronize(dev)
    stats.update(rank=rank, device=dev, launches=executor.launches,
                 backend=dist.get_backend(),
                 peak_bytes=[torch.cuda.max_memory_allocated(k)
                             for k in range(torch.cuda.device_count())])
    dist.barrier(device_ids=[dev])
    dist.destroy_process_group()
    Path(result).write_text(json.dumps(stats))


def multi_gpu_phase(smi) -> dict | None:
    """[multi_gpu]: with two or more GPUs, run_worker in two spawned
    processes through init_distributed: each rank decodes on its own GPU
    (all its device memory there), and the shards equal the oracle
    worker's.  With one GPU it is skipped."""
    import socket
    from mobiclipdecoder_tpu_torch.parallel.distributed import run_worker
    n = torch.cuda.device_count()
    if n < 2:
        log(f"[multi_gpu] skipped: {n} device")
        return None
    ctx = multiprocessing.get_context("spawn")
    with phase("multi_gpu"), tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        files = []
        for i in range(4):
            p = tmp / f"m{i}.mods"
            p.write_bytes(mods_container(2 * BATCH_GOP, 50 + i,
                                         (0, BATCH_GOP)))
            files.append(str(p))
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = [ctx.Process(target=multi_gpu_worker, args=(
            f"127.0.0.1:{port}", pid, 2, files, str(tmp / "cuda"),
            str(tmp / f"rank{pid}.json"))) for pid in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(600)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        wall = time.perf_counter() - t0
        if any(p.exitcode != 0 for p in procs):
            raise AssertionError(f"[multi_gpu] exit codes "
                                 f"{[p.exitcode for p in procs]}")
        ranks = [json.loads((tmp / f"rank{k}.json").read_text())
                 for k in range(2)]
        for k, r in enumerate(ranks):
            own = r["peak_bytes"][k]
            other = sum(b for j, b in enumerate(r["peak_bytes"]) if j != k)
            if (r["rank"], r["device"], r["backend"]) != (k, k, "nccl") or (
                    r["launches"] < 1 or own <= 0 or other != 0
                    or r["shards_decoded"] < 1):
                raise AssertionError(f"[multi_gpu] rank {k}: {r}")
        run_worker(files, tmp / "oracle", engine="oracle")
        names = sorted(p.name for p in (tmp / "oracle").glob("*.npy"))
        if names != sorted(p.name for p in (tmp / "cuda").glob("*.npy")):
            raise AssertionError(f"[multi_gpu] shard files {names}")
        for name in names:
            if not np.array_equal(np.load(tmp / "cuda" / name),
                                  np.load(tmp / "oracle" / name)):
                raise AssertionError(f"[multi_gpu] {name} differs from the "
                                     f"oracle")
        log(f"[multi_gpu] 2 processes, NCCL, rank k pinned to cuda:k: "
            + "; ".join(f"rank {r['rank']} on cuda:{r['device']}, "
                        f"{r['shards_decoded']} shards, {r['frames']} "
                        f"frames, {r['launches']} launches, peak bytes by "
                        f"device {r['peak_bytes']}" for r in ranks)
            + f"; all {len(names)} shards == oracle worker; {wall:.1f} s "
            f"with process start | {smi}")
    return {"ranks": ranks, "wall_s": wall}


# ------------------------------------------------- trace, bench, scaling
def busy_union(intervals, w0: float, w1: float) -> tuple[float, int]:
    """(length of the union of the (start, end) intervals clipped to
    [w0, w1], the number of intervals that overlap it)."""
    clipped = sorted((max(a, w0), min(b, w1)) for a, b in intervals
                     if b > w0 and a < w1)
    total, cur = 0.0, None
    for a, b in clipped:
        if cur is None or a > cur[1]:
            total += 0.0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    total += 0.0 if cur is None else cur[1] - cur[0]
    return total, len(clipped)


def device_intervals(events) -> dict[str, list]:
    """The device's kernel, memcpy and memset intervals (us) among a
    trace's events, by kind; the device-side copies of user annotations
    (record_function ranges) are not device work."""
    out = {"kernel": [], "memcpy": [], "memset": []}
    for e in events:
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or e.name in SPAN_NAMES or e.name == TRACE_WINDOW):
            continue
        low = e.name.lower()
        kind = ("memcpy" if low.startswith("memcpy") else
                "memset" if low.startswith("memset") else "kernel")
        out[kind].append((e.time_range.start, e.time_range.end))
    return out


def short_name(name: str) -> str:
    """A kernel's name without its argument list, at most 100 chars."""
    name = name.split("(")[0] if not name.startswith("void at::") else name
    name = name.removeprefix("void ")
    return name if len(name) <= 100 else name[:97] + "..."


def kernel_names(events, w0: float, w1: float) -> dict[str, int]:
    """How many times each device kernel started in [w0, w1), by name
    (memcpy and memset excluded, as are annotations)."""
    out: dict[str, int] = {}
    for e in events:
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or e.name in SPAN_NAMES or e.name == TRACE_WINDOW
                or e.name.lower().startswith(("memcpy", "memset"))
                or not w0 <= e.time_range.start < w1):
            continue
        out[e.name] = out.get(e.name, 0) + 1
    return out


def span_counts(dec, gops: int, launches: int) -> dict[str, int]:
    """The stage spans that decode_gops records over ``gops`` GOPs that
    took ``launches`` executor launches: one scan and one download wait
    per GOP; a pack per launch; a dispatch per launch, per join of a GOP
    split at a frame boundary (launches - gops of them), per download,
    and per crop when the decoder crops its planes on the device."""
    crop = dec.crop and dec.width != dec.stride
    return {"mobiclip.scan": gops, "mobiclip.pack": launches,
            "mobiclip.dispatch": 2 * launches + gops * crop,
            "mobiclip.device_decode": gops}


def trace_phase(ds, gops, k1_outs, smi) -> dict:
    """[trace]: torch.profiler with CPU and CUDA activity over decode_gops
    of TRACE_GOPS of the main path's GOPs (after a warm-up), then one
    decode_gop.  The engine's stage spans must appear as often as the
    window's GOPs and executor launches imply (span_counts); each span's
    host ms per GOP, and the device's busy share of the
    decode_gops window: the union of its kernel, memcpy and memset
    intervals over the window's wall, under the profiler.  The same
    window run untraced first gives the profiler's cost.  Each kernel of
    the window by name, with its count per GOP: exactly one prologue
    kernel (K5) per GOP, and no fill (resid is not zeroed)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from mobiclipdecoder_tpu_torch.ops import executor
    from mobiclipdecoder_tpu_torch.ops.vmem_engine import VmemBatchDecoder
    with phase("trace"):
        dec = VmemBatchDecoder(W, H, ds, batch=B, native=True, device="cuda")
        list(dec.decode_gops(iter(gops)))

        def window() -> int:
            n = sum(1 for _out in dec.decode_gops(
                gops[g % len(gops)] for g in range(TRACE_GOPS)))
            torch.cuda.synchronize()
            return n
        t0 = time.perf_counter()
        window()
        untraced_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            l0 = executor.launches + executor.frame_launches
            with record_function(TRACE_WINDOW):
                n = window()
            launches = executor.launches + executor.frame_launches - l0
            one = dec.decode_gop(gops[0])
            torch.cuda.synchronize()
        if n != TRACE_GOPS or not np.array_equal(one, k1_outs[0]):
            raise AssertionError(f"[trace] {n} GOPs; decode_gop == the main "
                                 f"path's GOP 0: "
                                 f"{np.array_equal(one, k1_outs[0])}")
        events = prof.events()
        cpu = torch.autograd.DeviceType.CPU
        win = [e for e in events
               if e.name == TRACE_WINDOW and e.device_type == cpu]
        if len(win) != 1:
            raise AssertionError(f"[trace] {len(win)} window ranges")
        w0, w1 = win[0].time_range.start, win[0].time_range.end
        spans = {}
        wants = span_counts(dec, TRACE_GOPS, launches)
        for name in SPAN_NAMES:
            evs = [e for e in events
                   if e.name == name and e.device_type == cpu]
            inside = [e for e in evs if w0 <= e.time_range.start < w1]
            if not evs or len(inside) != wants[name]:
                raise AssertionError(f"[trace] {name}: {len(evs)} spans, "
                                     f"{len(inside)} in the window, "
                                     f"{wants[name]} expected")
            per = inside or evs
            spans[name] = {"spans": len(evs), "ms_per_gop": sum(
                e.time_range.elapsed_us() for e in per) / 1e3
                / (TRACE_GOPS if inside else len(evs))}
        kinds = device_intervals(events)
        busy_us, n_act = busy_union(
            [iv for v in kinds.values() for iv in v], w0, w1)
        if n_act == 0:
            raise AssertionError("[trace] the profiler saw no device work in "
                                 "the decode_gops window")
        wall_ms = (w1 - w0) / 1e3
        share = busy_us / 1e3 / wall_ms
        per_gop = {k: busy_union(v, w0, w1)[1] / TRACE_GOPS
                   for k, v in kinds.items()}
        log(f"[trace] decode_gops of {TRACE_GOPS} GOPs (B={B}, F={F}) under "
            f"torch.profiler (CPU + CUDA activity): host ms per GOP "
            + ", ".join(f"{k} {v['ms_per_gop']:.3f} ({v['spans']} spans)"
                        for k, v in spans.items())
            + f" (device_decode: the wait for each download); device "
            f"busy under the profiler {busy_us / 1e3:.3f} of {wall_ms:.3f} "
            f"ms = {share:.3f} of the wall (union of "
            + ", ".join(f"{len(v)} {k}" for k, v in kinds.items())
            + f" intervals); device activities per GOP in the window: "
            + ", ".join(f"{k} {v:.2f}" for k, v in per_gop.items())
            + f"; wall per GOP {wall_ms / TRACE_GOPS:.3f} ms "
            f"traced vs {untraced_ms / TRACE_GOPS:.3f} untraced | {smi}")
        names = kernel_names(events, w0, w1)
        log("[trace] kernels per GOP in the window: "
            + "; ".join(f"{short_name(k)}: {v / TRACE_GOPS:.2f}"
                        for k, v in sorted(names.items(),
                                           key=lambda kv: -kv[1])))
        k5 = sum(v for k, v in names.items() if "mobi_prologue_sblob" in k)
        stray = [k for k in names if "fill" in k.lower()
                 or "mobi_residual_rows" in k]
        if k5 != TRACE_GOPS or stray:
            raise AssertionError(f"[trace] {k5} K5 launches for "
                                 f"{TRACE_GOPS} GOPs; fills or K4: {stray}")
    return {"spans": spans, "busy_ms": busy_us / 1e3, "wall_ms": wall_ms,
            "busy_share": share, "untraced_wall_ms": untraced_ms,
            "device_activities": {k: len(v) for k, v in kinds.items()},
            "per_gop": per_gop,
            "kernels_per_gop": {short_name(k): v / TRACE_GOPS
                                for k, v in names.items()}}


def bench_phase(gops, k1_outs, main_oracle, smi) -> dict:
    """[bench]: the port's bench (mobiclipdecoder_tpu_torch/bench.py) on
    the main path's GOP 0 (its own streams: seeds 0-7, QP 0x18), counted;
    its e2e GOP == the main path's K1 frames and the oracle (streams
    0-1).  Prints the bench's JSON line."""
    from mobiclipdecoder_tpu_torch import bench
    with phase("bench"):
        zero_counts()
        report, e2e = bench.run(device="cuda", ds=(W, H, B, F),
                                frames=gops[0])
        sync_all()
        launches = read_counts()
        pro = read_prologue_counts()
        if not np.array_equal(e2e, k1_outs[0]):
            raise AssertionError("[bench] the e2e GOP differs from the main "
                                 "path's")
        for b, exp in main_oracle.items():
            if not np.array_equal(e2e[:, b], exp[:F]):
                raise AssertionError(f"[bench] e2e stream {b} differs from "
                                     f"the oracle")
        if launches[0] < 1 or launches[1] < 1:
            raise AssertionError(f"[bench] launches {launches}")
        log(f"[bench] bench.run(device='cuda'): its e2e GOP == the main "
            f"path's K1 frames and the oracle on streams "
            f"{sorted(main_oracle)}; launches whole-GOP {launches[0]}, "
            f"single-frame {launches[1]}; prologue K5 {pro[0]}, K4 {pro[1]} "
            f"| {smi}")
        log("[bench] " + json.dumps(report))
    return {"report": report, "launches": launches, "prologue": pro}


def scaling_phase(ds, gops, k1_outs, smi, devices=None) -> dict:
    """[scaling]: tools/scaling_bench over ``devices`` (default: every
    visible GPU) on the main path's GOP 0 (8 streams, 24 frames, packed
    once here): worker processes pinned to their cards and cores, and
    the in-process sharded decode.  Every worker's last GOP and the
    mesh's == the unsharded K1 output; the mesh's launches are counted
    here, each worker counts its own."""
    from mobiclipdecoder_tpu_torch.tools import scaling_bench
    with phase("scaling"):
        ops, coefs, sizes = packed_gop(ds, gops[0], (W, H))
        gop = {"ops": ops, "coefs": coefs, "sizes": sizes, "F": F, "H": H,
               "S": width_stride(W)}
        zero_counts()
        report, outs = scaling_bench.run(devices, size=(W, H), streams=B,
                                         frames=F, gop=gop)
        sync_all()
        launches = read_counts()
        pro = read_prologue_counts()
        worker_launches = {}
        for n, w in outs["workers"].items():
            worker_launches[n] = [r["launches"] for r in w["results"]]
            for k, last in enumerate(w["last"]):
                if not np.array_equal(last, k1_outs[0]):
                    raise AssertionError(f"[scaling] worker {k} of {n}: "
                                         f"last GOP differs from K1's")
            if min(worker_launches[n]) < 1:
                raise AssertionError(f"[scaling] worker launches "
                                     f"{worker_launches}")
        for n, last in outs["mesh"].items():
            if not np.array_equal(last, np.concatenate([k1_outs[0]] * n,
                                                       axis=1)):
                raise AssertionError(f"[scaling] mesh n={n} differs from "
                                     f"K1's")
        if launches[0] < 1:
            raise AssertionError(f"[scaling] mesh launches {launches}")
        log(f"[scaling] workers n = {sorted(outs['workers'])} and mesh n = "
            f"{sorted(outs['mesh'])}: every last GOP == the unsharded K1 "
            f"output; launches: mesh (this process) {launches[0]}, workers "
            f"{worker_launches} | {smi}")
        log("[scaling] " + json.dumps(report))
    return {"report": report, "launches": launches, "prologue": pro,
            "worker_launches": worker_launches}


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    kernel_only = "--kernel-only" in args
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); there is no CPU path", file=sys.stderr)
        return 1
    from mobiclipdecoder_tpu_torch.models.oracle_video import MobiclipVersion
    from mobiclipdecoder_tpu_torch.ops import (audio_kernels, executor,
                                               mesearch_kernels,
                                               prologue_kernels,
                                               wavefront_kernels)
    from mobiclipdecoder_tpu_torch.ops.vmem_engine import (VmemBatchDecoder,
                                                           VmemVideoDecoder)
    from mobiclipdecoder_tpu_torch.ops.residuals import _residuals
    from mobiclipdecoder_tpu_torch.parallel.distributed import run_worker
    from mobiclipdecoder_tpu_torch.utils import build
    t_start = time.perf_counter()
    multi = "--multi-device" in args
    ds = MobiclipVersion.MODS_DS
    mf = MobiclipVersion.MOFLEX_3DS

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"[device] {name} | count {torch.cuda.device_count()} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | {smi}")

    # [prologue]'s wide GOPs, synthesized in spawned processes meanwhile
    syn_pool = None
    if not multi:
        syn_pool = _cf.ProcessPoolExecutor(
            max_workers=len(PROLOGUE_WIDE),
            mp_context=multiprocessing.get_context("spawn"))
        wide_futs = {size: syn_pool.submit(synth_gops, mf, range(nb), 1, nf,
                                           size)
                     for size, nb, nf in PROLOGUE_WIDE}

    # 2. build: one nvcc per kernel source, started together
    t0 = time.perf_counter()
    loaders = (executor._load, prologue_kernels._load,
               wavefront_kernels._load, mesearch_kernels._load,
               audio_kernels._load)
    with _cf.ThreadPoolExecutor(len(loaders)) as tp:
        for fut in [tp.submit(load) for load in loaders]:
            fut.result()
    t_load = time.perf_counter() - t0
    for lib in ("gop_executor", "prologue", "wavefront", "sad", "audio"):
        built = build.build_seconds.get(lib)
        log(f"[build] {lib}.cu: "
            + (f"nvcc {built:.2f} s" if built is not None
               else "already built in csrc/build")
            + f"; all loaded in {t_load:.2f} s")
        for line in build.build_logs.get(lib, "").splitlines():
            if line.strip():
                log(f"[build] {line.strip()}")

    # workload: 8 DS streams x 2 GOPs; streams 0-1 of GOP 1 feed phase 3
    t0 = time.perf_counter()
    gops = synth_gops(ds, range(B), NGOPS, F)
    log(f"[workload] synthesized {B} DS streams x {NGOPS} GOPs x {F} frames "
        f"in {time.perf_counter() - t0:.1f} s")
    if multi:
        return multi_device_run(ds, mf, gops, smi, t_start)

    # 3. kernel vs plain
    with phase("kernel_vs_plain"):
        kernel_vs_plain(ds, [fr[:2] for fr in gops[0]], "DS 256x192", 1)
        *_, mf_inputs = kernel_vs_plain(mf, synth_gops(mf, [0], 1, 8)[0],
                                        "Moflex 256x192", 2)
        err, k_first_ms, plain_ms, main_inputs = kernel_vs_plain(
            ds, gops[0], "DS 256x192 main-path shape", 3)
    prologue = prologue_phase(ds, gops[0], wide_futs, smi)
    syn_pool.shutdown()
    if kernel_only:
        with phase("kernel_only"):
            wavefront_kernel_check(ds, mf, gops[0],
                                   synth_gops(mf, [7], 1, 1, WIDE[1])[0],
                                   smi)
            for size in WIDE:
                kernel_vs_plain(mf, synth_gops(mf, [7], 1, 4, size)[0],
                                f"Moflex {size[0]}x{size[1]}", 4, size)
            for size, version in (((W, H), ds), (WIDE[0], mf),
                                  (WIDE[1], mf)):
                kernel_vs_plain(version, synth_gops(version, [9], 1, 1,
                                                    size)[0],
                                f"F=1 {size[0]}x{size[1]}", 6, size)
            k1_forms_phase(smi)
            sad_kernel_check(((W, H),) + WIDE, smi)
            audio_kernel_check(smi)
        log(f"[total] {time.perf_counter() - t_start:.1f} s; --kernel-only: "
            f"no result line")
        return 0

    # 4. main path: decode_gops over 2 GOPs, ring carried across
    with phase("main_path"):
        dec = VmemBatchDecoder(W, H, ds, batch=B, native=True, device="cuda")
        zero_counts()
        t0 = time.perf_counter()
        outs = list(dec.decode_gops(iter(gops)))
        wall = time.perf_counter() - t0
        launches, _f1 = read_counts()
        main_pro = read_prologue_counts()
        # the blob path: exactly one prologue launch (K5) per GOP
        if launches < 1 or main_pro != (NGOPS, 0):
            raise AssertionError(f"main path launches: executor {launches}, "
                                 f"prologue (K5, K4) {main_pro}")
        main_planes = check_plane_form("main path", H, 256)
        for g, out in enumerate(outs):
            if out.shape != (F, B, H + H // 2, 256) or out.dtype != np.uint8:
                raise AssertionError(f"GOP {g}: shape {out.shape} {out.dtype}")
        t0 = time.perf_counter()
        main_oracle = {}
        for b in (0, 1):
            exp = oracle_frames(ds, [gops[g][f][b] for g in range(NGOPS)
                                     for f in range(F)])
            main_oracle[b] = exp
            got = np.concatenate([outs[g][:, b] for g in range(NGOPS)])
            bad = np.argwhere((got != exp).any(axis=(1, 2))).ravel()
            if bad.size:
                raise AssertionError(f"stream {b}: frames {bad.tolist()} "
                                     f"differ from the oracle")
        log(f"[main_path] decode_gops B={B} {NGOPS}x{F} frames -> "
            f"{len(outs)} x {outs[0].shape} uint8; streams 0-1 equal the "
            f"oracle on {NGOPS * F} frames each (oracle "
            f"{time.perf_counter() - t0:.1f} s); executor launches "
            f"{launches}, prologue K5 {main_pro[0]}, K4 {main_pro[1]}; wall "
            f"{wall:.2f} s incl. warm-up")

    # 5. per-frame path: 8 frames as one chunk, then 2 single-frame
    # launches (the per-round form)
    with phase("per_frame"):
        pkts = synth_gops(ds, [100], 1, 10)[0]
        pkts = [fr[0] for fr in pkts]
        vd = VmemVideoDecoder(W, H, ds, native=True, device="cuda")
        zero_counts()
        yuv, offs, err_i = vd.decode_stream_chunk(pkts[:8])
        rest = [np.concatenate(vd.decode_frame(p)) for p in pkts[8:]]
        pf_launches = read_counts()
        pf_pro = read_prologue_counts()
        check_plane_form("per-frame path", H, 256)
        if err_i is not None or yuv.shape[0] != 8 or offs != [
                len(p) for p in pkts[:8]]:
            raise AssertionError(f"decode_stream_chunk: err {err_i}, "
                                 f"{yuv.shape}, offsets {offs}")
        # one prologue launch (K5) per GOP and per F=1 round
        if (pf_launches[0] < 1 or pf_launches[1] != 2
                or pf_pro != (sum(pf_launches), 0)):
            raise AssertionError(f"per-frame path launches {pf_launches}, "
                                 f"prologue (K5, K4) {pf_pro}")
        got = np.concatenate([yuv, np.stack(rest)])
        exp = oracle_frames(ds, pkts)
        if not (got == exp).all():
            bad = np.argwhere((got != exp).any(axis=(1, 2))).ravel()
            raise AssertionError(f"per-frame path: frames {bad.tolist()} "
                                 f"differ")
        log(f"[per_frame] decode_stream_chunk(8) + decode_frame x2 equal the "
            f"oracle on 10 frames; launches: whole-GOP {pf_launches[0]}, "
            f"single-frame {pf_launches[1]}, prologue K5 {pf_pro[0]}, K4 "
            f"{pf_pro[1]}")

    # 6. timing
    with phase("timing"):
        k_ms = time_kernel(main_inputs)
        mf_k_ms = time_kernel(mf_inputs)
        mf_plain_ms = plain_on_card(mf_inputs)
        main_k = kernel_facts(k_ms, gop_work(main_inputs[0].cpu(), F, H,
                                             256), H, 256)
        log(f"[timing] executor kernel {k_ms:.3f} ms/GOP (B={B}, F={F}, "
            f"device-resident, CUDA events, mean of 20) vs plain executor "
            f"{plain_ms:.1f} ms/GOP on the host CPU (same inputs) | {smi}")
        log("[executor] " + facts_line("256x192", f"B={B} F={F}", main_k)
            + f" | {smi}")
        log(f"[timing] on the card, Moflex 256x192 B=1 F=8: kernel "
            f"{mf_k_ms:.3f} ms vs plain executor {mf_plain_ms:.1f} ms (CUDA "
            f"tensors, host clock + sync, frames equal) | {smi}")
        sweep = b_sweep(main_inputs)
        log("[b_sweep] kernel ms/GOP, main-path GOP replicated to B streams: "
            + ", ".join(f"B={nb} {ms:.3f} ms ({nb * F / ms * 1e3:.1f} "
                        f"frames/s)" for nb, ms in sweep.items())
            + f" | {smi}")
        forms = op_form_times(main_inputs)
        log("[op_forms] executor on the main-path GOP cut to one op form "
            "(B=8, F=24, mean of 10): "
            + ", ".join(f"{k} {v['ms']:.3f} ms for {v['ops_per_stream']} ops "
                        f"per stream = {v['ns_per_op']:.1f} ns/op"
                        for k, v in forms.items()) + f" | {smi}")
        stages = stage_breakdown(ds, gops[0])
        dev_ms = sum(stages[k] for k in DEVICE_STAGES)
        log("[stages] one GOP B=8 F=24, stage by stage, median of 10: "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items())
            + f"; device stages (the prologue kernel, executor, download) "
            f"{dev_ms:.3f} ms | {smi}")
        rates = sustained(ds, gops)
        med = float(np.median(rates))
        log(f"[sustained] decode_gops {SUSTAIN_GOPS} GOPs x {F * B} frames "
            f"per window (host scan + pack + upload + decode + download): "
            + ", ".join(f"{r:.1f}" for r in rates) + f" frames/s; median "
            f"{med:.1f} ({F * B / med * 1e3:.3f} ms/GOP; device stages "
            f"{dev_ms / (F * B / med * 1e3):.3f} of that wall) | {smi}")

    traced = trace_phase(ds, gops, outs, smi)
    benched = bench_phase(gops, outs, main_oracle, smi)

    # 7. the wide geometries: kernel == plain, format surface == oracle,
    # executor ms/GOP at B=8, F=24
    geo = {}
    for size in WIDE:
        label = f"{size[0]}x{size[1]}"
        with phase(f"geometry {label}"):
            t0 = time.perf_counter()
            gop = synth_gops(mf, [7], 1, F, size)[0]
            t_syn = time.perf_counter() - t0
            g_err, _k, g_plain_ms, g_in = kernel_vs_plain(
                mf, gop[:4], f"Moflex {label}", 4, size)
            g_k_ms = time_kernel(g_in, reps=10)
            t0 = time.perf_counter()
            n_surf = format_surface(mf, size)
            t_surf = time.perf_counter() - t0
            ops, coefs, sizes = packed_gop(mf, gop, size)
            nct = ops.shape[1]
            nct_used = int((ops[0, :, 0, 0] > 0).sum())
            res_c = _residuals(torch.from_numpy(coefs).cuda().view(-1, 64),
                               torch.from_numpy(sizes).cuda().view(-1)
                               ).view(1, nct, 256, 64)
            gop_in = (torch.from_numpy(ops).cuda(), res_c, g_in[2], F,
                      size[1], width_stride(size[0]))
            b8_ms = replicate(gop_in, B, reps=5)
            g_sweep = {nb: replicate(gop_in, nb, reps=5) for nb in SWEEP_B}
            S_w = width_stride(size[0])
            g_k = kernel_facts(g_k_ms, gop_work(g_in[0].cpu(), 4, size[1],
                                                S_w), size[1], S_w)
            b8_k = kernel_facts(b8_ms, gop_work(np.tile(ops, (B, 1, 1, 1)),
                                                F, size[1], S_w),
                                size[1], S_w)
            geo[label] = {"err": g_err, "ms": g_k_ms, "plain_ms": g_plain_ms,
                          "b8_f24_ms": b8_ms, "chunks": nct_used,
                          "bucket": nct, "facts": g_k, "b8_f24": b8_k,
                          "b_sweep": g_sweep, "packed": (ops, coefs, sizes)}
            log(f"[geometry] {label} stride {width_stride(size[0])}: kernel "
                f"== plain (B=1 F=4: kernel {g_k_ms:.3f} ms, mean of 10, vs "
                f"plain {g_plain_ms:.1f} ms on the host CPU); format "
                f"surface (default, table1+dqp, qp-clamp, big-levels) "
                f"{n_surf} frames == oracle through decode_stream_chunk on "
                f"the card ({t_surf:.1f} s); one 24-frame GOP is "
                f"{nct_used} chunks (bucket {nct}); executor {b8_ms:.3f} "
                f"ms/GOP at B={B}, F={F} (GOP replicated, mean of 5; "
                f"{B * F / b8_ms * 1e3:.1f} frames/s); synth {t_syn:.1f} s "
                f"| {smi}")
            log("[executor] " + facts_line(label, f"B={B} F={F}", b8_k)
                + f" | {smi}")
            log("[executor] " + facts_line(label, "B=1 F=4", g_k)
                + f" | {smi}")
            log(f"[b_sweep] {label} kernel ms/GOP, the 24-frame GOP "
                f"replicated to B streams: "
                + ", ".join(f"B={nb} {ms:.3f} ms ({nb * F / ms * 1e3:.1f} "
                            f"frames/s)" for nb, ms in g_sweep.items())
                + f" | {smi}")

    # 8. the single-frame launch (K2's form) == plain at each geometry
    k2 = {}
    with phase("k2"):
        for size, version, frame in (((W, H), ds, [gops[0][0][:1]]),
                                     (WIDE[0], mf, None), (WIDE[1], mf, None)):
            label = f"{size[0]}x{size[1]}"
            if frame is None:
                frame = synth_gops(version, [9], 1, 1, size)[0]
            e1, _k, p1, in1 = kernel_vs_plain(version, frame,
                                              f"F=1 {label}", 6, size)
            S1 = width_stride(size[0])
            k1_ms = time_kernel(in1)
            k2[label] = {"err": e1, "ms": k1_ms, "plain_ms": p1,
                         "fixed_ms_per_frame": fixed_cost_ms(size),
                         "facts": kernel_facts(k1_ms, gop_work(
                             in1[0].cpu(), 1, size[1], S1), size[1], S1)}
        log("[k2] single-frame launch (F=1, B=1, an I-frame) == plain "
            "executor at "
            + ", ".join(f"{k}: kernel {v['ms']:.3f} ms (mean of 20) vs plain "
                        f"{v['plain_ms']:.1f} ms (CPU)" for k, v in k2.items())
            + f" | {smi}")
        log("[k2] executor fixed cost per frame (16 frames with no op, B=1: "
            "zero the plane, commit it to the ring): "
            + ", ".join(f"{k} {v['fixed_ms_per_frame']:.4f} ms"
                        for k, v in k2.items()) + f" | {smi}")
        for k, v in k2.items():
            log("[executor] " + facts_line(k, "B=1 F=1", v["facts"])
                + f" | {smi}")

    # 8b. K1's cluster form against its one-block form
    with phase("k1_forms"):
        k1_forms = k1_forms_phase(smi)

    # 9. the CLI transcoder: cuda bytes == oracle bytes (the containers
    # stay for [wavefront])
    trans = {}
    trans_dir = tempfile.TemporaryDirectory()
    with phase("transcode"):
        tmp = Path(trans_dir.name)
        t0 = time.perf_counter()
        # every MODS frame carries IMA, every IMA Moflex frame but the
        # first (its audio chunk follows it), every FastAudio Moflex frame
        # (its chunk comes first): one K9 launch per launch of the
        # transcoder's schedule (1, 3, 12 and 4 frames) with IMA, one K8
        # launch per launch with FastAudio
        chunks = len(launch_lengths(TRANSCODE_FRAMES))
        cases = (
            ("mods_256x192", mods_container(TRANSCODE_FRAMES, 11, (0, 10)),
             ".mods", (W, H), chunks, 0),
            ("moflex_400x240", moflex_container(TRANSCODE_FRAMES, 12,
                                                WIDE[0]), ".moflex",
             WIDE[0], chunks - 1, 0),
            ("moflex_fastaudio_400x240", moflex_fastaudio_container(
                TRANSCODE_FRAMES, 14, WIDE[0]), ".moflex", WIDE[0], 0,
             chunks),
            ("moc5_640x480", moc5_container(TRANSCODE_FRAMES, 13, WIDE[1]),
             ".moc5", WIDE[1], 0, 0))
        log(f"[transcode] synthesized {len(cases)} containers x "
            f"{TRANSCODE_FRAMES} frames in {time.perf_counter() - t0:.1f} s")
        for cname, blob, suffix, size, ima_chunks, fa_chunks in cases:
            r = transcode_case(tmp, cname, blob, suffix, size, ima_chunks,
                               fa_chunks)
            trans[cname] = r
            log(f"[transcode] {cname}: decode --engine cuda -> "
                f"{r['files']} bytes, equal to --engine oracle; "
                f"{r['stats']['frames']} frames at {r['stats']['fps']} "
                f"frames/s (oracle {r['oracle']['fps']} frames/s); launches "
                f"whole-GOP {r['launches'][0]}, single-frame "
                f"{r['launches'][1]}, K9 {r['ima_launches']}, "
                f"K8 {r['fa_launches']}, "
                f"ramp_launches {r['ramp_launches']}; K1 one-block "
                f"shared / global, cluster "
                f"{r['planes'][0]} / {r['planes'][1]}, {r['planes'][2]} | "
                f"{smi}")

    # 10. the corpus worker: 8 streams per launch == oracle worker
    with phase("batch"), tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        files = []
        for i in range(BATCH_FILES):
            p = tmp / f"c{i}.mods"
            p.write_bytes(mods_container(2 * BATCH_GOP, 30 + i,
                                         (0, BATCH_GOP)))
            files.append(p)
        zero_counts()
        t0 = time.perf_counter()
        sc = run_worker(files, tmp / "cuda", engine="cuda", batch=B)
        t_cuda = time.perf_counter() - t0
        batch_launches = read_counts()
        batch_pro = read_prologue_counts()
        check_plane_form("batch", H, 256)
        t0 = time.perf_counter()
        so = run_worker(files, tmp / "oracle", engine="oracle")
        t_oracle = time.perf_counter() - t0
        names = sorted(p.name for p in (tmp / "oracle").glob("*.npy"))
        if (len(names) != 2 * BATCH_FILES or names != sorted(
                p.name for p in (tmp / "cuda").glob("*.npy"))):
            raise AssertionError(f"batch: shard files {names}")
        for n in names:
            if not np.array_equal(np.load(tmp / "cuda" / n),
                                  np.load(tmp / "oracle" / n)):
                raise AssertionError(f"batch: {n} differs from the oracle")
        if sc["frames"] != so["frames"] or batch_launches[0] < 1:
            raise AssertionError(f"batch: {sc} launches {batch_launches}")
        batch_fps = sc["frames"] / t_cuda
        log(f"[batch] run_worker engine=cuda batch={B}: {len(names)} shards,"
            f" {sc['frames']} frames in {t_cuda:.2f} s = {batch_fps:.1f} "
            f"frames/s (oracle worker {so['frames'] / t_oracle:.1f} "
            f"frames/s); every shard == oracle; launches whole-GOP "
            f"{batch_launches[0]} | {smi}")

    # the CPU references of [wavefront] and [encode], in spawned processes
    ctx = multiprocessing.get_context("spawn")
    with _cf.ProcessPoolExecutor(max_workers=6, mp_context=ctx) as pool:
        oracle_futs = {
            b: pool.submit(oracle_task, int(ds), (W, H),
                           [gops[g][f][b] for g in range(NGOPS)
                            for f in range(F)]) for b in range(2, B)}
        wide_pkts = {size: [fr[0] for fr in synth_gops(mf, [7], 1, WF_FRAMES,
                                                       size)[0]]
                     for size in WIDE}
        wide_futs = {size: pool.submit(oracle_task, int(mf), size, pk)
                     for size, pk in wide_pkts.items()}
        enc_sizes = ((W, H),) + WIDE
        enc_futs = {size: pool.submit(encode_task, size, "cpu")
                    for size in enc_sizes}
        try:
            wavefront = wavefront_phase(ds, gops, outs, main_oracle,
                                        oracle_futs, wide_pkts, wide_futs,
                                        trans, smi)
        finally:
            trans_dir.cleanup()
        encoded = encode_phase(mf, enc_sizes, enc_futs, smi)
    audio = audio_phase(smi)
    sharded = sharded_phase(ds, gops, outs, dec.ring.cpu().numpy(), geo, smi)
    entry_res = entry_phase(ds, smi)
    warm = warm_phase(smi)
    multi_gpu = multi_gpu_phase(smi)
    scaling = scaling_phase(ds, gops, outs, smi, ["cuda:0"])

    src = "mobiclipdecoder_tpu_torch/csrc/gop_executor.cu"
    k1 = "mobiclipdecoder_tpu/ops/vmem_engine.py:1286"
    def facts(k: dict) -> dict:
        return {key: k[key] for key in ("bound_ms", "bound_by", "plane",
                                        "smem_bytes", "ops_per_stream",
                                        "ns_per_op")}

    # no single PyTorch call computes the executor: library_ms is null
    # launches of each path that reaches the kernel, each counted from 0
    k1_paths = {f"{W}x{H}": {"main_path": launches,
                             "sharded": sharded[f"{W}x{H}"]["launches"],
                             "warm": warm[f"{W}x{H}"]["launches"][0],
                             "dryrun_multichip_32x32":
                                 entry_res["launches"][0],
                             "bench": benched["launches"][0],
                             "scaling": scaling["launches"][0]}}
    for (label, _g), cname in zip(geo.items(),
                                  ("moflex_400x240", "moc5_640x480")):
        k1_paths[label] = {"transcode": trans[cname]["launches"][0],
                           "sharded": sharded[label]["launches"],
                           "warm": warm[label]["launches"][0]}
    k1_paths[f"{WIDE[0][0]}x{WIDE[0][1]}"]["transcode_fastaudio"] = trans[
        "moflex_fastaudio_400x240"]["launches"][0]
    k2_paths = {"per_frame": pf_launches[1],
                "bench_per_round": benched["launches"][1],
                "dryrun_multichip_32x32": entry_res["launches"][1],
                **{f"warm_{g}": warm[g]["launches"][1]
                   for g in (f"{W}x{H}", "400x240", "640x480")}}
    kernels = [{
        "name": "gop_executor", "geometry": "256x192", "route": "cuda",
        "source": src, "replaces": k1,
        "launches": sum(k1_paths[f"{W}x{H}"].values()),
        "launches_by_path": k1_paths[f"{W}x{H}"],
        "plane_launches": main_planes,
        "max_abs_err": err, "ms": k_ms, "plain_ms": plain_ms,
        **facts(main_k), "library_ms": None,
        "plain_on": "host CPU", "shape": f"B={B} F={F}",
        "on_card_moflex_b1_f8": {"ms": mf_k_ms, "plain_ms": mf_plain_ms}}]
    for (label, g), cname in zip(geo.items(),
                                 ("moflex_400x240", "moc5_640x480")):
        kernels.append({
            "name": "gop_executor", "geometry": label, "route": "cuda",
            "source": src, "replaces": k1,
            "launches": sum(k1_paths[label].values()),
            "launches_by_path": k1_paths[label],
            "plane_launches": trans[cname]["planes"],
            "max_abs_err": g["err"], "ms": g["ms"],
            "plain_ms": g["plain_ms"], **facts(g["facts"]),
            "library_ms": None, "plain_on": "host CPU", "shape": "B=1 F=4",
            "b8_f24": {k: g["b8_f24"][k] for k in ("ms", "bound_ms",
                                                    "ops_per_stream",
                                                    "ns_per_op")},
            "b_sweep_ms": {str(nb): ms for nb, ms in g["b_sweep"].items()}})
    kernels.append({
        "name": "gop_executor_f1", "route": "cuda", "source": src,
        "replaces": "mobiclipdecoder_tpu/ops/vmem_engine.py:1200",
        "launches": sum(k2_paths.values()), "launches_by_path": k2_paths,
        "max_abs_err": max(v["err"] for v in k2.values()),
        "ms": k2[f"{W}x{H}"]["ms"], "plain_ms": k2[f"{W}x{H}"]["plain_ms"],
        **facts(k2[f"{W}x{H}"]["facts"]), "library_ms": None,
        "plain_on": "host CPU", "shape": f"B=1 F=1 {W}x{H}",
        "by_geometry": {k: {"err": v["err"], "ms": v["ms"],
                            "plain_ms": v["plain_ms"],
                            "fixed_ms_per_frame": v["fixed_ms_per_frame"],
                            **facts(v["facts"])} for k, v in k2.items()},
        "forms": {k: {key: v[key] for key in ("C", "took", "ms", "sweep")}
                  for k, v in k1_forms.items()}})
    # the prologue kernels: launches on every path that reaches them (K5
    # where a sparse blob is uploaded; K4 where dense arrays are: the
    # sharded paths, the entry dry run, the scaling mesh and the bench's
    # device-resident decodes), times and bounds from [prologue] at the
    # main path's geometry, every geometry beside
    blob_paths = {"main_path": main_pro, "per_frame": pf_pro,
                  **{f"transcode_{c}": r["prologue"]
                     for c, r in trans.items()},
                  "batch": batch_pro, "bench": benched["prologue"],
                  **{f"warm_{g}": r["prologue"] for g, r in warm.items()
                     if isinstance(r, dict)}}
    dense_paths = {**{f"sharded_{g}": r["prologue"]
                      for g, r in sharded.items() if isinstance(r, dict)},
                   "dryrun_multichip_32x32": entry_res["prologue"],
                   "scaling": scaling["prologue"],
                   "bench": benched["prologue"]}
    pro_src = "mobiclipdecoder_tpu_torch/csrc/prologue.cu"
    pro_err = max(v["max_abs_err"] for v in prologue.values())
    main_pc = prologue[f"{W}x{H}"]

    def pro_entry(name, kind, replaces, paths, plain, plain_what, extra):
        wk = main_pc["work"][kind]
        return {
            "name": name, "route": "cuda", "source": pro_src,
            "replaces": replaces, "launches": sum(paths.values()),
            "launches_by_path": paths, "max_abs_err": pro_err,
            "ms": main_pc["ms"][kind], "plain_ms": main_pc["ms"][plain],
            "bound_ms": wk["bound_ms"], "bound_by": wk["bound_by"],
            "library_ms": None, "plain_on": "card", "plain": plain_what,
            "shape": f"B={B} F={F} {W}x{H}", **extra,
            "by_geometry": {g: {"B": prologue[g]["B"], "F": prologue[g]["F"],
                                "ms": prologue[g]["ms"][kind],
                                "plain_ms": prologue[g]["ms"][plain],
                                **({"scatter_ms": prologue[g]["ms"][
                                    "scatter_"]} if kind == "sblob" else {}),
                                **prologue[g]["work"][kind]}
                            for g in prologue if g != "extremes"}}
    # no single PyTorch call computes K5's whole function (library_ms
    # null); Tensor.scatter_ computes its scatter part, timed beside it
    kernels.append(pro_entry(
        "prologue_sblob", "sblob",
        "mobiclipdecoder_tpu/ops/vmem_engine.py:1607 (XLA) and :215 (XLA)",
        {k: v[0] for k, v in blob_paths.items()}, "plain_chain",
        "unpack_gop_blob + _residuals",
        {"nnz": main_pc["work"]["nnz"],
         "scatter_ms": main_pc["ms"]["scatter_"],
         "scatter_call": "Tensor.scatter_ of the values into a zeroed "
                         "(B, rows * 64 + 1) buffer",
         "wrapper_ms": main_pc["ms"]["kernel_chain"]}))
    kernels.append(pro_entry(
        "prologue_rows", "rows_dense",
        "mobiclipdecoder_tpu/ops/vmem_engine.py:215 (XLA)",
        {k: v[1] for k, v in dense_paths.items()}, "plain_residuals",
        "_residuals", {}))
    # K6: launches on every path that reaches it, times and bound from
    # [wavefront] at the main path's GOP 0, the 640x480 I-frame beside
    wk6 = wavefront["kernel"]
    wf_paths = {f"wavefront_{k}": v for k, v in wavefront["launches"].items()}
    wf_paths["dryrun_multichip_32x32"] = entry_res["wavefront"]
    main_wk = wk6[f"{W}x{H}"]
    kernels.append({
        "name": "wavefront_gop", "route": "cuda",
        "source": "mobiclipdecoder_tpu_torch/csrc/wavefront.cu",
        "replaces": "mobiclipdecoder_tpu/parallel/batch.py:58 (XLA: "
                    "decode_gop_jit, a lax.scan of decode_frame_core, "
                    "mobiclipdecoder_tpu/models/pipeline.py:343)",
        "launches": sum(wf_paths.values()), "launches_by_path": wf_paths,
        "max_abs_err": max(v["max_abs_err"] for v in wk6.values()),
        "ms": main_wk["ms"], "plain_ms": main_wk["plain_ms"],
        "bound_ms": main_wk["bound_ms"], "bound_by": main_wk["bound_by"],
        "library_ms": None, "plain_on": "card",
        "plain": "decode_gop_plain",
        "shape": f"B={B} F={F} {W}x{H}, ms per GOP of one launch",
        "serial_depth": main_wk["levels"],
        "cluster": wavefront_kernels.CLUSTER,
        "by_geometry": {g: {k: v[k] for k in ("B", "F", "ms", "plain_ms",
                                              "bound_ms", "bound_by",
                                              "bytes", "levels", "split",
                                              "cluster_sweep")}
                        for g, v in wk6.items()}})
    # K7, K8, K9: no single PyTorch call computes the SAD volume, the
    # FastAudio lattice or the IMA chains (library_ms null); times and
    # bounds from [encode] at the main geometry and from [audio]
    sad = encoded["sad"]
    sad_main = sad[f"{W}x{H}"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "bytes",
            "sad_volume_call_ms")
    kernels.append({
        "name": "sad8_volume", "route": "cuda",
        "source": "mobiclipdecoder_tpu_torch/csrc/sad.cu",
        "replaces": "mobiclipdecoder_tpu/ops/mesearch.py:28-48 (XLA: "
                    "_sad8_volume)",
        "launches": sum(encoded["launches"].values()),
        "launches_by_path": encoded["launches"],
        "max_abs_err": max(v["max_abs_err"] for v in sad.values()),
        **{k: sad_main[k] for k in keys}, "library_ms": None,
        "plain_on": "card", "plain": "_sad8_volume_plain",
        "shape": f"{W}x{H} range {SAD_RANGE} R={SAD_REFS}",
        "by_geometry": {g: {k: v[k] for k in keys} for g, v in sad.items()}})
    fa = audio["fastaudio"]
    fa_main = fa[f"{FA_CHANNELS}x256"]
    fa["launches"]["transcode_moflex_fastaudio"] = trans[
        "moflex_fastaudio_400x240"]["fa_launches"]
    kernels.append({
        "name": "fastaudio_synth", "route": "cuda",
        "source": "mobiclipdecoder_tpu_torch/csrc/audio.cu",
        "replaces": "mobiclipdecoder_tpu/ops/audio_lpc.py:43 (XLA: "
                    "fastaudio_synth, _synth_jit :68)",
        "launches": sum(fa["launches"].values()),
        "launches_by_path": fa["launches"], "max_abs_err": fa["max_abs_err"],
        **{k: fa_main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "serial_steps")},
        "library_ms": None, "plain_on": "card",
        "plain": "fastaudio_synth_plain",
        "shape": f"{FA_CHANNELS} channels x 256 samples, one round",
        "corpus": {k: fa[f"{FA_CORPUS}x256"][k]
                   for k in ("ms", "plain_ms", "bound_ms")},
        "transcode_shapes": {k: {key: v[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by")}
            for k, v in fa["transcoder_shapes"].items()},
        "batch_decoder": fa["batch_decoder"]})
    ima = audio["ima"]
    ima["launches"].update(
        transcode_mods=trans["mods_256x192"]["ima_launches"],
        transcode_moflex=trans["moflex_400x240"]["ima_launches"])
    kernels.append({
        "name": "ima_scan", "route": "cuda",
        "source": "mobiclipdecoder_tpu_torch/csrc/audio.cu",
        "replaces": "mobiclipdecoder_tpu/ops/adpcm.py:47-73 (XLA: "
                    "decode_nibbles)",
        "launches": sum(ima["launches"].values()),
        "launches_by_path": ima["launches"], "max_abs_err": ima["max_abs_err"],
        **{k: ima[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None, "plain_on": "card",
        "plain": "decode_nibbles_plain", "shape": ima["shape"],
        "cases": list(ima["cases"]),
        "transcode_shapes": {k: {key: v[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by")}
            for k, v in ima["chunk_shapes"].items()}})
    for kern in kernels:
        if min(kern["launches_by_path"].values()) < 1:
            raise AssertionError(f"{kern['name']} {kern.get('geometry')}: "
                                 f"a path launched it no time: "
                                 f"{kern['launches_by_path']}")
    log("[paths] " + json.dumps({"prologue": prologue,
                                 "wavefront": wavefront, "encode": encoded,
                                 "audio": audio, "sharded": sharded,
                                 "entry": entry_res, "warm": warm,
                                 "multi_gpu": multi_gpu, "trace": traced,
                                 "bench": benched["report"],
                                 "scaling": scaling["report"]}))
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
