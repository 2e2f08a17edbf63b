"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the executor kernel from mobiclipdecoder_tpu_torch/csrc with nvcc,
holds it against its plain PyTorch version, drives the main path (the
fused whole-GOP decode of 8 DS MODS 256x192 streams, 2 GOPs of 24 frames)
and the per-frame path, checks both against the sequential oracle, and
times the kernel and the decoder.  Every phase raises on a mismatch.

Prints one line per phase, then a JSON line describing each kernel, the
card's name and power limit, and last a JSON line
{"ok": true, "device": {...}}.  Needs a CUDA device; without one it exits
non-zero and prints no result.  Imports nothing of JAX: the codec modules
it shares with the JAX package come through mobiclipdecoder_tpu_torch.shared.

Besides the checks it measures, on the same card in the same run: the
executor's time at B = 8, 32, 128 and 256 streams, the time of each stage
of one GOP's dispatch, the plain executor on the card against the kernel
at the Moflex shape, and the sustained frames/s of decode_gops over three
windows of SUSTAIN_GOPS GOPs.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

W, H = 256, 192
B, F = 8, 24
NGOPS = 2
SUSTAIN_GOPS = 120          # about 3 s of decode_gops per window
SWEEP_B = (8, 32, 128, 256)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def synth_gops(version, seeds, ngops, nframes):
    """gops[g][f][b]: packet of frame f of stream b in GOP g (each GOP
    starts with an I-frame)."""
    from mobiclipdecoder_tpu_torch.shared.testing.synth import StreamSynthesizer
    synths = [StreamSynthesizer(W, H, version, seed=s) for s in seeds]
    return [[[s.iframe(0x18) if f == 0 else s.pframe() for s in synths]
             for f in range(nframes)] for _ in range(ngops)]


def oracle_frames(version, packets):
    """(len(packets), HH, S) uint8 from the sequential oracle."""
    from mobiclipdecoder_tpu_torch.shared.models.oracle_video import OracleDecoder
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


def packed_gop(version, gop):
    """Native scan of one GOP -> (ops, coefs, sizes) host arrays, the
    executor's inputs before the residual pre-pass."""
    from mobiclipdecoder_tpu_torch.shared.utils.native import NativePlanner
    from mobiclipdecoder_tpu_torch.ops.packing import (_gop_part,
                                                       _part_dense_arrays)
    nb = len(gop[0])
    parts = []
    for b in range(nb):
        r = NativePlanner(W, H, int(version)).scan_gop_packed(
            [fr[b] for fr in gop])
        if r["err"] or r["val_overflow"] or r["done"] != len(gop):
            raise RuntimeError(f"native scan of stream {b} failed")
        parts.append(_gop_part(r))
    return _part_dense_arrays(parts)


def kernel_vs_plain(version, gop, label, seed):
    """Run one packed GOP through the CUDA kernel and through the plain
    executor on the CPU, from the same random ring; frames and ring must
    be equal.  Returns (max_abs_err, kernel_ms, plain_ms, inputs)."""
    from mobiclipdecoder_tpu_torch import state
    from mobiclipdecoder_tpu_torch.ops import executor
    from mobiclipdecoder_tpu_torch.ops.residuals import _residuals
    ops, coefs, sizes = packed_gop(version, gop)
    nb, nct = ops.shape[:2]
    nf = len(gop)
    S = 256
    ring0 = np.random.default_rng(seed).integers(
        0, 256, state.ring_shape(nb, H, S)).astype(np.uint8)

    def resid(dev):
        c = torch.from_numpy(coefs).to(dev).view(-1, 64)
        s = torch.from_numpy(sizes).to(dev).view(-1)
        return _residuals(c, s).view(nb, nct, 256, 64)

    ops_c = torch.from_numpy(ops).cuda()
    res_c = resid("cuda")
    ring_c = torch.from_numpy(ring0).cuda()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    frames_c = executor.run_gop(ops_c, res_c, ring_c, nf, H, S)
    e1.record()
    torch.cuda.synchronize()
    k_ms = e0.elapsed_time(e1)
    ring_p = torch.from_numpy(ring0.copy())
    t0 = time.perf_counter()
    frames_p = executor.run_gop(torch.from_numpy(ops), resid("cpu"), ring_p,
                                nf, H, S)
    p_ms = (time.perf_counter() - t0) * 1e3
    err = max(
        int((frames_c.cpu().to(torch.int32)
             - frames_p.to(torch.int32)).abs().max()),
        int((ring_c.cpu().to(torch.int32)
             - ring_p.to(torch.int32)).abs().max()))
    if err != 0:
        raise AssertionError(f"{label}: kernel != plain, max abs err {err}")
    log(f"[kernel_vs_plain] {label} B={nb} F={nf} nct={nct}: frames and "
        f"ring equal (max abs err 0); kernel {k_ms:.3f} ms (first launch), "
        f"plain {p_ms:.1f} ms (CPU)")
    return err, k_ms, p_ms, (ops_c, res_c, ring_c, nf)


def plain_on_card(inputs) -> float:
    """The plain executor run on CUDA tensors (the same inputs as the
    kernel's); its frames must equal the kernel's.  Returns its ms."""
    from mobiclipdecoder_tpu_torch import state
    from mobiclipdecoder_tpu_torch.ops import executor
    from mobiclipdecoder_tpu_torch.ops.executor_ref import run_gop_ref
    ops_c, res_c, ring_c, nf = inputs
    ring_k, ring_p = ring_c.clone(), ring_c.clone()
    frames_k = executor.run_gop(ops_c, res_c, ring_k, nf, H, 256)
    frames_p = torch.empty_like(frames_k)
    tabs = state.kernel_tables(ops_c.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_gop_ref(ops_c, res_c, ring_p, frames_p, tabs, H, 256)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if not (torch.equal(frames_k, frames_p) and torch.equal(ring_k, ring_p)):
        raise AssertionError("plain executor on the card != kernel")
    return ms


def time_kernel(inputs, reps=20) -> float:
    """Mean kernel time (ms) over `reps` launches, device-resident."""
    from mobiclipdecoder_tpu_torch.ops import executor
    ops_c, res_c, ring_c, nf = inputs
    for _ in range(3):
        executor.run_gop(ops_c, res_c, ring_c, nf, H, 256)
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        executor.run_gop(ops_c, res_c, ring_c, nf, H, 256)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def b_sweep(inputs) -> dict:
    """Kernel ms/GOP with the main-path GOP replicated to each B of
    SWEEP_B streams (one block per stream)."""
    ops_c, res_c, _ring, nf = inputs
    out = {}
    for nb in SWEEP_B:
        k = nb // ops_c.shape[0]
        ring = torch.zeros((nb,) + tuple(_ring.shape[1:]), dtype=torch.uint8,
                           device="cuda")
        out[nb] = time_kernel((ops_c.repeat(k, 1, 1, 1).contiguous(),
                               res_c.repeat(k, 1, 1, 1).contiguous(), ring,
                               nf))
    return out


def stage_breakdown(version, gop, reps=10) -> dict:
    """Median ms of each stage of one fused GOP dispatch (B streams, F
    frames), run stage by stage with a sync between stages: host stages
    on the host clock, device stages with CUDA events."""
    from mobiclipdecoder_tpu_torch.ops import executor
    from mobiclipdecoder_tpu_torch.ops.packing import (CHUNK,
                                                       _assemble_gop_parts,
                                                       _gop_part)
    from mobiclipdecoder_tpu_torch.ops.prologue import (crop_frames,
                                                        unpack_gop_blob)
    from mobiclipdecoder_tpu_torch.ops.residuals import _residuals
    from mobiclipdecoder_tpu_torch.ops.vmem_engine import VmemBatchDecoder
    dec = VmemBatchDecoder(W, H, version, batch=B, native=True,
                           device="cuda")
    per = [[fr[b] for fr in gop] for b in range(B)]
    hhs = H + H // 2
    host = torch.empty((F, B, hhs, 256), dtype=torch.uint8, pin_memory=True)
    names = ("host scan", "assemble blob", "upload blob", "unpack blob",
             "residuals", "executor", "download")
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
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        ops, coefs, sizes = unpack_gop_blob(blob_d, B, nct, nnzb)
        ev[1].record()
        resid = _residuals(coefs.reshape(-1, 64), sizes.reshape(-1)).view(
            B, nct, CHUNK, 64)
        ev[2].record()
        frames = executor.run_gop(ops, resid, dec.ring, F, H, 256)
        ev[3].record()
        host.copy_(crop_frames(frames, H, 256), non_blocking=True)
        ev[4].record()
        torch.cuda.synchronize()
        for k, v in zip(names, [(t1 - t0) * 1e3, (t2 - t1) * 1e3,
                                (t3 - t2) * 1e3]
                        + [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]):
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); there is no CPU path", file=sys.stderr)
        return 1
    from mobiclipdecoder_tpu_torch.shared.models.oracle_video import MobiclipVersion
    from mobiclipdecoder_tpu_torch.ops import executor
    from mobiclipdecoder_tpu_torch.ops.vmem_engine import (VmemBatchDecoder,
                                                           VmemVideoDecoder)
    from mobiclipdecoder_tpu_torch.utils import build

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"[device] {name} | count {torch.cuda.device_count()} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | {smi}")

    # 2. build
    t0 = time.perf_counter()
    executor._load()
    built = build.build_seconds.get("gop_executor")
    log(f"[build] gop_executor.cu: "
        + (f"nvcc {built:.2f} s" if built is not None
           else "already built in csrc/build")
        + f", load {time.perf_counter() - t0:.2f} s")

    # workload: 8 DS streams x 2 GOPs; streams 0-1 of GOP 1 feed phase 3
    ds = MobiclipVersion.MODS_DS
    t0 = time.perf_counter()
    gops = synth_gops(ds, range(B), NGOPS, F)
    log(f"[workload] synthesized {B} DS streams x {NGOPS} GOPs x {F} frames "
        f"in {time.perf_counter() - t0:.1f} s")

    # 3. kernel vs plain
    kernel_vs_plain(ds, [fr[:2] for fr in gops[0]], "DS 256x192", 1)
    mf = MobiclipVersion.MOFLEX_3DS
    *_, mf_inputs = kernel_vs_plain(mf, synth_gops(mf, [0], 1, 8)[0],
                                    "Moflex 256x192", 2)
    err, k_first_ms, plain_ms, main_inputs = kernel_vs_plain(
        ds, gops[0], "DS 256x192 main-path shape", 3)

    # 4. main path: decode_gops over 2 GOPs, ring carried across
    dec = VmemBatchDecoder(W, H, ds, batch=B, native=True, device="cuda")
    executor.launches = 0
    t0 = time.perf_counter()
    outs = list(dec.decode_gops(iter(gops)))
    wall = time.perf_counter() - t0
    launches = executor.launches
    if launches < 1:
        raise AssertionError("main path launched no executor kernel")
    for g, out in enumerate(outs):
        if out.shape != (F, B, H + H // 2, 256) or out.dtype != np.uint8:
            raise AssertionError(f"GOP {g}: shape {out.shape} {out.dtype}")
    t0 = time.perf_counter()
    for b in (0, 1):
        exp = oracle_frames(ds, [gops[g][f][b] for g in range(NGOPS)
                                 for f in range(F)])
        got = np.concatenate([outs[g][:, b] for g in range(NGOPS)])
        bad = np.argwhere((got != exp).any(axis=(1, 2))).ravel()
        if bad.size:
            raise AssertionError(f"stream {b}: frames {bad.tolist()} differ "
                                 f"from the oracle")
    log(f"[main_path] decode_gops B={B} {NGOPS}x{F} frames -> "
        f"{len(outs)} x {outs[0].shape} uint8; streams 0-1 equal the oracle "
        f"on {NGOPS * F} frames each (oracle {time.perf_counter() - t0:.1f}"
        f" s); executor launches {launches}; wall {wall:.2f} s incl. warm-up")

    # 5. per-frame path
    pkts = synth_gops(ds, [100], 1, 10)[0]
    pkts = [fr[0] for fr in pkts]
    vd = VmemVideoDecoder(W, H, ds, native=True, device="cuda")
    yuv, offs, err_i = vd.decode_stream_chunk(pkts[:8])
    if err_i is not None or yuv.shape[0] != 8 or offs != [len(p) for p in
                                                         pkts[:8]]:
        raise AssertionError(f"decode_stream_chunk: err {err_i}, "
                             f"{yuv.shape}, offsets {offs}")
    rest = [np.concatenate(vd.decode_frame(p)) for p in pkts[8:]]
    got = np.concatenate([yuv, np.stack(rest)])
    exp = oracle_frames(ds, pkts)
    if not (got == exp).all():
        bad = np.argwhere((got != exp).any(axis=(1, 2))).ravel()
        raise AssertionError(f"per-frame path: frames {bad.tolist()} differ")
    log("[per_frame] decode_stream_chunk(8) + decode_frame x2 equal the "
        "oracle on 10 frames")

    # 6. timing
    k_ms = time_kernel(main_inputs)
    mf_k_ms = time_kernel(mf_inputs)
    mf_plain_ms = plain_on_card(mf_inputs)
    # op rows per stream: the chunk headers' counts (at most 255 each)
    rows = int(main_inputs[0][:, :, 0, 0].clamp(0, 255).sum()) // B
    log(f"[timing] executor kernel {k_ms:.3f} ms/GOP (B={B}, F={F}, "
        f"device-resident, CUDA events, mean of 20; {rows} op rows per "
        f"stream, {k_ms * 1e3 / rows:.3f} us each) vs plain executor "
        f"{plain_ms:.1f} ms/GOP on the host CPU (same inputs) | {smi}")
    log(f"[timing] on the card, Moflex 256x192 B=1 F=8: kernel "
        f"{mf_k_ms:.3f} ms vs plain executor {mf_plain_ms:.1f} ms (CUDA "
        f"tensors, host clock + sync, frames equal) | {smi}")
    sweep = b_sweep(main_inputs)
    log("[b_sweep] kernel ms/GOP, main-path GOP replicated to B streams: "
        + ", ".join(f"B={nb} {ms:.3f} ms ({nb * F / ms * 1e3:.1f} frames/s)"
                    for nb, ms in sweep.items()) + f" | {smi}")
    stages = stage_breakdown(ds, gops[0])
    dev_ms = sum(stages[k] for k in ("unpack blob", "residuals", "executor",
                                     "download"))
    log("[stages] one GOP B=8 F=24, stage by stage, median of 10: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items())
        + f"; device stages {dev_ms:.3f} ms | {smi}")
    rates = sustained(ds, gops)
    med = float(np.median(rates))
    log(f"[sustained] decode_gops {SUSTAIN_GOPS} GOPs x {F * B} frames per "
        f"window (host scan + pack + upload + decode + download): "
        + ", ".join(f"{r:.1f}" for r in rates) + f" frames/s; median "
        f"{med:.1f} ({F * B / med * 1e3:.3f} ms/GOP; device stages "
        f"{dev_ms / (F * B / med * 1e3):.3f} of that wall) | {smi}")

    log(json.dumps({"kernels": [{
        "name": "gop_executor", "route": "cuda",
        "source": "mobiclipdecoder_tpu_torch/csrc/gop_executor.cu",
        "replaces": "mobiclipdecoder_tpu/ops/vmem_engine.py:1286",
        "launches": launches, "max_abs_err": err,
        "ms": k_ms, "plain_ms": plain_ms, "plain_on": "host CPU",
        "on_card_moflex_b1_f8": {"ms": mf_k_ms,
                                 "plain_ms": mf_plain_ms}}]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
