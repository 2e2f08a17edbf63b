"""Benchmark of the port on one card: the counterpart of the repository's
``bench.py`` (the JAX package's headline harness), with its metric names.

    python -m mobiclipdecoder_tpu_torch.bench [--device cuda]

B synthesized DS MODS 256x192 streams (seeds 0..B-1, an I-frame at QP
0x18 then P-frames) decode in lockstep through ``VmemBatchDecoder``'s
fused whole-GOP path (ops/vmem_engine.py).  Prints ONE JSON line:

  per_round_fps       each frame round as one F=1 executor launch of
                      ``_decode_gop_fused_sblob`` (its blob uploaded), the
                      ring carried, results left on the device;
  fused_gop_fps       one blob upload plus one executor launch per GOP;
  device_compute_fps  the whole-GOP decode with its inputs resident on the
                      device (``_decode_gop_fused``), CUDA events;
  host_scan_fps       the native scan of one GOP over the decoder's pool
                      of scanners and the blob's assembly (the scanners
                      are rewound after each scan);
  e2e_fps             one ``decode_gop``: scan, pack, upload, decode and
                      download to host numpy;
  e2e_sustained_fps   ``decode_gops`` over SUSTAIN_GOPS GOPs (GOP n's
                      download overlaps GOP n+1);
  wii_640x480_fps, wii_device_compute_fps
                      the fused-GOP and device-resident rates at 640x480
                      (stride 1024, Moflex profile);
  e2e_400x240_cropped_fps, wii_e2e_cropped_fps
                      ``decode_gops`` with ``crop=True`` at 400x240 and
                      640x480 (the device crops each row to frame width
                      before the download);
  value               max(per_round_fps, fused_gop_fps).

Every rate is the MEDIAN of WINDOWS windows, and ``spread`` gives each
one's [min, max]; the JAX bench reports the best window instead.  A window
starts after a ``torch.cuda.synchronize`` and ends with one; the device-
only rates are timed with CUDA events, the others on the host clock.
``h2d_MBps`` and ``d2h_MBps`` time a 4 MiB copy each way.  ``compile_s``
is the nvcc and g++ seconds this process spent building the libraries the
bench runs (0, with ``built`` false, when they were already built).
``device`` names the card with ``nvidia-smi``'s name and power limit, and
the host's core count and CPU model: the host stages set the end-to-end
rates, and they move with the host.

Every path's output is checked against the others (the same GOP decoded
by each); a section that fails raises.  Without a CUDA device,
``device="cuda"`` raises: there is no CPU fallback.  ``run(device="cpu",
...)`` at small sizes runs the same code with the plain executor, for the
tests; its rates are CPU numbers, not the card's.
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import subprocess
import sys
import time

import numpy as np
import torch

from .models.oracle_video import MobiclipVersion
from .ops.packing import (CHUNK, _assemble_gop_parts, _gop_part,
                          _pack_gop_blob_sparse, _pack_gop_chunks)
from .ops.vmem_engine import (VmemBatchDecoder, _decode_gop_fused,
                              _decode_gop_fused_sblob)
from .testing.synth import StreamSynthesizer
from .tools.warm_kernels import warm_builds
from .utils.device import check_device

WINDOWS = 3
SUSTAIN_GOPS = 8            # GOPs per decode_gops window at 256x192
CROPPED_GOPS = {"moflex": 3, "wii": 2}
PROBE_BYTES = 4 << 20
BASELINE_FPS = 24.0         # realtime DS playback, the C# reference's claim

DS = MobiclipVersion.MODS_DS
MF = MobiclipVersion.MOFLEX_3DS


def synth_gop(width: int, height: int, version, streams: int,
              frames: int) -> list[list[bytes]]:
    """gop[f][b]: frame f of stream b (seed b), an I-frame at QP 0x18 then
    P-frames."""
    synths = [StreamSynthesizer(width, height, version, seed=b)
              for b in range(streams)]
    return [[s.iframe(0x18) if f == 0 else s.pframe() for s in synths]
            for f in range(frames)]


def sync(dev) -> None:
    """Synchronize a CUDA device, or each of a list of devices."""
    for d in dev if isinstance(dev, (list, tuple)) else [dev]:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def window_rates(step, n_frames: int, reps: int, dev,
                 events: bool = False) -> list[float]:
    """Frames/s of WINDOWS windows of ``reps`` calls of ``step()``, each
    window between two synchronizations of ``dev`` (a device, or a list
    of devices): on the host clock, or with CUDA events recorded around
    the calls when ``events`` (device-only work on one CUDA device)."""
    rates = []
    for _ in range(WINDOWS):
        sync(dev)
        if events and dev.type == "cuda":
            stream = torch.cuda.current_stream(dev)
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record(stream)
            for _ in range(reps):
                step()
            e1.record(stream)
            sync(dev)
            seconds = e0.elapsed_time(e1) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                step()
            sync(dev)
            seconds = time.perf_counter() - t0
        rates.append(n_frames * reps / seconds)
    return rates


def _same(label: str, got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(f"bench: {label} differs")


def scan_gop_blob(dec: VmemBatchDecoder, frames) -> tuple:
    """One GOP through ``dec``'s native scanners in its thread pool, as
    ``decode_gop`` scans it, and the upload blob assembled from the parts:
    (blob, nct, nnzb).  The scanners are rewound after, so every call
    starts from the same state."""
    nf = len(frames)
    per = [[fr[b] for fr in frames] for b in range(dec.B)]
    for nv in dec.natives:
        nv.checkpoint()
    try:
        res = list(dec._pool.map(
            lambda b: dec.natives[b].scan_gop_packed(per[b]), range(dec.B)))
    finally:
        for nv in dec.natives:
            nv.rollback()
    if any(r["err"] or r["val_overflow"] or r["done"] != nf for r in res):
        raise RuntimeError("bench: the native scan of the GOP failed")
    return _assemble_gop_parts([_gop_part(r) for r in res])


class _Resident:
    """A GOP's dense executor inputs resident on the device, decoded again
    and again from one ring (``_decode_gop_fused``)."""

    def __init__(self, width, height, version, frames, dev):
        dec = VmemBatchDecoder(width, height, version, batch=len(frames[0]),
                               device=dev, native=True)
        ops, coefs, sizes = _pack_gop_chunks(
            [dec._scan_all(fp) for fp in frames], dec.B)
        self.args = [dec._upload(a) for a in (ops, coefs, sizes)]
        self.ring, self.F, self.H, self.S = (dec.ring, len(frames), height,
                                             dec.stride)
        self.nct = ops.shape[1]
        self.yuv = None

    def step(self) -> None:
        self.ring, self.yuv = _decode_gop_fused(self.ring, *self.args,
                                                self.F, self.H, self.S)


class _Blob:
    """A GOP's upload blob (host), uploaded and decoded again and again
    from one ring (``_decode_gop_fused_sblob``)."""

    def __init__(self, dec: VmemBatchDecoder, frames):
        self.dec = dec
        self.blob, self.nct, self.nnzb = scan_gop_blob(dec, frames)
        self.ring, self.F = dec.ring.clone(), len(frames)
        self.yuv = None

    def step(self) -> None:
        d = self.dec
        self.ring, self.yuv = _decode_gop_fused_sblob(
            self.ring, d._upload(self.blob), self.F, self.nct, self.nnzb,
            d.height, d.stride)


def _per_round(dec: VmemBatchDecoder, frames):
    """The per-round form: each frame's scan as its own upload (sparse
    blob, or the dense arrays when the sparse form does not fit) and F=1
    launch.  Scans the frames with ``dec``'s scanners (their state
    advances).  Returns step(), which runs every round once and returns
    the last round's frames (1, B, HH, S)."""
    rounds = []
    for fp in frames:
        ops, coefs, sizes = dec.scan_packets(fp)
        nct = ops.shape[1]
        sp = _pack_gop_blob_sparse(ops, coefs, sizes.reshape(dec.B,
                                                            nct * CHUNK))
        rounds.append((ops, coefs, sizes, nct, sp))
    ring = dec.ring.clone()

    def step():
        nonlocal ring
        for ops, coefs, sizes, nct, sp in rounds:
            if sp is not None:
                ring, yuv = _decode_gop_fused_sblob(
                    ring, dec._upload(sp[0]), 1, nct, sp[1], dec.height,
                    dec.stride)
            else:
                ring, yuv = _decode_gop_fused(
                    ring, *(dec._upload(a) for a in (ops, coefs, sizes)), 1,
                    dec.height, dec.stride)
        return yuv
    return step


def _sustained(dec: VmemBatchDecoder, frames, n_gops: int):
    """decode_gops over ``n_gops`` copies of one GOP; step() returns the
    last GOP."""
    def step():
        out = None
        for arr in dec.decode_gops(frames for _ in range(n_gops)):
            out = arr
        return out
    return step


def link_rates(dev: torch.device) -> tuple[list[float], list[float]]:
    """MB/s of WINDOWS copies of PROBE_BYTES from pageable host memory to
    ``dev``, and back."""
    probe = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, PROBE_BYTES, dtype=np.uint8))
    on_dev = torch.empty_like(probe, device=dev)
    back = torch.empty_like(probe)
    up = window_rates(lambda: on_dev.copy_(probe), PROBE_BYTES / 1e6, 1, dev)
    down = window_rates(lambda: back.copy_(on_dev), PROBE_BYTES / 1e6, 1,
                        dev)
    _same("the link probe's round trip", back.numpy(), probe.numpy())
    return up, down


def describe(dev: torch.device) -> dict:
    """The device and the host: for a card, torch's name and nvidia-smi's
    name and power limit; the host's cores and CPU model."""
    out = {"name": "cpu", "smi": None, "count": 0}
    if dev.type == "cuda":
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60)
        lines = res.stdout.strip().splitlines()
        out = {"name": torch.cuda.get_device_name(dev),
               "smi": lines[min(dev.index, len(lines) - 1)],
               "count": torch.cuda.device_count()}
    return {**out, "host_cores": os.cpu_count(), "cpu_model": cpu_model()}


def cpu_model() -> str:
    """The host CPU's model name from /proc/cpuinfo; where a virtual
    machine hides it ("unknown"), its vendor, family and model numbers;
    else the machine type."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                key, _, val = ln.partition(":")
                if not key.strip():
                    break                       # the first CPU's block
                info.setdefault(key.strip().lower(), val.strip())
    except OSError:
        pass
    name = info.get("model name", "")
    if name and name != "unknown":
        return name
    if "vendor_id" in info:
        return (f"{name or 'unnamed'} ({info['vendor_id']} family "
                f"{info.get('cpu family', '?')} model "
                f"{info.get('model', '?')})")
    return platform.machine() or "unknown"


def run(device="cuda", ds=(256, 192, 8, 24), wii=(640, 480, 2, 8),
        moflex=(400, 240, 4, 12), reps: int = 3, frames=None
        ) -> tuple[dict, np.ndarray]:
    """Run every section on ``device``.  ``ds``, ``wii`` and ``moflex`` are
    (width, height, streams, frames) of the 256x192 DS, the 640x480 and
    the 400x240 GOPs; ``reps`` is the calls per window of the launch-only
    sections (the device-resident ones take 3x as many).  ``frames`` is
    the DS GOP (``synth_gop(*ds, ...)``'s) when the caller has
    synthesized it already.  Returns (the JSON report, the GOP the e2e
    windows decoded, (F, B, HH, S) uint8)."""
    dev = check_device(device)
    builds = warm_builds(dev)
    W, H, B, F = ds
    if frames is None:
        frames = synth_gop(W, H, DS, B, F)
    if (len(frames), len(frames[0])) != (F, B):
        raise ValueError(f"frames: {len(frames)} x {len(frames[0])}, "
                         f"expected {F} x {B}")
    rates: dict[str, list[float]] = {}

    # host scan and pack, the e2e path's form
    bd = VmemBatchDecoder(W, H, DS, batch=B, device=dev, native=True)
    scan_gop_blob(bd, frames)                       # warm: page in buffers
    rates["host_scan_fps"] = window_rates(lambda: scan_gop_blob(bd, frames),
                                          B * F, reps, dev)

    # the fused whole-GOP launch, its blob uploaded each call
    fused = _Blob(bd, frames)
    fused.step()
    rates["fused_gop_fps"] = window_rates(fused.step, B * F, reps, dev)

    # one F=1 launch per frame round (scans with bd's scanners)
    rounds = _per_round(bd, frames)
    last = rounds()
    rates["per_round_fps"] = window_rates(rounds, B * F, reps, dev)
    _same("per-round decode's last frame vs the fused GOP's", last[0].cpu(),
          fused.yuv[-1].cpu())

    # the fused launch with its inputs resident on the device
    res = _Resident(W, H, DS, frames, dev)
    if res.nct != fused.nct:
        raise AssertionError(f"bench: plan-path nct {res.nct} != native "
                             f"{fused.nct}")
    res.step()
    rates["device_compute_fps"] = window_rates(res.step, B * F, 3 * reps,
                                               dev, events=True)
    _same("device-resident decode vs the fused GOP", res.yuv.cpu(),
          fused.yuv.cpu())

    up, down = link_rates(dev)
    rates["h2d_MBps"], rates["d2h_MBps"] = up, down

    # end to end: one decode_gop, then decode_gops
    bd2 = VmemBatchDecoder(W, H, DS, batch=B, device=dev, native=True)
    e2e = bd2.decode_gop(frames)                    # warm
    _same("decode_gop vs the fused GOP", e2e, fused.yuv.cpu())
    outs = []
    rates["e2e_fps"] = window_rates(
        lambda: outs.append(bd2.decode_gop(frames)), B * F, 1, dev)
    for out in outs:
        _same("a repeated decode_gop", out, e2e)
    sus = _sustained(bd2, frames, SUSTAIN_GOPS)
    rates["e2e_sustained_fps"] = window_rates(
        lambda: outs.append(sus()), B * F * SUSTAIN_GOPS, 1, dev)
    _same("decode_gops' last GOP", outs[-1], e2e)

    # 640x480: the fused launch, and its inputs resident
    ww, wh, wb, wf = wii
    wframes = synth_gop(ww, wh, MF, wb, wf)
    wblob = _Blob(VmemBatchDecoder(ww, wh, MF, batch=wb, device=dev,
                                   native=True), wframes)
    wblob.step()
    rates["wii_640x480_fps"] = window_rates(wblob.step, wb * wf, reps, dev)
    wres = _Resident(ww, wh, MF, wframes, dev)
    wres.step()
    rates["wii_device_compute_fps"] = window_rates(wres.step, wb * wf,
                                                   3 * reps, dev, events=True)
    _same("640x480 device-resident vs fused", wres.yuv.cpu(),
          wblob.yuv.cpu())

    # cropped end to end at 400x240 and 640x480
    cropped = {}
    for key, (cw, ch, cb, cf), name, gop in (
            ("moflex", moflex, "e2e_400x240_cropped_fps", None),
            ("wii", wii, "wii_e2e_cropped_fps", wframes)):
        gop = gop or synth_gop(cw, ch, MF, cb, cf)
        dec = VmemBatchDecoder(cw, ch, MF, batch=cb, device=dev, native=True,
                               crop=True)
        step = _sustained(dec, gop, CROPPED_GOPS[key])
        cropped[key] = step()                       # warm
        rates[name] = window_rates(step, cb * cf * CROPPED_GOPS[key], 1, dev)
        if cropped[key].shape != (cf, cb, ch + ch // 2, cw):
            raise AssertionError(f"bench: {name} shape "
                                 f"{cropped[key].shape}")
    _same("640x480 cropped vs uncropped luma", cropped["wii"][:, :, :wh],
          wblob.yuv[:, :, :wh, :ww].cpu())

    med = {k: float(np.median(v)) for k, v in rates.items()}
    value = max(med["per_round_fps"], med["fused_gop_fps"])
    report = {
        "metric": f"mods_{W}x{H}_device_decode_fps_per_chip",
        "value": value,
        "unit": "frames/s",
        "vs_baseline": value / BASELINE_FPS,
        "batch_streams": B,
        "gop_frames": F,
        **{k: med[k] for k in (
            "per_round_fps", "fused_gop_fps", "device_compute_fps",
            "host_scan_fps", "e2e_fps", "e2e_sustained_fps",
            "wii_640x480_fps", "wii_device_compute_fps",
            "e2e_400x240_cropped_fps", "wii_e2e_cropped_fps",
            "h2d_MBps", "d2h_MBps")},
        "compile_s": sum(b["compile_s"] or 0.0 for b in builds.values()),
        "built": any(b["compile_s"] is not None for b in builds.values()),
        "device": describe(dev),
        "spread": {k: [min(v), max(v)] for k, v in rates.items()},
    }
    return report, e2e


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mobiclipdecoder_tpu_torch.bench")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    report, _gop = run(device=args.device)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
