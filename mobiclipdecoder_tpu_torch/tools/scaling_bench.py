"""Scaling harness of the port: the counterpart of the repository's
``tools/scaling_bench.py``, with its names.

    python -m mobiclipdecoder_tpu_torch.tools.scaling_bench
    python -m mobiclipdecoder_tpu_torch.tools.scaling_bench --devices cpu --mesh-devices cpu,cpu --size 64x48 --streams 2 --frames 3

Two measurements, over n = 1, 2, 4, 8 devices up to the number given
(default: every visible GPU; without one it raises):

1. ``worker_scaling``: n processes, worker k on ``devices[k]`` and pinned
   to host core k (``sched_setaffinity``), each decoding the same
   pre-scanned, pre-packed GOP again and again with its results left on
   its device (``decode_gop_fused_sharded`` over its one device, the host
   arrays passed each call).  The parent waits for every worker's
   "ready" line (its warm-up launch done), then releases them together.
   ``worker_fps[n]`` is the sum of the workers' frames/s and
   ``worker_efficiency[n]`` = worker_fps[n] / (n * worker_fps[1]), with
   worker_fps[1] the better of two solo runs, as the JAX tool takes it.
2. ``mesh_scaling``: one process, ``decode_gop_fused_sharded`` over
   ``mesh_devices[:n]`` with the GOP's streams repeated n times (the same
   work per device), the host arrays passed each call as the JAX tool
   passes them to its sharded round; the process pinned to n cores.

Each rate is the median of ``bench.WINDOWS`` windows, each window ended by
synchronizing every device.  The work per device defaults to the main
path's: DS 256x192, 8 streams (seeds 0..7), one 24-frame GOP.  Prints one
JSON line with the JAX tool's names (``worker_fps``, ``worker_efficiency``,
``mesh_fps``, ``mesh_efficiency``, ``devices``, ``host_cores``,
``backend``), the geometry and the card (``bench.describe``).
"""
from __future__ import annotations

import argparse
import json
import os
import selectors
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..bench import DS, describe, sync, synth_gop, window_rates
from ..ops import executor
from ..ops.packing import _pack_gop_chunks
from ..ops.vmem_engine import (VmemBatchDecoder, decode_gop_fused_sharded,
                               gather_shards, sharded_rings)
from ..utils.device import check_device

ROOT = Path(__file__).resolve().parents[2]
COUNTS = (1, 2, 4, 8)
READY_S = 600.0             # a worker's start, build load and warm-up


def packed_gop(width: int, height: int, streams: int, frames: int):
    """One synthesized DS GOP scanned and packed on the host: (ops, coefs,
    sizes) executor inputs, F, H and the stride."""
    gop = synth_gop(width, height, DS, streams, frames)
    dec = VmemBatchDecoder(width, height, DS, batch=streams, device="cpu",
                           native=True)
    arrays = _pack_gop_chunks([dec._scan_all(fp) for fp in gop], streams)
    return {"ops": arrays[0], "coefs": arrays[1], "sizes": arrays[2],
            "F": frames, "H": height, "S": dec.stride}


def _cores() -> list[int]:
    return sorted(os.sched_getaffinity(0))


def _pin(cores) -> None:
    try:
        os.sched_setaffinity(0, set(cores))
    except OSError:
        pass


class _Decode:
    """The packed GOP decoded over ``devs`` (its streams repeated once per
    device) from per-device rings; step() is one sharded call."""

    def __init__(self, devs, gop: dict):
        n = len(devs)
        self.devs = devs
        self.arrays = [np.concatenate([gop[k]] * n)
                       for k in ("ops", "coefs", "sizes")]
        self.F, self.H, self.S = gop["F"], gop["H"], gop["S"]
        self.frames = self.arrays[0].shape[0] * self.F
        self.rings = sharded_rings(devs, self.arrays[0].shape[0], self.H,
                                   self.S)
        self.yuvs = None

    def step(self) -> None:
        self.rings, self.yuvs = decode_gop_fused_sharded(
            self.devs, self.rings, *self.arrays, self.F, self.H, self.S)

    def rates(self, reps: int) -> list[float]:
        self.step()                                 # warm
        return window_rates(self.step, self.frames, reps, self.devs)


def worker(device: str, core: int, gop_path: str, out_path: str,
           reps: int) -> int:
    """One pinned single-device decode worker: warm up, print "ready",
    wait for the parent's line on stdin, time the windows, save the last
    GOP to ``out_path`` and print {"fps", "spread", "launches"}."""
    cores = _cores()
    _pin([cores[core % len(cores)]])
    dev = check_device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    with np.load(gop_path) as z:
        gop = {k: z[k] for k in z.files}
    dec = _Decode([dev], {**gop, **{k: int(gop[k]) for k in "FHS"}})
    dec.step()
    sync(dec.devs)
    print("ready", flush=True)
    sys.stdin.readline()
    rates = window_rates(dec.step, dec.frames, reps, dec.devs)
    np.save(out_path, gather_shards(dec.yuvs))
    print(json.dumps({"fps": float(np.median(rates)),
                      "spread": [min(rates), max(rates)],
                      "launches": executor.launches + executor.frame_launches,
                      "device": str(dev)}), flush=True)
    return 0


def _read_ready(procs, logs) -> None:
    """Wait until every worker has printed "ready"; a worker that exits or
    prints anything else, or a wait past READY_S, raises."""
    waiting = set(range(len(procs)))
    deadline = time.monotonic() + READY_S
    with selectors.DefaultSelector() as sel:
        for k, p in enumerate(procs):
            sel.register(p.stdout, selectors.EVENT_READ, k)
        while waiting:
            events = sel.select(timeout=max(0.0,
                                            deadline - time.monotonic()))
            if not events:
                raise RuntimeError(f"scaling workers {sorted(waiting)} not "
                                   f"ready after {READY_S} s")
            for key, _mask in events:
                k = key.data
                line = procs[k].stdout.readline()
                if line.strip() != "ready":
                    procs[k].wait(timeout=60)
                    raise RuntimeError(f"scaling worker {k} exit "
                                       f"{procs[k].returncode}: {line!r}\n"
                                       f"{logs[k].read_text()}")
                sel.unregister(procs[k].stdout)
                waiting.discard(k)


def launch_workers(devices, gop_path: str, tmp: Path, reps: int):
    """One worker per device, started together and released together;
    returns their results and their last GOPs."""
    procs, logs = [], []
    try:
        for k, dev in enumerate(devices):
            logs.append(tmp / f"worker{k}.log")
            with open(logs[-1], "w") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "mobiclipdecoder_tpu_torch.tools.scaling_bench",
                     "--worker", dev, str(k), gop_path,
                     str(tmp / f"out{k}.npy"), str(reps)],
                    stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                    stderr=err, text=True, cwd=ROOT))
        _read_ready(procs, logs)
        for p in procs:
            p.stdin.write("go\n")
            p.stdin.flush()
        results = []
        for k, p in enumerate(procs):
            out, _ = p.communicate(timeout=READY_S)
            if p.returncode != 0:
                raise RuntimeError(f"scaling worker {k} exit {p.returncode}:"
                                   f"\n{logs[k].read_text()}")
            results.append(json.loads(out.strip().splitlines()[-1]))
        return results, [np.load(tmp / f"out{k}.npy")
                         for k in range(len(devices))]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _counts(n_max: int) -> list[int]:
    return [n for n in COUNTS if n <= n_max]


def worker_scaling(devices, gop: dict, reps: int = 3):
    """{n: summed frames/s} over n = 1, 2, 4, 8 workers up to
    len(devices), the solo run taken twice (the better kept), and {n:
    {"results": each worker's printed result, "last": each worker's last
    GOP}} from the last run of each n."""
    fps, outs = {}, {}
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        gop_path = str(tmp / "gop.npz")
        np.savez(gop_path, **gop)
        for n in _counts(len(devices)) + [1]:
            res, last = launch_workers(devices[:n], gop_path, tmp, reps)
            total = sum(r["fps"] for r in res)
            if n in fps:
                fps[n] = max(fps[n], total)
            else:
                fps[n] = total
            outs[n] = {"results": res, "last": last}
    return fps, outs


def mesh_scaling(devices, gop: dict, reps: int = 3):
    """{n: frames/s} of the sharded decode over devices[:n], n = 1, 2, 4,
    8 up to len(devices), this process pinned to n cores; and {n: the
    last GOP, shards joined}."""
    devs = [check_device(d) for d in devices]
    cores = _cores()
    fps, outs = {}, {}
    try:
        for n in _counts(len(devs)):
            _pin(cores[:n])
            dec = _Decode(devs[:n], gop)
            fps[n] = float(np.median(dec.rates(reps)))
            outs[n] = gather_shards(dec.yuvs)
    finally:
        _pin(cores)
    return fps, outs


def run(devices=None, mesh_devices=None, size=(256, 192), streams: int = 8,
        frames: int = 24, reps: int = 3, gop=None):
    """Both measurements; ``devices`` default to every visible GPU (none
    raises) and ``mesh_devices`` to ``devices``.  ``gop`` is
    ``packed_gop(*size, streams, frames)``'s result when the caller has
    packed the GOP already.  Returns (the JSON report, {"workers":
    worker_scaling's outputs, "mesh": {n: the last GOP}, "gop": the
    packed GOP})."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [f"cuda:{k}" for k in range(n)] or ["cuda"]
    mesh_devices = list(devices if mesh_devices is None else mesh_devices)
    first = check_device(devices[0])
    if gop is None:
        gop = packed_gop(*size, streams, frames)
    if gop["ops"].shape[0] != streams or gop["F"] != frames:
        raise ValueError(f"gop: {gop['ops'].shape[0]} streams x {gop['F']} "
                         f"frames, expected {streams} x {frames}")
    wfps, wouts = worker_scaling(list(devices), gop, reps)
    mfps, mouts = mesh_scaling(mesh_devices, gop, reps)
    report = {
        "metric": "decode_scaling",
        "geometry": f"{size[0]}x{size[1]}",
        "streams_per_device": streams, "gop_frames": frames,
        "worker_fps": {str(k): v for k, v in wfps.items()},
        "worker_efficiency": {str(k): v / (k * wfps[1])
                              for k, v in wfps.items()},
        "mesh_fps": {str(k): v for k, v in mfps.items()},
        "mesh_efficiency": {str(k): v / (k * mfps[1])
                            for k, v in mfps.items()},
        "devices": len(mesh_devices),
        "host_cores": os.cpu_count(),
        "backend": first.type,
        "card": describe(first),
    }
    return report, {"workers": wouts, "mesh": mouts, "gop": gop}


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if args[:1] == ["--worker"]:
        dev, core, gop_path, out_path, reps = args[1:6]
        return worker(dev, int(core), gop_path, out_path, int(reps))
    ap = argparse.ArgumentParser(
        prog="python -m mobiclipdecoder_tpu_torch.tools.scaling_bench")
    ap.add_argument("--devices", help="comma-separated, e.g. cuda:0,cuda:1 "
                    "(default: every visible GPU)")
    ap.add_argument("--mesh-devices", help="default: --devices")
    ap.add_argument("--size", default="256x192")
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args(args)
    split = (lambda s: s.split(",") if s else None)
    report, _outs = run(split(a.devices), split(a.mesh_devices),
                        tuple(int(v) for v in a.size.lower().split("x")),
                        a.streams, a.frames, a.reps)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
