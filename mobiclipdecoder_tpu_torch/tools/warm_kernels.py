"""Build the port's native libraries and make each geometry's first
launches before serving: the port of the repository's
``tools/warm_kernels.py``.

    python -m mobiclipdecoder_tpu_torch.tools.warm_kernels 256x192 400x240 640x480
    python -m mobiclipdecoder_tpu_torch.tools.warm_kernels 256x192 --batch 8 --frames 24 --device cuda

Builds the executor kernel (``csrc/gop_executor.cu``), the prologue
kernels (``csrc/prologue.cu``), the wavefront engine's kernel
(``csrc/wavefront.cu``), the encoder's SAD-volume kernel (``csrc/sad.cu``)
and the audio kernels (``csrc/audio.cu``) with nvcc, on a CUDA device
only, and the
C++ scanner (``native/scanner.cpp``, g++) into the git-ignored
``mobiclipdecoder_tpu_torch/csrc/build/``, then decodes, per
geometry, one synthesized GOP through ``VmemBatchDecoder`` (one whole-GOP
launch) and two single frames (two F=1 launches), and prints the build
seconds and each geometry's first-launch seconds.  One build serves every
shape, so there are no shape buckets to warm.  640x480 keeps the JAX
tool's cut: at most 2 streams and 8 frames.
"""
from __future__ import annotations

import argparse
import sys
import time

from ..models.oracle_video import MobiclipVersion
from ..ops import (audio_kernels, executor, mesearch_kernels,
                   prologue_kernels, wavefront_kernels)
from ..ops.vmem_engine import VmemBatchDecoder
from ..testing.synth import StreamSynthesizer
from ..utils import build, native
from ..utils.device import check_device


def warm_builds(device) -> dict:
    """Load the scanner and, on a CUDA device, the executor, the prologue
    kernels, K6, K7 and the audio kernels (K8, K9), compiling each one
    that is missing or stale;
    returns per library the seconds this took and the seconds of its
    compile in this process (None when it was already built)."""
    loaders = {"mobiscan": native._load}
    if check_device(device).type == "cuda":
        loaders["gop_executor"] = executor._load
        loaders["prologue"] = prologue_kernels._load
        loaders["wavefront"] = wavefront_kernels._load
        loaders["sad"] = mesearch_kernels._load
        loaders["audio"] = audio_kernels._load
    out = {}
    for name, load in loaders.items():
        t0 = time.perf_counter()
        load()
        out[name] = {"s": time.perf_counter() - t0,
                     "compile_s": build.build_seconds.get(name)}
    return out


def warm_geometry(w: int, h: int, batch: int, frames: int, device) -> dict:
    """One GOP of ``frames`` frames of ``batch`` synthesized streams, then
    two single frames, through fresh decoders; returns their seconds."""
    ver = (MobiclipVersion.MODS_DS if w <= 256
           else MobiclipVersion.MOFLEX_3DS)
    synths = [StreamSynthesizer(w, h, ver, seed=b) for b in range(batch)]
    gop = [[s.iframe(0x18) if f == 0 else s.pframe() for s in synths]
           for f in range(frames)]
    t0 = time.perf_counter()
    out = VmemBatchDecoder(w, h, ver, batch=batch, device=device,
                           native=True).decode_gop(gop)
    t_gop = time.perf_counter() - t0
    dec = VmemBatchDecoder(w, h, ver, batch=batch, device=device,
                           native=True)
    t0 = time.perf_counter()
    for f in range(min(2, frames)):
        dec.decode_frames(gop[f])
    return {"gop_s": t_gop, "frames_s": time.perf_counter() - t0,
            "shape": out.shape}


def warm(geometries: list[str], batch: int = 8, frames: int = 24,
         device="cuda") -> dict:
    """Builds, then every geometry ("WxH") in turn; returns
    {"builds": ..., "WxH": {...}}."""
    out = {"builds": warm_builds(device)}
    for g in geometries:
        w, h = (int(v) for v in g.lower().split("x"))
        b = batch if w <= 512 else min(batch, 2)
        f = frames if w <= 512 else min(frames, 8)
        out[g] = dict(warm_geometry(w, h, b, f, device), batch=b, frames=f)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mobiclipdecoder_tpu_torch.tools.warm_kernels")
    ap.add_argument("geometries", nargs="+", metavar="WxH",
                    help="e.g. 256x192 400x240 640x480")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = warm(args.geometries, args.batch, args.frames, args.device)
    for name, b in res.pop("builds").items():
        print(f"build {name}: ready in {b['s']:.2f} s ("
              + ("already built" if b["compile_s"] is None
                 else f"compiled in {b['compile_s']:.2f} s") + ")",
              flush=True)
    for g, r in res.items():
        print(f"{g}: GOP (B={r['batch']}, F={r['frames']}) first launch "
              f"{r['gop_s']:.2f} s -> {r['shape']}; {min(2, r['frames'])} "
              f"single frames {r['frames_s']:.2f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
