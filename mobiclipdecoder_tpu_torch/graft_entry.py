"""Entry points of the port: one frame's reconstruction as a function with
example arguments, and a multi-device dry run.

The port's counterpart of the repository's ``__graft_entry__.py`` (the JAX
package's hooks, which stay as they are).  ``entry()`` returns the
wavefront engine's ``decode_frame_core`` for a 64x48 DS I-frame with its
arguments on a device.  ``dryrun_multichip(n)`` runs the three multi-device
paths of the JAX dry run over a list of n devices: ``BatchVideoDecoder``
over the devices (the JAX package's mesh), then ``decode_round_sharded``
and ``decode_gop_fused_sharded`` (its shard_map paths).  Where the JAX dry
run checks shapes, this one holds every sharded result equal to the same
decode on one device.  The streams are independent, so no collective is
needed: each device decodes its own shard.

    python -c "from mobiclipdecoder_tpu_torch.graft_entry import \\
        dryrun_multichip; dryrun_multichip(2, devices=['cpu', 'cpu'])"
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .models.oracle_video import MobiclipVersion
from .models.pipeline import decode_frame_core, prepare_plan, upload_plan
from .models.plan import PlanningDecoder
from .ops.packing import _pack_gop_chunks
from .ops.vmem_engine import (VmemBatchDecoder, _decode_gop_fused,
                              decode_gop_fused_sharded, decode_round_sharded,
                              gather_shards, sharded_rings)
from .parallel.batch import BatchVideoDecoder, stack_plans
from .testing.synth import StreamSynthesizer
from .utils.device import check_device

DS = MobiclipVersion.MODS_DS


def _example_plan(W: int = 64, H: int = 48, seed: int = 0):
    """prepare_plan() arrays of a synthesized DS I-frame (QP 0x18), and
    the stride."""
    synth = StreamSynthesizer(W, H, DS, seed=seed)
    planner = PlanningDecoder(W, H, DS)
    planner.data = synth.iframe(0x18)
    planner.decode_frame()
    return prepare_plan(planner.plan()), planner.stride


def entry(device="cuda"):
    """Returns (fn, example_args): ``fn(*example_args)`` reconstructs one
    64x48 DS I-frame, (1, 72, 256) int32, on ``device``.  The ring
    (1, 6, 72, 256) int32 and the plan tensors carry a leading batch of 1;
    ``n_levels`` stays on the host."""
    dev = check_device(device)
    W, H = 64, 48
    arrays, S = _example_plan(W, H)
    t = upload_plan(stack_plans([arrays]), dev)
    ring = torch.zeros((1, 6, H + H // 2, S), dtype=torch.int32, device=dev)
    fn = functools.partial(decode_frame_core, H=H, S=S)
    example_args = (ring, t["mc"], t["resid"], t["resid_coef"], t["iops"],
                    t["icoef"], t["seqmap"], t["n_levels"])
    return fn, example_args


def _same(label: str, got: np.ndarray, want: np.ndarray) -> None:
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(f"dryrun_multichip: {label} differs from the "
                             f"one-device decode")


def _one_device(ring, arrays, F: int, H: int, S: int):
    """``_decode_gop_fused`` of host arrays on the ring's device."""
    up = [torch.from_numpy(a).to(ring.device) for a in arrays]
    return _decode_gop_fused(ring, *up, F, H, S)


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run the three sharded decode paths over ``devices`` (default
    ``cuda:0`` .. ``cuda:n-1``; fewer visible GPUs raise) on 32x32 DS
    streams, each result held equal to the same decode on ``devices[0]``
    alone, and print one summary line."""
    if devices is None:
        visible = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if visible < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}) needs "
                               f"{n_devices} GPUs, {visible} visible")
        devices = [f"cuda:{k}" for k in range(n_devices)]
    if len(devices) != n_devices:
        raise ValueError(f"{len(devices)} devices for n_devices="
                         f"{n_devices}")
    devs = [check_device(d) for d in devices]
    W, H = 32, 32

    # 1. the wavefront engine over the devices: an I-frame round, then a
    # P-frame round (ring carry and MC)
    B = n_devices if n_devices > 1 else 2
    synths = [StreamSynthesizer(W, H, DS, seed=b) for b in range(B)]
    bd = BatchVideoDecoder(W, H, DS, batch=B, devices=devs)
    one = BatchVideoDecoder(W, H, DS, batch=B, device=devs[0])
    for kind in ("I", "P"):
        pkts = [s.iframe(0x18) if kind == "I" else s.pframe()
                for s in synths]
        out = bd.decode_frames(pkts)
        _same(f"BatchVideoDecoder {kind}-frame round", out,
              one.decode_frames(pkts))
    _same("BatchVideoDecoder ring", bd.ring.cpu().numpy(),
          one.ring.cpu().numpy())

    # 2. the executor's frame round (F=1) over the devices, 2 rounds
    B2 = n_devices
    S = bd.stride
    synths2 = [StreamSynthesizer(W, H, DS, seed=b) for b in range(B2)]
    vd = VmemBatchDecoder(W, H, DS, batch=B2, device=devs[0])
    rings = sharded_rings(devs, B2, H, S)
    ring1 = vd.ring
    for i in range(2):
        pkts = [s.iframe(0x18) if i == 0 else s.pframe() for s in synths2]
        ops, coefs, sizes = vd.scan_packets(pkts)
        rings, yuvs = decode_round_sharded(devs, rings, ops, coefs, sizes, H,
                                           S)
        ring1, yuv1 = _one_device(ring1, (ops, coefs, sizes), 1, H, S)
        _same(f"decode_round_sharded round {i}", gather_shards(yuvs, 0),
              yuv1[0].cpu().numpy())
    _same("decode_round_sharded ring", gather_shards(rings, 0),
          ring1.cpu().numpy())

    # 3. the whole-GOP executor over the devices, F=3
    F = 3
    synths3 = [StreamSynthesizer(W, H, DS, seed=b) for b in range(B2)]
    gframes = [[s.iframe(0x18) if f == 0 else s.pframe() for s in synths3]
               for f in range(F)]
    vg = VmemBatchDecoder(W, H, DS, batch=B2, device=devs[0])
    plans_fb = [vg._scan_all(fp) for fp in gframes]
    gops, gcoefs, gsizes = _pack_gop_chunks(plans_fb, B2)
    grings, gyuvs = decode_gop_fused_sharded(
        devs, sharded_rings(devs, B2, H, S), gops, gcoefs, gsizes, F, H, S)
    gring1, gyuv1 = _one_device(vg.ring, (gops, gcoefs, gsizes), F, H, S)
    gyuv = gather_shards(gyuvs)
    _same("decode_gop_fused_sharded frames", gyuv, gyuv1.cpu().numpy())
    _same("decode_gop_fused_sharded ring", gather_shards(grings, 0),
          gring1.cpu().numpy())
    scan_kind = ("native C++" if (vd.natives is not None
                                  and vg.natives is not None)
                 else "python plan")
    names = ", ".join(str(d) for d in devs)
    print(f"dryrun_multichip ok: {n_devices} devices [{names}]; "
          f"BatchVideoDecoder batch {B}, out {out.shape}; frame rounds "
          f"over {n_devices} devices ok; fused GOP over {n_devices} devices "
          f"ok (F={F}, out {gyuv.shape}); every result == one device; "
          f"host scan = {scan_kind}")
