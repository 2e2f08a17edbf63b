"""Whole-GOP decoders: the port of ``VmemBatchDecoder`` / ``VmemVideoDecoder``
(``mobiclipdecoder_tpu/ops/vmem_engine.py``).

B independent streams decode in lockstep.  Per GOP the host C++ scanner
(``utils/native.py`` over the repository's ``native/scanner.cpp``) emits one packed part
per stream; ``ops/packing.py`` assembles them into one int32 blob, which is
uploaded once; on the device the prologue (``ops/prologue.py``
``unpack_residuals_sblob``: one kernel on the card, which gathers each
block's nonzeros and runs the IDCT pre-pass and the op widening) turns
it into the executor's inputs, and ONE executor launch (``ops/executor.py``) decodes
the whole GOP for every stream against the 6-slot reference ring, which
stays on the device across GOPs.  Dense inputs take the pre-pass kernel
alone (``ops/residuals.py`` ``residuals``); CPU tensors take the plain
versions throughout.

Every decode, single frames included, goes through this fused path (a
single frame is a GOP of one).  The stages carry the JAX engine's trace
spans at the same sites, through ``runtime/metrics.py`` ``span`` (a
``torch.profiler`` range while the profiler records, else nothing):
``mobiclip.scan`` (host scan, on the driving thread around the scan pool),
``mobiclip.pack`` (assembly of the upload blob), and the port's
``mobiclip.dispatch`` (the upload and the enqueue of K5, K1, the crop, the
ring's renormalisation and the download) and ``mobiclip.device_decode``
(the host's wait for a decode's download, on every path); a
``torch.profiler`` trace shows them beside the device's work.  Each
decoder's ``metrics`` (and the process's ``TOTALS``) count its frames,
the scans' op chunks per executor launch, and the native scan stage's
time: the scan threads' busy time, the part of it inside the native
scanner, and the stage's wall time times the threads that could run.  ``decode_gop_fused_sharded`` and
``decode_round_sharded`` split the stream batch over a list of devices,
one executor launch per shard (the JAX package's shard_map paths).
"""
from __future__ import annotations

import concurrent.futures as _cf
import time
from typing import Iterator

import numpy as np
import torch

from ..models.plan import PlanningDecoder
from ..runtime.metrics import DecodeMetrics, span
from ..state import ring_shape
from ..utils.device import check_device
from . import executor, packing
from .packing import (CHUNK, _assemble_gop_parts, _frame_chunk_spans,
                      _gop_part, _pack_gop_blob_sparse, _pack_gop_chunks,
                      _part_dense_arrays, _split_gop_part)
from .prologue import (crop_frames, crop_gop_yuv, renormalize_ring,
                       unpack_residuals_sblob)
from .residuals import residuals


def _decode_gop_resid(ring, ops, resid, F: int, H: int, S: int):
    """ONE executor launch on the executor's inputs: ops (B, NCT, CHUNK,
    4), resid (B, NCT, CHUNK, 64) spatial residual rows; ring (B, 6, R,
    SP) uint8, updated in place.  Returns (ring renormalized to slot 0 =
    newest, yuv (F, B, HH, S) uint8), both on the ring's device."""
    frames = executor.run_gop(ops.contiguous(), resid, ring, F, H, S)
    if (5 - (F - 1)) % 6:
        ring = renormalize_ring(ring, F)
    return ring, crop_frames(frames, H, S)


def _decode_gop_fused(ring, ops, coefs, sizes, F: int, H: int, S: int):
    """Whole-GOP decode of dense inputs: the IDCT pre-pass, then ONE
    executor launch.

    ops (B, NCT, CHUNK, 4) packed chunk stream; coefs (B, NCT, CHUNK, 64);
    sizes (B, NCT, CHUNK); ring (B, 6, R, SP) uint8, updated in place.
    Returns (ring renormalized to slot 0 = newest, yuv (F, B, HH, S)
    uint8), both on the ring's device."""
    resid = residuals(coefs.contiguous(), sizes.contiguous())
    return _decode_gop_resid(ring, ops, resid, F, H, S)


def _decode_gop_fused_sblob(ring, blob, F: int, nct: int, nnzb: int,
                            H: int, S: int):
    """Sparse-upload whole GOP: one blob, the prologue, one executor
    launch."""
    ops, resid = unpack_residuals_sblob(blob, ring.shape[0], nct, nnzb)
    return _decode_gop_resid(ring, ops, resid, F, H, S)


def _shard(a, k: int, per: int, device: torch.device) -> torch.Tensor:
    """Rows k*per .. (k+1)*per of a host array or tensor, on ``device``."""
    t = a[k * per:(k + 1) * per]
    if isinstance(t, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(t))
    return t.to(device)


def sharded_rings(devices, batch: int, height: int,
                  stride: int) -> list[torch.Tensor]:
    """Zero rings for ``batch`` streams split into equal shards over
    ``devices``: one (batch / n, 6, R, SP) uint8 ring per device."""
    n = len(devices)
    if n < 1 or batch % n:
        raise ValueError(f"{batch} streams do not split over {n} devices")
    return [torch.zeros(ring_shape(batch // n, height, stride),
                        dtype=torch.uint8, device=check_device(d))
            for d in devices]


def decode_gop_fused_sharded(devices, rings, ops, coefs, sizes, F: int,
                             H: int, S: int):
    """Whole-GOP decode with the stream batch split over ``devices``: the
    port of the JAX package's ``decode_gop_fused_sharded`` (its shard_map
    over a mesh's "data" axis).

    ops (B, NCT, CHUNK, 4), coefs (B, NCT, CHUNK, 64), sizes (B, NCT,
    CHUNK) are host arrays or tensors; B splits into ``len(devices)``
    equal contiguous shards (B not divisible by the count raises), and
    ``rings[k]`` is shard k's (B/n, 6, R, SP) uint8 ring on ``devices[k]``.
    Each shard's inputs are copied to its device, then each device runs
    ``_decode_gop_fused`` (one executor launch) on its shard; every
    shard's work is enqueued before any result is read, so the devices run
    at once.  A device may repeat (two shards on one card run one after
    the other on its stream).  Returns per-device lists (rings, yuvs
    (F, B/n, HH, S)); ``gather_shards`` joins them on the host."""
    devs = [check_device(d) for d in devices]
    n, B = len(devs), ops.shape[0]
    if n < 1 or B % n:
        raise ValueError(f"{B} streams do not split over {n} devices")
    if len(rings) != n:
        raise ValueError(f"{len(rings)} rings for {n} devices")
    per = B // n
    for k, (dev, ring) in enumerate(zip(devs, rings)):
        if ring.device != dev or ring.shape[0] != per:
            raise ValueError(f"ring {k}: {tuple(ring.shape)} on "
                             f"{ring.device}, expected {per} streams on "
                             f"{dev}")
    # all copies first: a copy from pageable memory waits for its stream,
    # which would hold a repeated device's next shard behind the last one
    shards = [[_shard(a, k, per, dev) for a in (ops, coefs, sizes)]
              for k, dev in enumerate(devs)]
    out = [_decode_gop_fused(ring, *args, F, H, S)
           for ring, args in zip(rings, shards)]
    return [r for r, _y in out], [y for _r, y in out]


def decode_round_sharded(devices, rings, ops, coefs, sizes, H: int, S: int):
    """One frame round (F=1) of ``decode_gop_fused_sharded``, the port of
    the JAX package's ``decode_round_sharded``: returns (rings, yuvs
    (B/n, HH, S)) per device."""
    rings, yuvs = decode_gop_fused_sharded(devices, rings, ops, coefs, sizes,
                                           1, H, S)
    return rings, [y[0] for y in yuvs]


def gather_shards(parts, axis: int = 1) -> np.ndarray:
    """Per-device results -> one host array, shards joined along the
    stream axis: 1 for GOP frames (F, B, HH, S), 0 for rings and round
    frames."""
    return np.concatenate([p.cpu().numpy() for p in parts], axis=axis)


class VmemBatchDecoder:
    """Decodes B independent streams in lockstep through the GOP executor.

    ``device`` is required: the decoder runs where it is told and never
    moves itself.  On a CUDA device the executor is the CUDA kernel; on
    the CPU it is the plain PyTorch version.  A CUDA device that is not
    there raises."""

    def __init__(self, width: int, height: int, version, batch: int = 1,
                 *, device, native: bool | None = None, crop: bool = False):
        # crop=True slices results to frame width ON DEVICE before the
        # download: (F, B, HH, W) with the UV halves repacked as U|V
        self.device = check_device(device)
        self.B = batch
        self.crop = bool(crop)
        self.width, self.height = width, height
        self.planners = [PlanningDecoder(width, height, version)
                         for _ in range(batch)]
        self.stride = self.planners[0].stride
        self.natives = None
        if native is not False:
            try:
                from ..utils.native import NativePlanner
                self.natives = [NativePlanner(width, height, int(version))
                                for _ in range(batch)]
            except (OSError, AttributeError, RuntimeError):
                if native is True:
                    raise
        self.scan_threads = min(batch, 16)
        self._pool = _cf.ThreadPoolExecutor(max_workers=self.scan_threads)
        self.ring = torch.zeros(ring_shape(batch, height, self.stride),
                                dtype=torch.uint8, device=self.device)
        self.metrics = DecodeMetrics()

    @property
    def offset(self):
        if self.natives is not None:
            return self.natives[0].offset
        return self.planners[0].offset

    def ring_frame_np(self, b: int = 0, slot: int = 0) -> np.ndarray:
        """Host copy of one ring frame as uint8 rows (G8*8, SP)."""
        with span("mobiclip.device_decode"):
            return self.ring[b, slot].cpu().numpy()

    def _scan_one(self, b: int, packet: bytes) -> dict:
        if self.natives is not None:
            return self.natives[b].scan_unified(packet)
        p = self.planners[b]
        p.data = packet
        p.offset = 0
        p.decode_frame()
        return p.unified_plan()

    def _scan_all(self, packets: list[bytes]) -> list[dict]:
        if self.natives is not None and self.B > 1:
            # the C++ scanner releases the GIL and each stream has its own
            # context: streams scan in parallel on host cores
            return list(self._pool.map(
                lambda a: self._scan_one(*a), enumerate(packets)))
        return [self._scan_one(b, pkt) for b, pkt in enumerate(packets)]

    def scan_packets(self, packets: list[bytes]) -> tuple:
        """Scan one frame per stream into the executor's packed chunk
        layout: (ops (B, nct, CHUNK, 4), coefs (B, nct, CHUNK, 64),
        sizes (B, nct, CHUNK)) host arrays.  (The JAX engine's version
        returns its per-round layout, which the port does not have.)"""
        return _pack_gop_chunks([self._scan_all(packets)], self.B)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def decode_frames(self, packets: list[bytes]) -> np.ndarray:
        """One frame per stream; returns (B, HH, S) uint8 planes.  Runs as
        the fused GOP executor with F=1."""
        yuv = self._dispatch_gop_fused([packets])
        with span("mobiclip.device_decode"):
            out = yuv[0].cpu().numpy()
        self.metrics.add(frames=self.B, bytes_in=sum(map(len, packets)))
        return out

    def _dispatch_gop_fused(self, frames: list[list[bytes]]):
        """Scan + pack + dispatch one GOP; returns the device yuv without
        waiting for the device.  The C++ scanner emits the packed parts
        directly; the per-frame plan path takes over when native scanning
        is unavailable or the GOP does not fit the native format (the C++
        state is rewound first)."""
        if self.natives is not None:
            yuv = self._dispatch_gop_native(frames)
            if yuv is not None:
                return self._maybe_crop(yuv)
        with span("mobiclip.scan"):
            plans_fb = [self._scan_all(fp) for fp in frames]
        return self._maybe_crop(self._dispatch_plans(plans_fb))

    def _maybe_crop(self, yuv):
        if not self.crop or self.width == self.stride:
            return yuv
        with span("mobiclip.dispatch"):
            return crop_gop_yuv(yuv, self.height, self.width, self.stride)

    def _dispatch_gop_native(self, frames: list[list[bytes]]):
        """Whole-GOP native scan+pack+dispatch, or None to fall back (with
        all stream states rewound to the GOP start)."""
        F = len(frames)
        if F == 0 or F >= 4096:
            return None
        per = [[frames[f][b] for f in range(F)] for b in range(self.B)]
        with span("mobiclip.scan"):
            t0 = time.perf_counter()
            for nv in self.natives:
                nv.checkpoint()
            if self.B > 1:
                res = list(self._pool.map(
                    lambda b: self.natives[b].scan_gop_packed(per[b]),
                    range(self.B)))
            else:
                res = [self.natives[0].scan_gop_packed(per[0])]
            # malformed frame, >int16 coefficient, or a stream outgrew the
            # scan buffers: rewind every stream and let the plan path redo
            # the GOP
            redo = any(r["err"] or r["val_overflow"] or r["done"] != F
                       for r in res)
            if redo:
                for nv in self.natives:
                    nv.rollback()
            wall = time.perf_counter() - t0
        self._count_scans(res, wall, self.scan_threads)
        if redo:
            return None
        return self._dispatch_parts([_gop_part(r) for r in res])

    def _count_scans(self, res: list[dict], wall: float, threads: int):
        """Adds a native scan stage of ``wall`` seconds on ``threads``
        threads, whose per-stream results are ``res``."""
        self.metrics.add(
            scan_slot_seconds=wall * threads,
            scan_busy_seconds=sum(r["seconds"] for r in res),
            scan_native_seconds=sum(r["native_seconds"] for r in res))

    def _dispatch_parts(self, parts: list[dict]):
        """Dispatch per-stream GOP parts, splitting at frame boundaries
        while any stream exceeds the chunk/nnz bucket ladders (the ring
        carries across dispatches)."""
        F = len(parts[0]["fnct"])
        if (max(q["c1"] - q["c0"] for q in parts) > packing.NCT_BUCKETS[-1]
                or max(q["idx"].size for q in parts)
                > packing.NNZ_PS_BUCKETS[-1]):
            if F <= 1:
                if (max(q["c1"] - q["c0"] for q in parts)
                        > packing.NCT_BUCKETS[-1]):
                    raise ValueError(
                        "single frame exceeds fused-GOP chunk buckets")
                # a lone frame too dense for the sparse format: dense upload
                with span("mobiclip.pack"):
                    ops, coefs, sizes = _part_dense_arrays(parts)
                with span("mobiclip.dispatch"):
                    self.ring, yuv = _decode_gop_fused(
                        self.ring, self._upload(ops), self._upload(coefs),
                        self._upload(sizes), F, self.height, self.stride)
                self._count_launch(parts)
                return yuv
            mid = F // 2
            ya = self._dispatch_parts(
                [_split_gop_part(q, 0, mid) for q in parts])
            yb = self._dispatch_parts(
                [_split_gop_part(q, mid, F) for q in parts])
            with span("mobiclip.dispatch"):
                return torch.cat([ya, yb], dim=0)
        with span("mobiclip.pack"):
            blob, nct, nnzb = _assemble_gop_parts(parts)
        with span("mobiclip.dispatch"):
            self.ring, yuv = _decode_gop_fused_sblob(
                self.ring, self._upload(blob), F, nct, nnzb, self.height,
                self.stride)
        self._count_launch(parts)
        return yuv

    def _count_launch(self, parts: list[dict]) -> None:
        """Adds the op chunks of one executor launch over ``parts``."""
        self.metrics.add(op_chunks=sum(q["c1"] - q["c0"] for q in parts))

    def _dispatch_plans(self, plans_fb: list[list[dict]]):
        """Pack pre-scanned per-frame plans and dispatch the GOP, split
        into consecutive dispatches when its chunk stream would overflow
        the largest bucket."""
        cap = packing.NCT_BUCKETS[-1]
        totals = [0] * self.B
        for row in plans_fb:
            for b, p in enumerate(row):
                n = int(p["ops"][0, 0])
                totals[b] += len(_frame_chunk_spans(p["ops"][1:1 + n]))
        if max(totals) > cap and len(plans_fb) > 1:
            mid = len(plans_fb) // 2
            ya = self._dispatch_plans(plans_fb[:mid])
            yb = self._dispatch_plans(plans_fb[mid:])
            with span("mobiclip.dispatch"):
                return torch.cat([ya, yb], dim=0)
        return self._dispatch_plans_one(plans_fb, sum(totals))

    def _dispatch_plans_one(self, plans_fb: list[list[dict]], chunks: int):
        F = len(plans_fb)
        with span("mobiclip.pack"):
            ops, coefs, sizes = _pack_gop_chunks(plans_fb, self.B)
            nct = ops.shape[1]
            sp = _pack_gop_blob_sparse(ops, coefs,
                                       sizes.reshape(self.B, nct * CHUNK))
        with span("mobiclip.dispatch"):
            if sp is not None:
                blob, nnzb = sp
                self.ring, yuv = _decode_gop_fused_sblob(
                    self.ring, self._upload(blob), F, nct, nnzb,
                    self.height, self.stride)
            else:
                self.ring, yuv = _decode_gop_fused(
                    self.ring, self._upload(ops), self._upload(coefs),
                    self._upload(sizes), F, self.height, self.stride)
        self.metrics.add(op_chunks=chunks)
        return yuv

    def _start_download(self, yuv: torch.Tensor):
        """Begin the device->host copy of a GOP's planes; returns
        (host tensor, event or None)."""
        if yuv.device.type != "cuda":
            return yuv.contiguous(), None
        host = torch.empty(yuv.shape, dtype=yuv.dtype, pin_memory=True)
        host.copy_(yuv, non_blocking=True)
        # the copy was enqueued on the current stream of yuv's device,
        # which need not be the current device
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(yuv.device))
        return host, ev

    def decode_gops(self, gops) -> Iterator[np.ndarray]:
        """Streaming multi-GOP decode: GOP n's download runs (pinned
        buffer, non-blocking copy) while GOP n+1 is scanned on the host
        and decoded on the device.  Yields (F, B, HH, S) uint8 per GOP, in
        order."""
        pending = None
        for frames in gops:
            yuv = self._dispatch_gop_fused(frames)
            with span("mobiclip.dispatch"):
                nxt = self._start_download(yuv)
            self.metrics.add(frames=len(frames) * self.B,
                             bytes_in=sum(sum(map(len, fp)) for fp in frames))
            if pending is not None:
                yield self._finish(*pending)
            pending = nxt
        if pending is not None:
            yield self._finish(*pending)

    def _finish(self, host, ev) -> np.ndarray:
        with span("mobiclip.device_decode"):
            if ev is not None:
                ev.synchronize()
            return host.numpy()

    def decode_gop(self, frames: list[list[bytes]],
                   fused: bool = True) -> np.ndarray:
        """frames[f][b] = packet of frame f of stream b; returns
        (F, B, HH, S) uint8 (W columns with crop=True).

        The whole GOP runs as ONE executor launch with one upload and one
        download.  ``fused`` is kept for the JAX package's signature: the
        per-frame launch forms are not ported, so ``fused=False`` takes
        the same fused path."""
        del fused
        yuv = self._dispatch_gop_fused(frames)
        with span("mobiclip.device_decode"):
            out = yuv.cpu().numpy()
        self.metrics.add(frames=len(frames) * self.B,
                         bytes_in=sum(sum(map(len, fp)) for fp in frames))
        return out


class VmemVideoDecoder(VmemBatchDecoder):
    """Single-stream convenience wrapper."""

    def __init__(self, width: int, height: int, version, *, device,
                 native: bool | None = None, crop: bool = False):
        super().__init__(width, height, version, batch=1, device=device,
                         native=native, crop=crop)

    def decode_stream_chunk(self, packets: list[bytes]
                            ) -> tuple[np.ndarray, list[int], int | None]:
        """Decode consecutive frames of ONE stream as one fused dispatch
        (the transcoder's throughput path).

        Returns (yuv (K, HH, S) uint8, K end offsets, err_index): the K
        successfully scanned prefix frames are decoded and committed to
        the ring; ``err_index`` is the index of the packet whose scan
        failed (its frame is NOT decoded), or None when the whole chunk
        scanned.  One native scanner_scan_gop call covers the chunk; a
        coefficient beyond int16 rewinds it and the remainder takes the
        per-packet plan path."""
        yuvs: list[np.ndarray] = []
        offsets: list[int] = []
        err = None
        rem = list(packets)
        ndone = 0
        nv = self.natives[0] if self.natives is not None else None
        while rem and nv is not None:
            with span("mobiclip.scan"):
                ts = time.perf_counter()
                nv.checkpoint()
                r = nv.scan_gop_packed(rem)
                if r["val_overflow"]:
                    nv.rollback()
                wall = time.perf_counter() - ts
            self._count_scans([r], wall, 1)
            if r["val_overflow"]:
                break
            done = r["done"]
            offsets.extend(int(c) for c in r["consumed"])
            if done:
                yuv = self._maybe_crop(self._dispatch_parts([_gop_part(r)]))
                with span("mobiclip.device_decode"):
                    yuvs.append(yuv[:, 0].cpu().numpy())
                ndone += done
                rem = rem[done:]
            if r["err"]:
                err = ndone
                rem = []
                break
            if done == 0:
                # a frame bigger than the native scan caps: the per-packet
                # plan path below has no such limits
                break
        if rem and err is None:
            plans_fb: list[list[dict]] = []
            with span("mobiclip.scan"):
                for i, pkt in enumerate(rem):
                    try:
                        plans_fb.append([self._scan_one(0, pkt)])
                        offsets.append(self.offset)
                    except Exception:
                        # per-frame containment: a malformed packet ends
                        # the chunk at its index; the caller decides what
                        # follows
                        err = ndone + i
                        break
            if plans_fb:
                yuv = self._maybe_crop(self._dispatch_plans(plans_fb))
                with span("mobiclip.device_decode"):
                    yuvs.append(yuv[:, 0].cpu().numpy())
                ndone += len(plans_fb)
        out_w = self.width if self.crop else self.stride
        out = (np.concatenate(yuvs, axis=0) if yuvs else
               np.zeros((0, self.height + self.height // 2, out_w),
                        np.uint8))
        self.metrics.add(frames=ndone,
                         bytes_in=sum(map(len, packets[:ndone])))
        return out, offsets, err

    def decode_frame(self, packet: bytes) -> tuple[np.ndarray, np.ndarray]:
        out = self.decode_frames([packet])[0]
        H = self.height
        return out[:H], out[H:]
