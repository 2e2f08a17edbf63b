"""Corpus decoding across processes: ``torch.distributed`` rendezvous and
the worker loop of the port.

The scheme is the JAX package's (``parallel/distributed.py``): GOPs are
independent (a keyframe resets all decoder state), so a corpus is cut into
GOP shards, each worker takes a deterministic share, decodes it, and
writes one ``f<file>_g<gop>.npy`` per shard plus a JSONL ledger that makes
a rerun resume where the last one stopped.  ``_load_ledger`` and
``gather_corpus`` are copies of the JAX package's; ``shard_corpus`` is
too, and also cuts MOC5 (Wii) files; ``init_distributed`` and
``run_worker`` are the port's own.
"""
from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from ..models.oracle_video import MobiclipVersion, OracleDecoder
from ..ops.vmem_engine import VmemBatchDecoder
from ..runtime.transcode import BATCH_ENGINES, probe_info
from .gop import (GopShard, ShardProgress, assign_shards, shard_moc5,
                  shard_mods, shard_moflex)

__all__ = ["init_distributed", "run_worker", "shard_corpus",
           "gather_corpus"]


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> tuple[int, int]:
    """Join a ``torch.distributed`` process group by TCP rendezvous at
    ``coordinator`` (``host:port``; process 0 listens there): gloo where
    there is no CUDA device, NCCL where there is.  Under NCCL the process
    is pinned to its own GPU, ``LOCAL_RANK`` when that is set, else its
    rank modulo the visible GPUs, so ``"cuda"`` means that GPU from then
    on.  Returns (rank, world_size).  With no coordinator, runs
    standalone: (0, 1)."""
    if coordinator is None:
        return 0, 1
    import torch
    import torch.distributed as dist
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    rank = dist.get_rank()
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else rank % torch.cuda.device_count())
    return rank, dist.get_world_size()


def shard_corpus(files: list[str | Path]) -> list[GopShard]:
    """Cut every container file of a corpus into GOP shards."""
    shards: list[GopShard] = []
    for fid, f in enumerate(files):
        data = Path(f).read_bytes()
        if data[:4] == b"MODS":
            shards.extend(shard_mods(data, file_id=fid))
        elif data[:2] == b"\x4c\x32":
            shards.extend(shard_moflex(data, file_id=fid))
        elif data[:4] == b"MOC5":
            shards.extend(shard_moc5(data, file_id=fid))
        else:
            raise ValueError(f"{f}: not a GOP-shardable container")
    return shards


def _load_ledger(path: Path) -> ShardProgress:
    prog = ShardProgress()
    if path.exists():
        for line in path.read_text().splitlines():
            if line.strip():
                rec = json.loads(line)
                prog.done.add((rec["file_id"], rec["gop_index"]))
    return prog


def gather_corpus(files: list[str | Path], out_dir: str | Path) -> dict:
    """Host-0 gather: verify every (file, gop) shard result is present and
    stitch per-file frame counts.  Returns {file_id: total_frames}."""
    out_dir = Path(out_dir)
    shards = shard_corpus(files)
    totals: dict[int, int] = {}
    for s in shards:
        p = out_dir / f"f{s.file_id}_g{s.gop_index}.npy"
        if not p.exists():
            raise FileNotFoundError(f"missing shard result {p}")
        arr = np.load(p)
        if arr.shape[0] != s.frame_count:
            raise ValueError(f"{p}: {arr.shape[0]} frames, the shard has "
                             f"{s.frame_count}")
        totals[s.file_id] = totals.get(s.file_id, 0) + s.frame_count
    return totals


def _geometries(files) -> dict:
    """(width, height, codec profile) of every file, by file id."""
    geos = {}
    for fid, f in enumerate(files):
        info = probe_info(f)
        if info["container"] == "moflex":
            vs = [s for s in info["streams"] if s["type"] == "video"][0]
            geos[fid] = (vs["width"], vs["height"],
                         MobiclipVersion.MOFLEX_3DS)
        elif info["container"] == "moc5":
            geos[fid] = (info["width"], info["height"],
                         MobiclipVersion.MOFLEX_3DS)
        else:
            geos[fid] = (info["width"], info["height"],
                         MobiclipVersion.MODS_DS)
    return geos


def _oracle_shard(W: int, H: int, version, packets) -> np.ndarray:
    """(F, H + H/2, S) uint8 planes of one shard from the oracle."""
    dec = OracleDecoder(W, H, version)
    S = dec.stride
    planes = []
    for pkt in packets:
        dec.data = pkt
        dec.offset = 0
        dec.decode_frame()
        planes.append(np.concatenate([dec.y_planes[0].reshape(-1, S),
                                      dec.uv_planes[0].reshape(-1, S)]))
    return np.stack(planes)


def run_worker(files: list[str | Path], out_dir: str | Path,
               worker_id: int = 0, n_workers: int = 1,
               engine: str = "cuda", batch: int = 8) -> dict:
    """Decode this worker's GOP shards to per-shard .npy files of
    (F, H + H/2, S) uint8 planes.

    With ``engine`` "cuda" or "cpu", shards of one (width, height,
    profile, length) decode in lockstep, up to ``batch`` streams per
    executor launch; with "oracle" one by one.  Idempotent: the ledger
    ``<out_dir>/worker<k>.ledger.jsonl`` records finished shards, and a
    rerun skips them.  Returns summary stats."""
    if engine not in BATCH_ENGINES:
        raise ValueError(f"unknown engine {engine!r}; the corpus worker's "
                         f"engines are {BATCH_ENGINES}")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    ledger_path = out_dir / f"worker{worker_id}.ledger.jsonl"
    prog = _load_ledger(ledger_path)
    mine = assign_shards(shard_corpus(files), n_workers, worker_id)
    pending = prog.pending(mine)
    geos = _geometries(files)
    frames = 0

    def _finish(shard, out, ledger):
        nonlocal frames
        np.save(out_dir / f"f{shard.file_id}_g{shard.gop_index}.npy", out)
        ledger.write(json.dumps({"file_id": shard.file_id,
                                 "gop_index": shard.gop_index,
                                 "frames": shard.frame_count}) + "\n")
        ledger.flush()
        prog.mark(shard)
        frames += shard.frame_count

    with open(ledger_path, "a") as ledger:
        if engine == "oracle":
            for shard in pending:
                _finish(shard, _oracle_shard(*geos[shard.file_id],
                                             shard.packets), ledger)
        else:
            groups: dict[tuple, list] = {}
            for shard in pending:
                key = geos[shard.file_id] + (shard.frame_count,)
                groups.setdefault(key, []).append(shard)
            for (W, H, ver, F), shards in groups.items():
                for i in range(0, len(shards), batch):
                    grp = shards[i:i + batch]
                    dec = VmemBatchDecoder(W, H, ver, batch=len(grp),
                                           device=engine)
                    out = dec.decode_gop([[s.packets[f] for s in grp]
                                          for f in range(F)])
                    for b, shard in enumerate(grp):
                        _finish(shard, out[:, b], ledger)
    return {"worker": worker_id, "n_workers": n_workers,
            "shards_total": len(mine), "shards_decoded": len(pending),
            "shards_skipped": len(mine) - len(pending), "frames": frames}
