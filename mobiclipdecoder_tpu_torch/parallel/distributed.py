"""Corpus decoding across processes: ``torch.distributed`` rendezvous and
the worker loop of the port.

The scheme is the JAX package's (``parallel/distributed.py``): GOPs are
independent (a keyframe resets all decoder state), so a corpus is cut into
GOP shards, each worker takes a deterministic share, decodes it, and
writes one ``f<file>_g<gop>.npy`` per shard plus a JSONL ledger that makes
a rerun resume where the last one stopped.  The sharding, the ledger and
the gather are shared with the JAX package; ``run_worker`` is the port's,
because the JAX one builds the JAX decoder.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..ops.vmem_engine import VmemBatchDecoder
from ..runtime.transcode import ENGINES, probe_info
from ..shared.models.oracle_video import MobiclipVersion, OracleDecoder
from ..shared.parallel.distributed import (_load_ledger, gather_corpus,
                                           shard_corpus)
from ..shared.parallel.gop import assign_shards

__all__ = ["init_distributed", "run_worker", "shard_corpus",
           "gather_corpus"]


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> tuple[int, int]:
    """Join a ``torch.distributed`` process group by TCP rendezvous at
    ``coordinator`` (``host:port``; process 0 listens there): gloo where
    there is no CUDA device, NCCL where there is.  Returns
    (rank, world_size).  With no coordinator, runs standalone: (0, 1)."""
    if coordinator is None:
        return 0, 1
    import torch
    import torch.distributed as dist
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return dist.get_rank(), dist.get_world_size()


def _geometries(files) -> dict:
    """(width, height, codec profile) of every file, by file id."""
    geos = {}
    for fid, f in enumerate(files):
        info = probe_info(f)
        if info["container"] == "moflex":
            vs = [s for s in info["streams"] if s["type"] == "video"][0]
            geos[fid] = (vs["width"], vs["height"],
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
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; the port's engines "
                         f"are {ENGINES}")
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
