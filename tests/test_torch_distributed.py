"""The port's corpus worker (mobiclipdecoder_tpu_torch/parallel/
distributed.py) against the JAX package's: exactly-once coverage, resume,
lockstep batching on the port's decoder, and a two-process rendezvous
through torch.distributed (gloo on the CPU)."""
import json
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

from test_mods_e2e import _build_fixture  # noqa: E402
from test_moflex import _build_moflex  # noqa: E402

from mobiclipdecoder_tpu.parallel import distributed as jd  # noqa: E402

from mobiclipdecoder_tpu_torch.parallel.distributed import (  # noqa: E402
    gather_corpus, init_distributed, run_worker, shard_corpus)

REPO = Path(__file__).resolve().parent.parent


def _corpus(tmp_path, n_files=3, seed=20):
    files = []
    for i in range(n_files):
        p = tmp_path / f"c{i}.mods"
        p.write_bytes(_build_fixture(nframes=6, seed=seed + i,
                                     key_at=(0, 3)))
        files.append(p)
    return files


def _same_npys(a: Path, b: Path):
    names = sorted(p.name for p in a.glob("*.npy"))
    assert names and names == sorted(p.name for p in b.glob("*.npy"))
    for name in names:
        np.testing.assert_array_equal(np.load(a / name), np.load(b / name),
                                      err_msg=name)


def test_workers_cover_corpus_exactly_once(tmp_path):
    files = _corpus(tmp_path)
    out = tmp_path / "out"
    stats = [run_worker(files, out, worker_id=w, n_workers=2,
                        engine="cpu", batch=4) for w in range(2)]
    assert sum(s["shards_decoded"] for s in stats) == len(
        shard_corpus(files))
    assert gather_corpus(files, out) == {0: 6, 1: 6, 2: 6}


def test_worker_resume_skips_done_shards(tmp_path):
    files = _corpus(tmp_path, n_files=2)
    out = tmp_path / "out"
    s1 = run_worker(files, out, engine="cpu")
    assert s1["shards_decoded"] > 0 and s1["shards_skipped"] == 0
    s2 = run_worker(files, out, engine="cpu")
    assert s2["shards_decoded"] == 0
    assert s2["shards_skipped"] == s1["shards_decoded"]
    assert len((out / "worker0.ledger.jsonl").read_text().splitlines()) \
        == s1["shards_decoded"]


@pytest.mark.parametrize("batch", [1, 4, 8])
def test_lockstep_batching_matches_oracle(tmp_path, batch):
    """engine="cpu" decodes same-shape shards `batch` streams per
    executor call; its shard files equal the port's oracle worker's and
    the JAX package's oracle worker's, byte for byte."""
    files = _corpus(tmp_path, n_files=3) + [tmp_path / "m.moflex"]
    files[-1].write_bytes(_build_moflex(nframes=4, with_audio=False))
    st = run_worker(files, tmp_path / "cpu", engine="cpu", batch=batch)
    so = run_worker(files, tmp_path / "oracle", engine="oracle")
    jd.run_worker(files, tmp_path / "jax", engine="oracle")
    assert st["frames"] == so["frames"] == 22
    _same_npys(tmp_path / "cpu", tmp_path / "oracle")
    _same_npys(tmp_path / "cpu", tmp_path / "jax")


def test_unknown_engine_raises(tmp_path):
    with pytest.raises(ValueError, match="tpu"):
        run_worker(_corpus(tmp_path, n_files=1), tmp_path / "o",
                   engine="tpu")
    assert init_distributed() == (0, 1)


_WORKER = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
pre = set(sys.modules)
import torch.distributed as dist
from mobiclipdecoder_tpu_torch.parallel.distributed import (init_distributed,
                                                            run_worker)
coord, pid, nproc, out_dir = (sys.argv[2], int(sys.argv[3]),
                              int(sys.argv[4]), sys.argv[5])
rank, world = init_distributed(coord, num_processes=nproc, process_id=pid)
assert (rank, world) == (pid, nproc), (rank, world)
stats = run_worker(sys.argv[6:], out_dir, worker_id=rank, n_workers=world,
                   engine="cpu", batch=4)
dist.barrier()
stats["backend"] = dist.get_backend()
stats["world"] = world
stats["jax"] = sorted(m for m in set(sys.modules) - pre
                      if m.split(".")[0] in ("jax", "mobiclipdecoder_tpu"))
dist.destroy_process_group()
print(json.dumps(stats))
"""


def test_two_process_gloo_rendezvous(tmp_path):
    files = [str(p) for p in _corpus(tmp_path, n_files=2, seed=40)]
    out_mp = tmp_path / "out_mp"
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(REPO), f"127.0.0.1:{port}",
         str(pid), "2", str(out_mp)] + files,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(o["world"] == 2 and o["backend"] == "gloo" for o in outs)
    assert all(o["jax"] == [] for o in outs)
    assert all(o["shards_decoded"] > 0 for o in outs)
    assert gather_corpus(files, out_mp) == {0: 6, 1: 6}
    run_worker(files, tmp_path / "out_sp", engine="oracle")
    _same_npys(out_mp, tmp_path / "out_sp")
