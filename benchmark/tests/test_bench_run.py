"""run.py prints no result, and exits with another code than 0, where it
finds no card, and where the program is not beside it."""
from __future__ import annotations

import shutil
import subprocess
import sys

import pytest
import torch

from benchmark.harness import spec

def _run(cwd):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "moflex_corpus_b8",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=120)


def test_no_card_no_result():
    res = _run(spec.REPO)
    assert res.returncode == 2
    assert "{" not in res.stdout
    assert "needs 1 CUDA card" in res.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.REPO / "BENCHMARK.json", tmp_path)
    res = _run(tmp_path)
    assert res.returncode != 0 and "{" not in res.stdout
