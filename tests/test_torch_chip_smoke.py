"""chip_smoke.py has no CPU path: without a CUDA device, or copied alone
into a directory without the port, it exits non-zero and prints no
result."""
import shutil
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke

ROOT = Path(__file__).resolve().parent.parent


def test_main_fails_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out and '"kernels"' not in out.out
    assert "no CUDA device" in out.err


def test_script_alone_in_a_directory_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout
