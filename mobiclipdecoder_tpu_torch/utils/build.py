"""Build the port's native sources into shared libraries at first use.

Like ``mobiclipdecoder_tpu/utils/native.py``'s ``_load``: compile into a
git-ignored build directory, rebuild when a source is newer than the
library, load with ``ctypes``.  Kernels use nvcc with a plain C interface
(no PyTorch headers, so a build takes seconds); the host build of the
executor's per-op logic (used by the CPU tests only) and the repository's
C++ scanner (``native/scanner.cpp``, through ``utils/native.py``) use g++.
A failed build raises.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = CSRC / "build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

# seconds spent compiling in this process, and the compiler's messages
# (ptxas -v: registers, spills and shared memory of each kernel), by
# library name
build_seconds: dict[str, float] = {}
build_logs: dict[str, str] = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _stale(lib: Path, sources: list[Path]) -> bool:
    if not lib.exists():
        return True
    headers = [h for d in {p.parent for p in sources} for h in d.glob("*.cuh")]
    newest = max(p.stat().st_mtime for p in sources + headers)
    return lib.stat().st_mtime < newest


def build(name: str, sources: list[str | Path], compiler: str,
          subdir: str = "") -> Path:
    """Compile ``sources`` (file names under csrc/, or absolute paths) into
    ``csrc/build/<subdir>/lib<name>.so`` when missing or stale; returns
    the library's path."""
    srcs = [CSRC / s for s in sources]
    out_dir = BUILD / subdir if subdir else BUILD
    lib = out_dir / f"lib{name}.so"
    if not _stale(lib, srcs):
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    if compiler == "nvcc":
        cmd = [find_nvcc(), *NVCC_FLAGS]
    elif compiler == "g++":
        cmd = ["g++", *GXX_FLAGS]
    else:
        raise ValueError(f"unknown compiler {compiler!r}")
    # build to a temporary name and rename: concurrent test workers never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        res = subprocess.run([*cmd, "-o", tmp, *map(str, srcs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{compiler} failed building {name}:\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, lib)
        build_logs[name] = res.stdout + res.stderr
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds[name] = time.perf_counter() - t0
    return lib


def load(name: str, sources: list[str | Path], compiler: str,
         subdir: str = "") -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name, sources, compiler, subdir)))
