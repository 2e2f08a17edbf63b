"""The device a decoder or op is asked for, and the checks and launch
that the hand-written kernels' wrappers share."""
from __future__ import annotations

import torch


def indexed(device) -> torch.device:
    """``torch.device(device)`` with a bare ``"cuda"`` resolved to the
    current CUDA device (``cuda:k``): the name that stays the same card
    after a later ``torch.cuda.set_device``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_device(device) -> torch.device:
    """``indexed(device)``; a CUDA device that is not there raises instead
    of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' was asked for, but "
                               "torch.cuda.is_available() is false")
        n = torch.cuda.device_count()
        if dev.index is not None and dev.index >= n:
            raise RuntimeError(f"device {dev} was asked for, but {n} CUDA "
                               f"device(s) are visible")
    return indexed(dev)


def on_one_card(**tensors) -> torch.device:
    """Every tensor int32, contiguous and on one CUDA device; returns it.
    The hand-written kernels take nothing else."""
    dev = None
    for name, t in tensors.items():
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous int32 tensor, "
                             f"got {t.dtype} (contiguous "
                             f"{t.is_contiguous()})")
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}: the kernels take "
                             f"CUDA tensors")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not {dev}")
        dev = t.device
    return dev


def launch(fn, dev: torch.device, *args) -> None:
    """``fn(*args, device index, stream)``, a kernel library's launch
    function, on the current stream of ``dev``; raises if it returns a CUDA
    error code."""
    # the library's runtime launches on the device current on this thread;
    # the launch checks that it is the tensors' device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*args, dev.index, stream)
    if rc != 0:
        raise RuntimeError(f"kernel launch on {dev} failed: CUDA error {rc}")
