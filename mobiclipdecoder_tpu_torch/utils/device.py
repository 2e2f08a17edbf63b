"""The device a decoder or op is asked for."""
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
