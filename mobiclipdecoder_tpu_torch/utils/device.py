"""The device a decoder or op is asked for."""
from __future__ import annotations

import torch


def check_device(device) -> torch.device:
    """``torch.device(device)``; a CUDA device that is not there raises
    instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for, but "
                           "torch.cuda.is_available() is false")
    return dev
