"""What the run ran on: the card, its power limit and the host."""
from __future__ import annotations

import os
import subprocess


def _smi(query: str) -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return (res.stdout.strip().splitlines() or ["unknown"])[0].strip()


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def describe(count: int) -> dict:
    """The ``device`` field: platform, the card's name, the number of cards
    used, and beside them the power limit and the host's CPU."""
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "power_limit": _smi("power.limit"),
            "host_cores": os.cpu_count(), "host_cpu": cpu_model()}


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's record of
    its start (so interpreter start-up counts), or 0 where that is not
    readable."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


def process_cpu_s() -> float:
    """CPU seconds this process has used, its threads included."""
    t = os.times()
    return t.user + t.system
