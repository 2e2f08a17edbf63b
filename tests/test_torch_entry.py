"""The port's entry points (mobiclipdecoder_tpu_torch/graft_entry.py) and
its kernel warm-up tool (tools/warm_kernels.py) on the CPU: ``entry()``
against the JAX package's ``__graft_entry__.entry()``, the multi-device
dry run over CPU devices, and the warm-up at a small size."""
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry

from mobiclipdecoder_tpu_torch import graft_entry
from mobiclipdecoder_tpu_torch.tools import warm_kernels


def test_entry_matches_jax_entry():
    """The same 64x48 DS I-frame (seed 0, QP 0x18) through the port's
    decode_frame_core and the JAX package's (XLA on the CPU): equal."""
    fn, args = graft_entry.entry("cpu")
    ring = args[0]
    assert ring.shape == (1, 6, 72, 256) and ring.dtype == torch.int32
    assert all(a.shape[0] == 1 for a in args[1:7])
    assert isinstance(args[7], np.ndarray)            # n_levels: host
    got = fn(*args)
    assert got.shape == (1, 72, 256) and got.dtype == torch.int32
    jfn, jargs = jentry.entry()
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jfn(*jargs)))


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_over_cpu_devices(n, capsys):
    graft_entry.dryrun_multichip(n, devices=["cpu"] * n)
    out = capsys.readouterr().out
    assert out.startswith(f"dryrun_multichip ok: {n} devices")
    assert "every result == one device" in out


def test_dryrun_multichip_needs_the_gpus(monkeypatch):
    """The default devices are cuda:0 .. cuda:n-1; with fewer GPUs
    visible it raises, with no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 GPUs, 1 visible"):
        graft_entry.dryrun_multichip(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="0 visible"):
        graft_entry.dryrun_multichip(1)
    with pytest.raises(ValueError, match="1 devices for n_devices=2"):
        graft_entry.dryrun_multichip(2, devices=["cpu"])


def test_warm_kernels_runs_on_the_cpu(capsys):
    assert warm_kernels.main(["64x48", "--batch", "2", "--frames", "2",
                              "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "build mobiscan" in out and "gop_executor" not in out
    assert "64x48: GOP (B=2, F=2) first launch" in out
    assert "-> (2, 2, 72, 256); 2 single frames" in out


def test_warm_kernels_cuts_640x480(monkeypatch):
    """The JAX tool's cut: above 512 columns at most 2 streams and 8
    frames."""
    seen = []
    monkeypatch.setattr(warm_kernels, "warm_geometry",
                        lambda w, h, b, f, d: seen.append((w, h, b, f)) or {})
    res = warm_kernels.warm(["64x48", "640x480"], batch=8, frames=24,
                            device="cpu")
    assert seen == [(64, 48, 8, 24), (640, 480, 2, 8)]
    assert res["640x480"] == {"batch": 2, "frames": 8}
