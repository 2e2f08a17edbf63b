"""The SAD volume's kernel code (csrc/sad_ops.cuh, K7's block built for the
host with g++ as csrc/sad_host.cpp and run block by block) against the JAX
package's jitted ``_sad8_volume`` and the port's plain version
``_sad8_volume_plain``, on the CPU with inputs drawn from numpy seeds:
ranges 6 and 16, one and five references, 64x48 and 128x96, with a
reference of 0/255 noise that drives the SADs up.  Exact
equality throughout.  Also the wrapper's CPU path, its input checks and its
failed build.  The kernel itself runs on the card only
(tests/test_torch_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobiclipdecoder_tpu.ops import mesearch as jm

from mobiclipdecoder_tpu_torch.ops import mesearch as pm
from mobiclipdecoder_tpu_torch.ops import mesearch_kernels as mk


def _planes(H, W, R, seed):
    """cur (H, W) and refs (R, H, W) int32 8-bit planes; the last
    reference is 0/255 noise, which drives the SADs up."""
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, 256, (H, W)).astype(np.int32)
    refs = rng.integers(0, 256, (R, H, W)).astype(np.int32)
    refs[-1] = 255 * (rng.random((H, W)) < 0.5)
    return cur, refs


@pytest.mark.parametrize("size", [(64, 48), (128, 96)], ids=["64x48",
                                                            "128x96"])
@pytest.mark.parametrize("R", [1, 5])
@pytest.mark.parametrize("range_", [6, 16])
def test_host_kernel_matches_jax_and_plain(size, R, range_):
    W, H = size
    cur, refs = _planes(H, W, R, seed=range_ * 10 + R + W)
    got = mk.sad_volume_host(cur, refs, range_)
    side = 2 * range_ + 1
    assert got.shape == (side * side, R, H // 8, W // 8)
    np.testing.assert_array_equal(
        got, np.asarray(jm._sad8_volume(jnp.asarray(cur), jnp.asarray(refs),
                                        range_)))
    np.testing.assert_array_equal(
        got, pm._sad8_volume_plain(torch.from_numpy(cur),
                                   torch.from_numpy(refs), range_).numpy())
    # the noise reference drives SADs well above the mean of 8-bit noise
    # (64 * 85), and cur against itself is 0 at the offset (0, 0)
    assert got[:, -1].max() >= 64 * 150
    same = mk.sad_volume_host(cur, cur[None], range_)
    assert (same[side * side // 2] == 0).all()


def test_host_kernel_zero_pads_the_frame_edges():
    """Out-of-frame candidates read 0: a reference of ones shifted fully
    out of the frame leaves the SAD of cur against zeros."""
    H, W, r = 16, 16, 8
    cur = np.random.default_rng(1).integers(0, 256, (H, W)).astype(np.int32)
    refs = np.ones((1, H, W), np.int32)
    got = mk.sad_volume_host(cur, refs, r)
    side = 2 * r + 1
    # (dy, dx) = (-8, -8): tile (0, 0) sees only padding
    assert got[0, 0, 0, 0] == cur[:8, :8].sum()
    # (dy, dx) = (8, 8): tile (1, 1) sees only padding
    assert got[side * side - 1, 0, 1, 1] == cur[8:, 8:].sum()
    # (0, 0): every tile sees the reference
    np.testing.assert_array_equal(
        got[side * side // 2, 0],
        np.abs(cur - 1).reshape(2, 8, 2, 8).sum(axis=(1, 3)))


def test_wrapper_takes_the_plain_version_on_the_cpu():
    """_sad8_volume on CPU tensors is the plain version and launches
    nothing; SadVolume on the CPU equals the kernel's host build."""
    cur, refs = _planes(48, 64, 2, seed=3)
    before = mk.sad_launches
    got = pm._sad8_volume(torch.from_numpy(cur), torch.from_numpy(refs), 6)
    assert mk.sad_launches == before
    np.testing.assert_array_equal(got.numpy(),
                                  mk.sad_volume_host(cur, refs, 6))
    sv = pm.SadVolume(cur.astype(np.uint8), list(refs.astype(np.uint8)),
                      range_=6, device="cpu")
    np.testing.assert_array_equal(sv.vol, got.numpy())
    assert mk.sad_launches == before


def test_wrapper_checks_inputs_and_never_falls_back():
    """K7's wrapper takes contiguous int32 CUDA tensors of the shapes K7
    takes: CPU tensors raise there (_sad8_volume takes the plain version
    for them itself), and so does any other device through _sad8_volume."""
    cur, refs = (torch.from_numpy(a) for a in _planes(48, 64, 2, seed=4))
    before = mk.sad_launches
    with pytest.raises(ValueError, match="CUDA"):
        mk.sad_volume(cur, refs, 6)
    with pytest.raises(ValueError, match="int32"):
        mk.sad_volume(cur.long(), refs, 6)
    with pytest.raises(ValueError, match="int32"):
        mk.sad_volume(cur.t(), refs, 6)
    with pytest.raises(ValueError, match="meta"):
        pm._sad8_volume(cur.to("meta"), refs.to("meta"), 6)
    for c, r, rng_ in ((cur[:44], refs[:, :44], 6), (cur, refs[:, :40], 6),
                       (cur, refs, -1), (cur.repeat(1, 33),
                                         refs.repeat(1, 1, 33), 6)):
        with pytest.raises(ValueError, match="expected"):
            mk.volume_shape(c, r, rng_)
    with pytest.raises(ValueError, match="expected"):
        mk.sad_volume_host(cur.numpy(), refs.numpy()[:1, :8], 6)
    assert mk.sad_launches == before


def test_sad_volume_on_cuda_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cur = np.zeros((48, 64), np.uint8)
    with pytest.raises(RuntimeError, match="cuda"):
        pm.SadVolume(cur, [cur], device="cuda")


def test_failed_kernel_build_raises(monkeypatch, tmp_path):
    """K7 that cannot be built raises from the wrapper's loader; no path
    falls back to the plain version for a CUDA tensor."""
    from mobiclipdecoder_tpu_torch.utils import build

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(mk, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        mk._load()
    monkeypatch.setattr(build, "find_nvcc", lambda: "/bin/false")
    with pytest.raises(RuntimeError, match="failed building"):
        mk._load()
    assert mk._lib is None and not list(tmp_path.rglob("*.so"))
