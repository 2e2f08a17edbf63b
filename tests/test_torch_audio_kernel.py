"""The batched audio ops' kernel code (csrc/audio_ops.cuh, built for the
host with g++ as csrc/audio_host.cpp) against the JAX package's and the
port's plain versions, on the CPU with inputs drawn from numpy seeds:

* K8, the FastAudio lattice (per channel): coefficients at +-32767, a
  history and de-emphasis state near the int32 ends so that the adds wrap,
  and the state carried over three calls;
* K9, the IMA ADPCM scans (K9's block with its threads taken in turn,
  the card's scan tree): the pinned cases of test_torch_audio.py, leading
  batch axes, rows of 1 and of odd length, and one 32,768-nibble row
  driven to the largest diffs against the sequential ImaAdpcmDecoder;
  with ragged rows padded to one width, each row's final state against
  the host decoder's after the row's own nibbles.

Exact equality throughout.  Also the wrappers' CPU path, their input
checks and their failed build.  The kernels themselves run on the card
only (tests/test_torch_cuda.py)."""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobiclipdecoder_tpu.ops import adpcm as jad
from mobiclipdecoder_tpu.ops import audio_lpc as jlpc

from mobiclipdecoder_tpu_torch.ops import adpcm as pad
from mobiclipdecoder_tpu_torch.ops import audio_kernels as ak
from mobiclipdecoder_tpu_torch.ops import audio_lpc as plpc

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_audio import (PINNED, _case, _host_ima,  # noqa: E402
                              _host_state, _ragged)


def _synth_state(seed, B, N):
    """excit (B, N), coef (B, 8), hist (B, 8), r9 (B,): coefficients at
    +-32767 in two channels, history and de-emphasis state near the int32
    ends in two others, large excitations (the lattice's adds wrap)."""
    rng = np.random.default_rng(seed)
    excit = rng.integers(-2**31, 2**31, (B, N)).astype(np.int32)
    excit[2:] >>= 8
    coef = rng.integers(-32767, 32768, (B, 8)).astype(np.int32)
    coef[0] = 32767
    coef[1] = -32767
    hist = rng.integers(-2**24, 2**24, (B, 8)).astype(np.int32)
    hist[2] = [2**31 - 1, -2**31, 2**31 - 2, -2**31 + 1] * 2
    hist[3] = -2**31
    r9 = rng.integers(-2**24, 2**24, B).astype(np.int32)
    r9[2], r9[3] = 2**31 - 1, -2**31
    return excit, coef, hist, r9


def _first_sample_wraps(excit, coef, hist, r9) -> bool:
    """Whether an add or subtract of the lattice's first sample leaves
    int32 in some channel (exact Python integers)."""
    def ms(a, b):
        return (int(a) * int(b) + 0x4000) >> 15

    def out(v):
        return not -2**31 <= v < 2**31

    def wrap(v):
        return (v + 2**31) % 2**32 - 2**31

    hit = False
    for b in range(excit.shape[0]):
        r5 = int(excit[b, 0])
        for j in range(8):
            r5 = r5 - ms(coef[b, j], hist[b, j])
            col = int(hist[b, j]) + ms(coef[b, j], wrap(r5))
            hit |= out(r5) or out(col)
            r5 = wrap(r5)
        hit |= out(r5 + ms(0x6E14, r9[b]))
    return hit


def test_host_lattice_matches_jax_and_plain_over_three_calls():
    B, N = 7, 96
    excit, coef, hist, r9 = _synth_state(0, B, N)
    j_state = (jnp.asarray(hist), jnp.asarray(r9))
    p_state = (torch.from_numpy(hist), torch.from_numpy(r9))
    h_state = (hist, r9)
    rng = np.random.default_rng(1)
    wrapped = False
    for call in range(3):
        if call:
            excit = rng.integers(-2**31, 2**31, (B, N)).astype(np.int32)
        got = ak.fastaudio_synth_host(excit, coef, *h_state)
        j = jlpc.fastaudio_synth(jnp.asarray(excit), jnp.asarray(coef),
                                 *j_state)
        p = plpc.fastaudio_synth_plain(torch.from_numpy(excit),
                                       torch.from_numpy(coef), *p_state)
        assert got[0].dtype == np.int16 and got[0].shape == (B, N)
        for g, jj, pp in zip(got, j, p):
            np.testing.assert_array_equal(g, np.asarray(jj),
                                          err_msg=f"call {call}")
            np.testing.assert_array_equal(g, pp.numpy(),
                                          err_msg=f"call {call}")
        wrapped |= _first_sample_wraps(excit, coef, *h_state)
        h_state = got[1:]
        j_state = j[1:]
        p_state = p[1:]
    assert wrapped
    assert {-32768, 32767} <= set(np.unique(got[0]).tolist())


def test_host_lattice_matches_the_batch_decoder():
    """K8's host build carried over rounds of real packets equals the
    plain FastAudioBatchDecoder on the CPU."""
    from mobiclipdecoder_tpu_torch.models.audio_fastaudio import (
        FastAudioDecoder)
    rng = np.random.default_rng(7)
    nch = 5
    port = plpc.FastAudioBatchDecoder(nch, device="cpu")
    decs = [FastAudioDecoder() for _ in range(nch)]
    hist = np.zeros((nch, 8), np.int32)
    r9 = np.zeros(nch, np.int32)
    for _k in range(4):
        pkts = [rng.integers(0, 256, 40, dtype=np.uint8).tobytes()
                for _ in range(nch)]
        ex = np.zeros((nch, 256), np.int32)
        cf = np.zeros((nch, 8), np.int32)
        for ch, d in enumerate(decs):
            d.data, d.offset = pkts[ch], 0
            out, coef = d.excitation()
            ex[ch], cf[ch] = out, coef
        pcm, hist, r9 = ak.fastaudio_synth_host(ex, cf, hist, r9)
        np.testing.assert_array_equal(pcm, port.decode(pkts))
    np.testing.assert_array_equal(hist, port.hist.numpy())
    np.testing.assert_array_equal(r9, port.r9.numpy())


def _nibbles(body: np.ndarray) -> np.ndarray:
    """(..., L) uint8 packet bytes -> (..., 2L) int32 nibbles, low first
    (decode_packets' order)."""
    b = body.astype(np.int32)
    return np.stack([b & 0xF, b >> 4], axis=-1).reshape(*b.shape[:-1], -1)


def _three_ways(nib, index0, last0, lengths=None):
    """K9's host build, the JAX package's decode_nibbles and the plain
    version on the same inputs, asserted equal; returns the host build's
    samples.  Given lengths, the final states of the host build and the
    plain version too, asserted equal; returns (samples, index, last)."""
    got = ak.ima_scan_host(nib, index0, last0, lengths)
    samples = got if lengths is None else got[0]
    np.testing.assert_array_equal(samples, np.asarray(jad.decode_nibbles(
        jnp.asarray(nib), jnp.asarray(index0), jnp.asarray(last0))))
    np.testing.assert_array_equal(samples, ak.ima_scan_host(
        nib, index0, last0))
    ins = (nib, index0, last0) + (() if lengths is None else (lengths,))
    plain = pad.decode_nibbles_plain(
        *(torch.from_numpy(np.asarray(a, np.int32)) for a in ins))
    for g, p in zip((got,) if lengths is None else got,
                    (plain,) if lengths is None else plain):
        np.testing.assert_array_equal(g, p.numpy())
    return got


@pytest.mark.parametrize("name", ["random", "index-floor", "index-ceiling",
                                  "clamp-high", "clamp-low"])
def test_host_scan_matches_jax_plain_and_host_decoder(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    body, index0, last0 = _case(name, rng)
    lens = _ragged(rng, body.shape[0], 2 * body.shape[1])
    got, index, last = _three_ways(_nibbles(body), index0, last0, lens)
    for r in range(body.shape[0]):
        np.testing.assert_array_equal(
            got[r], _host_ima(body[r], index0[r], last0[r]), err_msg=str(r))
        assert (index[r], last[r]) == _host_state(
            body[r], index0[r], last0[r], lens[r]), r
    if name.startswith("clamp"):
        assert np.abs(got).max() >= 32767
    want_index, want_last = PINNED.get(name, (None, None))
    assert want_index in (None, index[1]) and want_last in (None, last[1])


@pytest.mark.parametrize("N", [1, 2, 255, 257, 1001])
def test_host_scan_batch_axes_and_row_lengths(N):
    """(2, 3, N) nibbles with (2, 3) states: rows shorter than, equal to
    and not a multiple of K9's thread count (some threads own nothing);
    the final states after ragged lengths, odd ones, 0, N and past N
    among them."""
    rng = np.random.default_rng(N)
    nib = rng.integers(0, 16, (2, 3, N)).astype(np.int32)
    index0 = rng.integers(0, 89, (2, 3)).astype(np.int32)
    last0 = rng.integers(-32768, 32768, (2, 3)).astype(np.int32)
    got = _three_ways(nib, index0, last0)
    assert got.shape == (2, 3, N)
    lens = rng.integers(0, N + 1, (2, 3)).astype(np.int32)
    lens[0, :3] = [0, N, N + 7]
    _s, index, last = _three_ways(nib, index0, last0, lens)
    assert (index[0, 0], last[0, 0]) == (index0[0, 0], last0[0, 0])
    for k in (1, 2):
        assert last[0, k] == _s[0, k, -1]


def test_host_scan_long_row_at_the_largest_diffs():
    """One row of 32,768 nibbles: runs of 7 pin the step index at 88 (diff
    61,436) and alternate with runs of 15, so the samples swing between
    the clamps; against the sequential host decoder."""
    N = 32768
    rng = np.random.default_rng(11)
    nib = np.where((np.arange(N) // 64) % 2 == 0, 7, 15).astype(np.int32)
    nib[N // 2:N // 2 + 512] = rng.integers(0, 16, 512)
    index0 = np.array([88], np.int32)
    last0 = np.array([0], np.int32)
    got = _three_ways(nib[None], index0, last0)
    body = (nib[0::2] | (nib[1::2] << 4)).astype(np.uint8)
    np.testing.assert_array_equal(got[0], _host_ima(body, 88, 0))
    assert {-32768, 32767} <= set(np.unique(got).tolist())


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """fastaudio_synth and decode_nibbles on CPU tensors are the plain
    versions and launch nothing; they equal the kernels' host builds."""
    before = (ak.fastaudio_launches, ak.ima_launches)
    args = _synth_state(2, 4, 32)
    got = plpc.fastaudio_synth(*(torch.from_numpy(a) for a in args))
    for g, h in zip(got, ak.fastaudio_synth_host(*args)):
        np.testing.assert_array_equal(g.numpy(), h)
    rng = np.random.default_rng(5)
    body = rng.integers(0, 256, (3, 50), dtype=np.uint8)
    i0 = rng.integers(0, 89, 3).astype(np.int32)
    l0 = rng.integers(-32768, 32768, 3).astype(np.int32)
    np.testing.assert_array_equal(
        pad.decode_packets(body, i0, l0, device="cpu"),
        ak.ima_scan_host(_nibbles(body), i0, l0).astype(np.int16))
    assert (ak.fastaudio_launches, ak.ima_launches) == before


def test_wrappers_check_inputs_and_never_fall_back():
    """K8's and K9's wrappers take contiguous int32 CUDA tensors of
    consistent shapes only: CPU tensors raise there, and so does any other
    device through fastaudio_synth and decode_nibbles."""
    fa = [torch.from_numpy(a) for a in _synth_state(3, 4, 16)]
    nib = torch.zeros((2, 8), dtype=torch.int32)
    st = torch.zeros(2, dtype=torch.int32)
    before = (ak.fastaudio_launches, ak.ima_launches)
    with pytest.raises(ValueError, match="CUDA"):
        ak.fastaudio_synth(*fa)
    with pytest.raises(ValueError, match="int32"):
        ak.fastaudio_synth(fa[0].long(), *fa[1:])
    with pytest.raises(ValueError, match="CUDA"):
        ak.ima_scan(nib, st, st)
    with pytest.raises(ValueError, match="int32"):
        ak.ima_scan(nib.t(), st, st)
    with pytest.raises(ValueError, match="meta"):
        plpc.fastaudio_synth(*(a.to("meta") for a in fa))
    with pytest.raises(ValueError, match="meta"):
        pad.decode_nibbles(nib.to("meta"), st.to("meta"), st.to("meta"))
    with pytest.raises(ValueError, match="expected"):
        ak.synth_sizes(fa[0], fa[1][:, :7], fa[2], fa[3])
    with pytest.raises(ValueError, match="expected"):
        ak.scan_sizes(nib, st[:1], st)
    with pytest.raises(ValueError, match="expected"):
        ak.scan_sizes(nib, st, st, st[:1])
    with pytest.raises(ValueError, match="lengths"):
        ak.ima_scan_host(nib.numpy(), st.numpy(), st.numpy(),
                         st.numpy()[None])
    with pytest.raises(ValueError, match="expected"):
        ak.ima_scan_host(nib.numpy(), st.numpy(), st.numpy()[None])
    assert (ak.fastaudio_launches, ak.ima_launches) == before


def test_audio_ops_on_cuda_raise_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        plpc.FastAudioBatchDecoder(2, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        pad.decode_packets(np.zeros((2, 4), np.uint8), np.zeros(2, np.int32),
                           np.zeros(2, np.int32), device="cuda")


def test_failed_kernel_build_raises(monkeypatch, tmp_path):
    """K8 and K9 that cannot be built raise from the wrapper's loader; no
    path falls back to the plain versions for a CUDA tensor."""
    from mobiclipdecoder_tpu_torch.utils import build

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(ak, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        ak._load()
    monkeypatch.setattr(build, "find_nvcc", lambda: "/bin/false")
    with pytest.raises(RuntimeError, match="failed building"):
        ak._load()
    assert ak._lib is None and not list(tmp_path.rglob("*.so"))
