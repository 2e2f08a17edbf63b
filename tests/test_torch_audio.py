"""The port's batched audio ops (mobiclipdecoder_tpu_torch/ops/adpcm.py,
ops/audio_lpc.py) against the JAX package's and the host decoders, on the
CPU with inputs drawn from numpy seeds.  PCM must be equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobiclipdecoder_tpu.ops import adpcm as jad
from mobiclipdecoder_tpu.ops import audio_lpc as jlpc

from mobiclipdecoder_tpu_torch.models.audio_fastaudio import (
    FastAudioDecoder)
from mobiclipdecoder_tpu_torch.models.audio_ima import (ImaAdpcmDecoder,
                                                        encode_ima)
from mobiclipdecoder_tpu_torch.ops import adpcm as pad
from mobiclipdecoder_tpu_torch.ops import audio_lpc as plpc


def _host_ima(body: np.ndarray, index0: int, last0: int) -> np.ndarray:
    dec = ImaAdpcmDecoder()
    dec.is_init = True
    dec.index, dec.last = int(index0), int(last0)
    return dec.decode(body.tobytes(), 0, body.size)


def _host_state(body: np.ndarray, index0: int, last0: int, n: int):
    """The host decoder's (index, last) after the first n (even) nibbles
    of packet bytes ``body``."""
    dec = ImaAdpcmDecoder()
    dec.is_init = True
    dec.index, dec.last = int(index0), int(last0)
    dec.decode(body[:n // 2].tobytes(), 0, n // 2)
    return dec.index, dec.last


def _ragged(rng, rows: int, n: int) -> np.ndarray:
    """Even row lengths in [0, n]: row 0 whole, row 1 at n / 2 (inside
    ``_case``'s pinned runs), the last row empty, the others drawn."""
    lens = 2 * rng.integers(0, n // 2 + 1, rows)
    lens[0], lens[1], lens[-1] = n, n // 2, 0
    return lens.astype(np.int32)


#: what a pinned case's state reads at the end of a row inside its run
PINNED = {"index-floor": (0, None), "index-ceiling": (88, None),
          "clamp-high": (None, 32767), "clamp-low": (None, -32768)}


def _nibble_bytes(nibbles):
    n = np.asarray(nibbles, np.uint8)
    return (n[0::2] | (n[1::2] << 4)).astype(np.uint8)


def _case(name, rng):
    """(packet bytes (8, L), index0 (8,), last0 (8,)) of one test case."""
    L = 96
    if name == "random":
        t = np.arange(8 * 2 * L).reshape(8, -1)
        rows = []
        for r in range(8):
            wave = (3000 * np.sin(t[r] / (5 + r))
                    + rng.integers(-500, 500, 2 * L)).astype(np.int16)
            rows.append(np.frombuffer(encode_ima(wave, index0=8)[4:],
                                      np.uint8)[:L])
        body = np.stack(rows)
    else:
        # runs that pin the step index and clamp the samples: nibble 0 walks
        # the index down to 0, nibble 7 up to 88 (and the samples up to
        # 32767), nibble 15 the samples down to -32768; a random tail leaves
        # the pinned state
        run = {"index-floor": 0, "index-ceiling": 7, "clamp-high": 7,
               "clamp-low": 15}[name]
        nib = np.full((8, 2 * L), run, np.uint8)
        nib[:, 3 * L // 2:] = rng.integers(0, 16, (8, L // 2))
        body = np.stack([_nibble_bytes(r) for r in nib])
    index0 = rng.integers(0, 89, 8).astype(np.int32)
    last0 = rng.integers(-32768, 32768, 8).astype(np.int32)
    if name == "clamp-high":
        last0[:] = 32000
    if name == "clamp-low":
        last0[:] = -32000
    return body, index0, last0


@pytest.mark.parametrize("name", ["random", "index-floor", "index-ceiling",
                                  "clamp-high", "clamp-low"])
def test_decode_packets_matches_jax_and_host(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    body, index0, last0 = _case(name, rng)
    port = pad.decode_packets(body, index0, last0, device="cpu")
    ref = jad.decode_packets(body, index0, last0)
    assert port.dtype == np.int16 and port.shape == (8, 2 * body.shape[1])
    np.testing.assert_array_equal(port, ref)
    for r in range(8):
        np.testing.assert_array_equal(
            port[r], _host_ima(body[r], index0[r], last0[r]), err_msg=str(r))
    if name.startswith("clamp"):
        assert np.abs(port.astype(np.int32)).max() >= 32767
    # one row through the scalar form: (L,) with 0-d state
    one = pad.decode_packets(body[0], index0[0], last0[0], device="cpu")
    np.testing.assert_array_equal(one, port[0])
    # ragged rows padded to one width: the samples are those of the whole
    # rows, the state the host decoder's after each row's own nibbles
    lens = _ragged(rng, 8, 2 * body.shape[1])
    b = body.astype(np.int32)
    nib = np.stack([b & 0xF, b >> 4], axis=-1).reshape(8, -1)
    samples, index, last = pad.decode_nibbles_plain(
        *(torch.from_numpy(a) for a in (nib, index0, last0, lens)))
    np.testing.assert_array_equal(samples.numpy(), port)
    for r in range(8):
        assert (int(index[r]), int(last[r])) == _host_state(
            body[r], index0[r], last0[r], lens[r]), r
    assert (int(index[-1]), int(last[-1])) == (index0[-1], last0[-1])
    want_index, want_last = PINNED.get(name, (None, None))
    assert want_index in (None, int(index[1]))
    assert want_last in (None, int(last[1]))


def test_decode_nibbles_one_long_row_equals_packet_chain():
    """A channel's consecutive packets as one long row equal the host
    decoder's packet-by-packet decode (state carried)."""
    rng = np.random.default_rng(3)
    t = np.arange(4096)
    wave = (6000 * np.sin(t / 9) + rng.integers(-900, 900, t.size)).astype(
        np.int16)
    blob = encode_ima(wave, index0=20)
    dec = ImaAdpcmDecoder()
    want = np.concatenate([dec.decode(blob, 0, 4 + 128)]
                          + [dec.decode(blob, o, 128)
                             for o in range(4 + 128, len(blob), 128)])
    index0 = int.from_bytes(blob[0:2], "little", signed=True) & 0x7F
    last0 = int.from_bytes(blob[2:4], "little", signed=True)
    body = np.frombuffer(blob[4:], np.uint8)
    got = pad.decode_packets(body, np.int32(index0), np.int32(last0),
                             device="cpu")
    np.testing.assert_array_equal(got, want)


def test_mulshift15_and_synth_match_jax():
    rng = np.random.default_rng(0)
    a = rng.integers(-32767, 32768, 519).astype(np.int32)
    b = np.concatenate([rng.integers(-2**31, 2**31, 512),
                        [-2**31, 2**31 - 1, -1, 0, 1, 0x7FFF, -0x8000]
                        ]).astype(np.int32)
    got = plpc._mulshift15(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jlpc._mulshift15(jnp.asarray(a),
                                                 jnp.asarray(b))))
    B, N = 6, 64
    excit = rng.integers(-2**20, 2**20, (B, N)).astype(np.int32)
    coef = rng.integers(-32767, 32768, (B, 8)).astype(np.int32)
    coef[0] = 32767
    coef[1] = -32767
    hist = rng.integers(-2**24, 2**24, (B, 8)).astype(np.int32)
    r9 = rng.integers(-2**24, 2**24, B).astype(np.int32)
    port = plpc.fastaudio_synth(*(torch.from_numpy(x)
                                  for x in (excit, coef, hist, r9)))
    ref = jlpc.fastaudio_synth(*(jnp.asarray(x)
                                 for x in (excit, coef, hist, r9)))
    assert port[0].dtype == torch.int16 and port[0].shape == (B, N)
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))


def test_fastaudio_batch_matches_jax_and_host():
    rng = np.random.default_rng(7)
    nch, npkt = 5, 6
    hosts = [FastAudioDecoder() for _ in range(nch)]
    port = plpc.FastAudioBatchDecoder(nch, device="cpu")
    ref = jlpc.FastAudioBatchDecoder(nch)
    for k in range(npkt):
        pkts = [rng.integers(0, 256, 40, dtype=np.uint8).tobytes()
                for _ in range(nch)]
        if k == 2:
            pkts[1] = None          # a silent channel this round
        got = port.decode(pkts)
        np.testing.assert_array_equal(got, ref.decode(pkts))
        for ch in range(nch):
            if ch == 1 and k >= 2:
                continue            # its state left the host decoder's
            h = hosts[ch]
            h.data = pkts[ch]
            h.offset = 0
            np.testing.assert_array_equal(got[ch], h.decode(),
                                          err_msg=f"packet {k} ch {ch}")
    assert port.hist.dtype == torch.int32


def test_audio_ops_on_cuda_raise_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        plpc.FastAudioBatchDecoder(2, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        pad.decode_packets(np.zeros((2, 4), np.uint8), np.zeros(2, np.int32),
                           np.zeros(2, np.int32), device="cuda")
