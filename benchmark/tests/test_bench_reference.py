"""The frozen reference against the frozen generator at 64x48: every
packet is read to its end, and two witnesses agree with the reference
frame for frame: the program's own copy of the spec decoder, and the
program's plain GOP decoder on the CPU.  The PCM reference agrees with
the program's transcoder on the CPU."""
from __future__ import annotations

import numpy as np
import pytest

from benchmark.gen.traffic import (corpus_stream, file_gop, mux_file,
                                   version_of)
from benchmark.reference.decode import decode_video, file_pcm
from benchmark.reference.oracle_video import OracleDecoder
from benchmark.tests.tiny import tiny_config

CONFIGS = ["mods_ds_256x192", "moflex_3ds_400x240"]
SEED = 2 ** 31 + 99


@pytest.mark.parametrize("config", CONFIGS)
def test_every_packet_is_read_to_its_end(config):
    cfg = tiny_config(config)
    s = corpus_stream(cfg, SEED, 0, 2, 6, cfg["iframe_qp"])
    dec = OracleDecoder(cfg["width"], cfg["height"], version_of(cfg))
    for pkt in (p for g in s for p in g):
        dec.data, dec.offset = pkt, 0
        dec.decode_frame()
        assert dec.offset == len(pkt)


@pytest.mark.parametrize("config", CONFIGS)
def test_reference_agrees_with_two_witnesses(config):
    from mobiclipdecoder_tpu_torch.models.oracle_video import \
        OracleDecoder as ProgramOracle
    from mobiclipdecoder_tpu_torch.ops.vmem_engine import VmemBatchDecoder
    cfg = tiny_config(config)
    W, H, B, F = cfg["width"], cfg["height"], 2, 5
    streams = [corpus_stream(cfg, SEED, b, 2, F, cfg["iframe_qp"])
               for b in range(B)]
    ref = [decode_video(W, H, cfg["version"], [p for g in s for p in g])[0]
           for s in streams]
    o = ProgramOracle(W, H, int(version_of(cfg)))
    for k, pkt in enumerate(p for g in streams[0] for p in g):
        o.data, o.offset = pkt, 0
        o.decode_frame()
        S = o.stride
        got = np.concatenate([o.y_planes[0].reshape(-1, S),
                              o.uv_planes[0].reshape(-1, S)])
        assert np.array_equal(got, ref[0][k])
    dec = VmemBatchDecoder(W, H, int(version_of(cfg)), batch=B,
                           native=True, device="cpu")
    gops = [[[streams[b][g][f] for b in range(B)] for f in range(F)]
            for g in range(2)]
    for g, out in enumerate(dec.decode_gops(iter(gops))):
        want = np.stack([r[g * F:(g + 1) * F] for r in ref], axis=1)
        assert np.array_equal(out, want)


@pytest.mark.parametrize("config", CONFIGS)
def test_pcm_reference_agrees_with_the_transcoder(config):
    from mobiclipdecoder_tpu_torch.runtime import transcode
    cfg = tiny_config(config)
    gops = [file_gop(cfg, SEED, 0, g, 4, cfg["iframe_qp"]) for g in range(2)]
    entry = {"mods": transcode.decode_mods, "moflex": transcode.decode_moflex}
    frames = list(entry[cfg["container"]](mux_file(cfg, gops), engine="cpu"))
    want = file_pcm(cfg["container"], cfg["audio"]["channels"],
                    [g["audio"] for g in gops])
    assert len(frames) == len(want) == 8
    for fr, w in zip(frames, want):
        assert (fr.pcm is None) == (w is None)
        if w is not None:
            assert np.array_equal(fr.pcm, w)
