"""The FastAudio file cell on the CPU at 64x48: the frozen generator's
files read back through the program's demuxer with each frame's chunk of
``rounds(f)`` rounds before its video, the frozen reference equals the
program's oracle engine, a whole run is ``correct``, and one altered
sample where the program computes the PCM, or the control
(``controls/fastaudio.py``) in the program's place, makes it not
``correct``."""
from __future__ import annotations

import json

import numpy as np
import pytest

from benchmark.gen import fastaudio
from benchmark.harness import spec
from benchmark.reference.audio_fastaudio import MOFLEX_PAD, file_pcm
from benchmark.run import run_cell

SEED = 2 ** 32 + 41
CELL = "moflex_fastaudio_file"


def tiny_fastaudio_cell() -> spec.Cell:
    """``moflex_fastaudio_file`` cut to 2 files of 2 GOPs of 4 frames at
    64x48, and to 8,192 Hz (1 or 2 rounds a frame), so that the frozen
    reference's lattice, a loop over samples, keeps up on the CPU."""
    cell = spec.load_cell(CELL)
    cfg = json.loads(json.dumps(cell.config))
    cfg.update(width=64, height=48, stride=256, keyframe_interval=4)
    cfg["audio"]["frequency"] = 8192
    tr = dict(cell.traffic, files=2, frames_per_file=8, sample=2)
    return spec.Cell(CELL, cell.workload, cfg, tr, cell.driver,
                     cell.end_to_end, cell.per_layer, 1)


def _gops(cfg, seed=SEED, file=0):
    return [fastaudio.file_gop(cfg, seed, file, g, 4, cfg["iframe_qp"])
            for g in range(2)]


def _run(cell, seed=SEED, seconds=2.0):
    return run_cell(cell, seed, seconds, False, "cpu", workers=2,
                    log=lambda m: None)


def test_rounds_follow_the_sample_clock():
    cfg = spec.load_cell(CELL).config
    a = cfg["audio"]
    got = [fastaudio.rounds(f, a["frequency"], cfg["fps"]) for f in range(96)]
    assert got[:5] == [5, 5, 5, 6, 5] and set(got) == {5, 6}
    assert sum(got) == 511 == 96 * a["frequency"] // (256 * cfg["fps"])


def test_generated_file_carries_each_frames_rounds_before_it():
    from mobiclipdecoder_tpu_torch.containers.moflex import (AudioStream,
                                                             MoflexDemuxer)
    cfg = tiny_fastaudio_cell().config
    gops = _gops(cfg)
    again = _gops(cfg)
    assert [g["audio"] for g in gops] == [g["audio"] for g in again]
    assert [g["video"] for g in gops] == [g["video"] for g in again]
    assert [g["audio"] for g in gops] != [g["audio"] for g in
                                          _gops(cfg, SEED + 1)]
    got = []
    MoflexDemuxer(fastaudio.mux_file(cfg, gops),
                  on_frame=lambda c, p: got.append((c, p))).demux_all()
    assert len(got) == 16
    a = cfg["audio"]
    for f in range(8):
        (ca, pa), (cv, pv) = got[2 * f], got[2 * f + 1]
        assert isinstance(ca, AudioStream) and ca.codec_id == 0
        assert (ca.channels, ca.frequency) == (2, 8192)
        assert pa == gops[f // 4]["audio"][f % 4][0] + bytes(MOFLEX_PAD)
        assert len(pa) - MOFLEX_PAD == 80 * fastaudio.rounds(
            f, a["frequency"], cfg["fps"])
        assert pv[:-MOFLEX_PAD] == gops[f // 4]["video"][f % 4]


def test_reference_equals_the_program_oracle_engine():
    from mobiclipdecoder_tpu_torch.runtime import transcode
    cfg = tiny_fastaudio_cell().config
    gops = _gops(cfg)
    want = file_pcm(2, [g["audio"] for g in gops])
    got = list(transcode.decode_moflex(fastaudio.mux_file(cfg, gops),
                                       engine="oracle"))
    assert len(got) == len(want) == 8
    for k, (fr, pcm) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(fr.pcm, pcm, err_msg=f"frame {k}")
        assert pcm.size == 512 * fastaudio.rounds(k, 8192, 24)


def test_tiny_cell_is_correct():
    r = _run(tiny_fastaudio_cell())
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["checks"]) == {"pixels_differing", "pcm_samples_differing",
                                "files_failed"}
    assert set(r["metrics"]) == {"first_frame_p95_ms", "setup_s"}


def test_fault_in_decode_fastaudio_is_not_correct(monkeypatch):
    """One PCM sample altered where the program computes FastAudio's PCM
    (``transcode._decode_fastaudio``, the one site on the cuda and cpu
    engines)."""
    from mobiclipdecoder_tpu_torch.runtime import transcode
    orig = transcode._decode_fastaudio

    def altered(*args):
        pcm, hist, r9 = orig(*args)
        pcm = [p.copy() for p in pcm]
        pcm[-1][-1] ^= 1
        return pcm, hist, r9
    monkeypatch.setattr(transcode, "_decode_fastaudio", altered)
    r = _run(tiny_fastaudio_cell())
    assert not r["correct"]
    assert r["checks"]["pcm_samples_differing"]["value"] > 0
    assert r["checks"]["pixels_differing"]["value"] == 0


def test_control_is_not_correct_by_pcm_alone():
    """The control (the reference with its lattice's products wrapped to
    32 bits, the video exact) in the program's place: ``correct`` false,
    by ``pcm_samples_differing`` and by no other check."""
    from benchmark.controls.fastaudio import control_run
    r = control_run(tiny_fastaudio_cell(), SEED, 1.0, "cpu", workers=2)
    assert not r["correct"]
    assert r["checks"]["pcm_samples_differing"]["value"] > 0
    assert r["checks"]["pixels_differing"]["value"] == 0
    assert r["checks"]["files_failed"]["value"] == 0


def test_readers_on_a_synthetic_trace(monkeypatch):
    """The cell's four readers on a window of 1,000 us with K8 busy 30 us
    and 200 us of ``mobiclip.audio``, 10 frames, the program's TOTALS a
    stub of 100 frames and 1,000 samples; a program with neither K8 nor
    the counter reads nothing but its spans."""
    import types

    from benchmark.harness.cell import MetricContext
    from benchmark.harness.trace import Trace
    from benchmark.harness.work import HBM_BYTES_PER_S
    from mobiclipdecoder_tpu_torch.runtime import metrics
    k8 = "mobi_fastaudio_synth_kernel(int const*, int const*)"
    tr = Trace((0.0, 1000.0), {"mobiclip.audio": [(0.0, 150.0),
                                                  (400.0, 450.0)]},
               [(k8, 100.0, 120.0), (k8, 500.0, 510.0),
                ("mobi_gop_executor_cluster_kernel", 0.0, 90.0)])
    work = {"frames": 10, "k8_bytes": HBM_BYTES_PER_S * 3e-7}
    ctx = MetricContext(tr, work)
    monkeypatch.setattr(metrics, "TOTALS", types.SimpleNamespace(
        frames=100, fastaudio_samples=1000))

    def read(name, c=ctx):
        return spec.reader(name).read(c)
    assert read("k8_us_per_frame.fastaudio") == 3.0
    assert read("k8_roofline.fastaudio") == pytest.approx(1.0)
    # 30 us over 10 frames x 10 samples a frame
    assert read("k8_ns_per_sample.fastaudio") == pytest.approx(300.0)
    assert read("audio_us_per_frame.fastaudio") == 20.0
    bare = MetricContext(Trace((0.0, 1000.0), tr.spans, tr.device[2:]),
                         work)
    monkeypatch.setattr(metrics, "TOTALS", types.SimpleNamespace(frames=100))
    for name in ("k8_us_per_frame.fastaudio", "k8_roofline.fastaudio",
                 "k8_ns_per_sample.fastaudio"):
        assert read(name, bare) is None, name
    assert read("audio_us_per_frame.fastaudio", bare) == 20.0
