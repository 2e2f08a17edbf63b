"""A whole run at 64x48 on the CPU, past the harness's look for a card,
with the timed path broken underneath: ``correct`` has to come out false
for each fault the cell can have, and true with none.

* a step that returns its state unchanged: the executor's reference ring
  is handed back as it was before the GOP;
* half of the batch left out: a GOP's frames of the last half of the
  streams never come back (the corpus cells; a file cell has one stream);
* an answer altered where it is produced: one sample of a decoded frame,
  or one PCM sample.

(No cell runs on more than one chip, so there is no exchange to leave
out.)"""
from __future__ import annotations

import numpy as np
import pytest

from benchmark.run import run_cell
from benchmark.tests.tiny import tiny_cell

SEED = 2 ** 32 + 17


def _stale_ring(orig):
    def f(ring, ops, resid, F, H, S):
        before = ring.clone()
        _r, yuv = orig(ring, ops, resid, F, H, S)
        return before, yuv
    return f


def _half_batch(orig):
    def f(ring, ops, resid, F, H, S):
        r, yuv = orig(ring, ops, resid, F, H, S)
        return r, yuv[:, :max(1, yuv.shape[1] // 2)]
    return f


def _altered(orig):
    def f(ring, ops, resid, F, H, S):
        r, yuv = orig(ring, ops, resid, F, H, S)
        yuv = yuv.clone()
        yuv[-1, -1, 9, 13] += 1
        return r, yuv
    return f


def _altered_pcm(orig):
    def f(self, data, offset, length):
        out = orig(self, data, offset, length).copy()
        out[-1] ^= 1
        return out
    return f


def _run(cell_args, tiny_file=False):
    cell = tiny_cell(*cell_args)
    if tiny_file:
        # the transcoder's launches of 16 frames over GOPs of 12: a launch
        # reads the frames the previous launch left in the ring
        cell.config.update(keyframe_interval=12)
        cell.traffic.update(frames_per_file=24)
    return run_cell(cell, SEED, 3.0, False, "cpu", workers=2,
                    log=lambda m: None)


CORPUS = ("mods_corpus_b8", "mods_ds_256x192")
FILE = ("mods_file", "mods_ds_256x192")


@pytest.mark.parametrize("args,tiny_file", [(CORPUS, False), (FILE, True)],
                         ids=["corpus", "file"])
def test_sound_run_is_correct(args, tiny_file):
    r = _run(args, tiny_file)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("args,tiny_file,fault", [
    (CORPUS, False, _stale_ring), (CORPUS, False, _half_batch),
    (CORPUS, False, _altered), (FILE, True, _stale_ring),
    (FILE, True, _altered)],
    ids=["corpus-state-unchanged", "corpus-half-batch",
         "corpus-answer-altered", "file-state-unchanged",
         "file-answer-altered"])
def test_fault_is_not_correct(monkeypatch, args, tiny_file, fault):
    from mobiclipdecoder_tpu_torch.ops import vmem_engine
    monkeypatch.setattr(vmem_engine, "_decode_gop_resid",
                        fault(vmem_engine._decode_gop_resid))
    r = _run(args, tiny_file)
    # the corpus ring fault shows from the 2nd GOP, the file's within one
    # file (its second launch)
    assert r["attempted"] >= (1 if tiny_file else 2)
    assert not r["correct"]
    assert r["checks"]["pixels_differing"]["value"] > 0


def test_pcm_fault_is_not_correct(monkeypatch):
    from mobiclipdecoder_tpu_torch.models.audio_ima import ImaAdpcmDecoder
    monkeypatch.setattr(ImaAdpcmDecoder, "decode",
                        _altered_pcm(ImaAdpcmDecoder.decode))
    r = _run(FILE, True)
    assert not r["correct"]
    assert r["checks"]["pcm_samples_differing"]["value"] > 0
    assert r["checks"]["pixels_differing"]["value"] == 0


@pytest.mark.parametrize("args,tiny_file", [(CORPUS, False), (FILE, True)],
                         ids=["corpus", "file"])
def test_control_is_not_correct(args, tiny_file):
    """The control (the reference with its residual held to 8 bits) in the
    program's place, through a whole run and the driver's own check:
    ``correct`` comes out false on every seed."""
    from benchmark.controls.control import control_run
    got = []
    for s in (SEED, SEED + 1, SEED + 2):
        cell = tiny_cell(*args)
        if tiny_file:
            cell.config.update(keyframe_interval=12)
            cell.traffic.update(frames_per_file=24)
        got.append(control_run(cell, s, 1.0, "cpu", workers=2))
    assert not any(r["correct"] for r in got)
    assert np.min([r["checks"]["pixels_differing"]["value"]
                   for r in got]) > 0
    assert all(r["checks"]["pixels_differing"]["limit"] == 0 for r in got)
