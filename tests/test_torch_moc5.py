"""Wii MOC5 on the port's two user paths at a width over 512 (528x32,
stride 1024, the stride of the Wii's 640x480), on the CPU: the
transcoder's ``decode_moc5`` and the corpus worker (``batch``), each
against the frozen reference decoder (``benchmark/reference``) on the
frozen generator's packets (``benchmark/gen/moc5.py``)."""
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

from test_mods_e2e import _build_fixture  # noqa: E402
from test_moflex import _build_moflex  # noqa: E402

from benchmark.gen import moc5  # noqa: E402
from benchmark.reference.decode import decode_video  # noqa: E402

from mobiclipdecoder_tpu_torch.models.oracle_video import (  # noqa: E402
    MobiclipVersion)
from mobiclipdecoder_tpu_torch.parallel import distributed  # noqa: E402
from mobiclipdecoder_tpu_torch.parallel.gop import shard_moc5  # noqa: E402
from mobiclipdecoder_tpu_torch.runtime import transcode  # noqa: E402

W, H, S = 528, 32, 1024
CFG = {"width": W, "height": H, "fps": 30, "version": "MOFLEX_3DS"}
SEED = 2 ** 31 + 101


def _moc5(gop_frames, file=0, seed=SEED):
    """(MOC5 bytes, the generator's GOPs) of a file of GOPs of
    ``gop_frames`` frames each, every one opened by an I-frame."""
    gops = [moc5.file_gop(CFG, seed, file, g, n, 0x18)
            for g, n in enumerate(gop_frames)]
    return moc5.mux_file(CFG, gops), gops


def _reference(gops):
    """(N, H + H/2, S) frames of the frozen reference, GOP by GOP."""
    return np.concatenate([decode_video(W, H, "MOFLEX_3DS", g["video"])[0]
                           for g in gops])


def test_decode_moc5_matches_the_frozen_reference():
    """Two GOPs of 12 frames: the transcoder's launch of frames 4-15
    straddles the keyframe and reads the ring the earlier ones left."""
    data, gops = _moc5([12, 12])
    assert transcode.width_stride(W) == S
    want = _reference(gops)
    got = list(transcode.decode_moc5(data, engine="cpu"))
    assert len(got) == len(want) == 24
    for k, (fr, wf) in enumerate(zip(got, want)):
        assert fr.index == k and fr.pcm is None and not fr.corrupt
        np.testing.assert_array_equal(fr.y, wf[:H, :W], err_msg=f"{k} y")
        np.testing.assert_array_equal(fr.u, wf[H:, :W // 2],
                                      err_msg=f"{k} u")
        np.testing.assert_array_equal(fr.v, wf[H:, S // 2:S // 2 + W // 2],
                                      err_msg=f"{k} v")


def test_shard_moc5_cuts_at_the_iframes():
    data, gops = _moc5([5, 3, 4])
    shards = shard_moc5(data, file_id=7)
    assert [(s.file_id, s.gop_index, s.first_frame, s.frame_count)
            for s in shards] == [(7, 0, 0, 5), (7, 1, 5, 3), (7, 2, 8, 4)]
    for s, g in zip(shards, gops):
        assert s.audio_counts == (0,) * s.frame_count
        for got, want in zip(s.packets, g["video"]):
            assert got[:len(want)] == want


def test_mixed_corpus_shards_and_geometries(tmp_path):
    files = [tmp_path / "a.mods", tmp_path / "b.moflex", tmp_path / "c.moc5"]
    files[0].write_bytes(_build_fixture(nframes=6, key_at=(0, 3)))
    files[1].write_bytes(_build_moflex(nframes=4, with_audio=False))
    files[2].write_bytes(_moc5([4, 4])[0])
    shards = distributed.shard_corpus(files)
    assert [(s.file_id, s.frame_count) for s in shards] == [
        (0, 3), (0, 3), (1, 4), (2, 4), (2, 4)]
    assert distributed._geometries(files) == {
        0: (64, 48, MobiclipVersion.MODS_DS),
        1: (64, 48, MobiclipVersion.MOFLEX_3DS),
        2: (W, H, MobiclipVersion.MOFLEX_3DS)}


@pytest.mark.parametrize("batch", [1, 2])
def test_run_worker_decodes_moc5_shards_like_the_reference(tmp_path, batch):
    made = [_moc5([6, 6], file=f) for f in range(2)]
    files = []
    for f, (data, _g) in enumerate(made):
        files.append(tmp_path / f"w{f}.moc5")
        files[-1].write_bytes(data)
    out = tmp_path / "out"
    st = distributed.run_worker(files, out, engine="cpu", batch=batch)
    assert st["frames"] == 24 and st["shards_decoded"] == 4
    for f, (_d, gops) in enumerate(made):
        for g, gop in enumerate(gops):
            np.testing.assert_array_equal(
                np.load(out / f"f{f}_g{g}.npy"), _reference([gop]),
                err_msg=f"file {f} gop {g}")
    assert distributed.gather_corpus(files, out) == {0: 12, 1: 12}
