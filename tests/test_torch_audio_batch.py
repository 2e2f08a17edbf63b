"""The transcoder's IMA ADPCM on the video decoder's device
(runtime/transcode.py ``_ModsIma``, ``_frame_pcm``): with engine="cpu"
every frame's PCM equals the port's oracle engine's (the host
ImaAdpcmDecoder) and the JAX package's, at 64x48 on the CPU, and the
transcoder makes one ``decode_nibbles`` call per decode call that emits
IMA packets.

MODS: chunks of 3 and 5 frames with keyframes that split the runs of
packets inside a chunk and at its edges, the 'N3' offset quirk, a frame
that fails to decode mid-chunk, frames with no, one or three packets, and
a header past the step table.  Moflex: chunks of different lengths, one
shorter than its headers and one with a step index past the table (both
dropped), one with no block, and a PCM16 stream beside the IMA one."""
import sys
from pathlib import Path

import numpy as np
import pytest

from mobiclipdecoder_tpu.runtime import transcode as jt

from mobiclipdecoder_tpu_torch.ops.vmem_engine import VmemVideoDecoder
from mobiclipdecoder_tpu_torch.runtime import transcode as pt

sys.path.insert(0, str(Path(__file__).parent))
from torch_av import moflex_ima, mods_ima  # noqa: E402


@pytest.fixture
def calls(monkeypatch):
    """The transcoder's decode_nibbles calls, and for each
    decode_stream_chunk call the frames it emits (its good frames, then
    the one that failed)."""
    got = {"nibbles": 0, "chunks": []}
    decode_nibbles = pt.decode_nibbles
    chunk = VmemVideoDecoder.decode_stream_chunk

    def counting(*args):
        got["nibbles"] += 1
        return decode_nibbles(*args)

    def recording(self, packets):
        yuv, offs, err = chunk(self, packets)
        got["chunks"].append((yuv.shape[0], err is not None))
        return yuv, offs, err
    monkeypatch.setattr(pt, "decode_nibbles", counting)
    monkeypatch.setattr(VmemVideoDecoder, "decode_stream_chunk", recording)
    return got


def _same_pcm(got, want):
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        assert a.corrupt == b.corrupt, k
        assert (a.pcm is None) == (b.pcm is None), k
        if a.pcm is not None:
            np.testing.assert_array_equal(a.pcm, b.pcm, err_msg=f"frame {k}")


def _chunks_with(chunks, carries) -> int:
    """The decode calls (``calls``' chunks) whose emitted frames carry
    IMA, ``carries[f]`` saying whether frame f does."""
    n, f = 0, 0
    for K, failed in chunks:
        n += any(carries[f:f + K + failed])
        f += K + failed
    assert f == len(carries)
    return n


MODS = {
    # keyframes inside a chunk of 3 (4, 7) and of 5 (7, 11), at the
    # start of one of 3 (6), and runs that go on across chunks
    "keys": dict(nframes=14, key_at=(0, 4, 6, 7, 11)),
    "n3": dict(nframes=12, key_at=(0, 3, 5, 8), n3=True),
    "corrupt": dict(nframes=12, key_at=(0, 9), truncate_video_at=4),
    # no packet at a keyframe (no restart), one, three: the channels'
    # turn moves by other than a whole round
    "counts": dict(nframes=12, key_at=(0, 5, 8),
                   audio=[2, 1, 3, 0, 2, 0, 3, 1, 2, 2, 0, 3]),
}


@pytest.mark.parametrize("chunk", [3, 5])
@pytest.mark.parametrize("case", sorted(MODS))
def test_mods_pcm_equals_the_oracles(monkeypatch, calls, chunk, case):
    monkeypatch.setattr(pt, "CHUNK_FRAMES", chunk)
    spec = MODS[case]
    blob = mods_ima(seed=sum(map(ord, case)), **spec)
    got = list(pt.decode_mods(blob, engine="cpu"))
    assert len(got) == spec["nframes"]
    assert sum(f.pcm is not None for f in got) >= spec["nframes"] // 2
    audio = spec.get("audio", [2] * spec["nframes"])
    carries = [bool(n) and not f.corrupt for n, f in zip(audio, got)]
    assert calls["nibbles"] == _chunks_with(calls["chunks"], carries) > 1
    _same_pcm(got, list(jt.decode_mods(blob, engine="oracle")))
    oracle = list(pt.decode_mods(blob, engine="oracle"))
    _same_pcm(got, oracle)
    assert calls["nibbles"] == _chunks_with(calls["chunks"], carries)
    if case == "corrupt":
        assert [f.index for f in got if f.corrupt] == [4]
    if case == "n3":
        from mobiclipdecoder_tpu_torch.containers.mods import ModsDemuxer
        dm = ModsDemuxer(blob)
        quirk = [bool((p[0] | (p[1] << 8)) & 0x8000)
                 for p, _n, _k in iter(dm.read_frame, None)]
        assert dm.header.tag_id == 0x334E and 0 < sum(quirk) < len(quirk)


def _until_error(frames):
    """The frames a decode yields before it raises, and the error's type."""
    got = []
    try:
        for fr in frames:
            got.append(fr)
    except Exception as err:  # noqa: BLE001 - the type is compared
        return got, type(err)
    return got, None


def test_mods_step_index_past_the_table_raises_as_the_spec(monkeypatch):
    """A header with step index 100 (frame 7, in the third chunk of 3):
    every engine yields the same frames before it, then raises the same
    error at the same frame."""
    monkeypatch.setattr(pt, "CHUNK_FRAMES", 3)
    blob = mods_ima(nframes=10, key_at=(0, 7), bad_index_at=7, seed=5)
    got, err = _until_error(pt.decode_mods(blob, engine="cpu"))
    want, want_err = _until_error(pt.decode_mods(blob, engine="oracle"))
    assert err is want_err is IndexError and len(got) == 7
    _same_pcm(got, want)


def test_moflex_pcm_equals_the_oracles(monkeypatch, calls):
    """IMA chunks of 0-3 blocks a channel with 0, 1 or 57 bytes more (the
    last block taken only if a byte follows it), one of 5 bytes and one
    with step index 100 (both dropped, as the host decoder's error drops
    them), one of its headers alone (an empty PCM), a PCM16 stream beside
    it; chunks of 3 frames."""
    monkeypatch.setattr(pt, "CHUNK_FRAMES", 3)
    payloads = [(2, 0, None), (1, 1, None), (3, 57, None), 5, (2, 1, 100),
                (0, 0, None), (1, 0, None), (2, 9, None), (3, 0, None),
                (1, 128, None)]
    blob = moflex_ima(len(payloads), payloads=payloads, pcm16=True)
    got = list(pt.decode_moflex(blob, engine="cpu"))
    assert len(got) == len(payloads)
    # frame f carries the chunk that follows frame f - 1's video; which of
    # them decode a block: more than one block's bytes after the headers
    decoded = [not isinstance(p, int) and p[2] is None
               and p[0] * 256 + p[1] > 256 for p in payloads]
    assert calls["nibbles"] == _chunks_with(calls["chunks"],
                                            [False] + decoded[:-1])
    _same_pcm(got, list(jt.decode_moflex(blob, engine="oracle")))
    _same_pcm(got, list(pt.decode_moflex(blob, engine="oracle")))
    assert got[0].pcm is None and got[6].pcm is not None


def test_wavefront_frame_path_decodes_a_frame_at_a_time(monkeypatch, calls):
    """The wavefront decoder (no chunks): one decode_nibbles call per frame
    with IMA packets, PCM equal to the oracle's."""
    blob = mods_ima(nframes=5, key_at=(0, 3), seed=9,
                    audio=[2, 0, 3, 1, 2])
    got = list(pt.decode_mods(blob, engine="wavefront-cpu"))
    assert calls["nibbles"] == 4 and calls["chunks"] == []
    _same_pcm(got, list(pt.decode_mods(blob, engine="oracle")))
