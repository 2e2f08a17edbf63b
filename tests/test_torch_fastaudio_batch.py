"""The transcoder's FastAudio on the video decoder's device
(runtime/transcode.py ``_FastAudioChunk``, ``_FastAudio``,
``_decode_fastaudio``): with engine="cpu" every frame's PCM of a Moflex
file with FastAudio (codec 0) equals the port's oracle engine's (the host
FastAudioDecoder, packet by packet) and the JAX package's, at 64x48 on the
CPU, and the transcoder makes one lattice call (on the CPU K8's g++
build) per decode call whose frames carry FastAudio packets.

Chunks of whole rounds, of rounds with bytes left over, of a round that
runs past the payload (dropped, with the channels before it advanced),
shorter than a packet, empty; stereo and mono (a mono chunk of whole
packets does not decode its last); audio before and after the video;
files long enough for many launches (each stream's state carried from
launch to launch); two FastAudio streams (separate state).  Also K8's
form with a coefficient set per packet and each row's packet count, in
its g++ host build and in ``fastaudio_synth_plain``, against the host
decoder on ragged rows, states included; the bulk unpack against
``FastAudioDecoder.excitation``; ``fastaudio_samples`` per launch."""
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from mobiclipdecoder_tpu.runtime import transcode as jt

from mobiclipdecoder_tpu_torch.models.audio_fastaudio import (
    FastAudioDecoder)
from mobiclipdecoder_tpu_torch.models.audio_fastaudio_unpack import unpack
from mobiclipdecoder_tpu_torch.ops import audio_kernels as ak
from mobiclipdecoder_tpu_torch.ops import audio_lpc as plpc
from mobiclipdecoder_tpu_torch.ops.vmem_engine import VmemVideoDecoder
from mobiclipdecoder_tpu_torch.runtime import metrics
from mobiclipdecoder_tpu_torch.runtime import transcode as pt

sys.path.insert(0, str(Path(__file__).parent))
from torch_av import moflex_fastaudio  # noqa: E402


def _state(dec: FastAudioDecoder) -> tuple[list[int], int]:
    """A host decoder's lattice state: (hist[j] = Internal[107-j], r9)."""
    s32 = dec.internal.astype(np.uint32).view(np.int32)
    return [int(s32[107 - j]) for j in range(8)], int(s32[109])


@pytest.fixture
def calls(monkeypatch):
    """The transcoder's lattice calls (on the CPU K8's g++ build,
    ``fastaudio_synth_host``), with the samples each row was given, and
    for each decode_stream_chunk call the frames it emits."""
    got = {"synth": [], "chunks": []}
    synth = ak.fastaudio_synth_host
    chunk = VmemVideoDecoder.decode_stream_chunk

    def counting(excit, coef, hist0, r9_0, lengths):
        got["synth"].append(int(lengths.sum()) * 256)
        return synth(excit, coef, hist0, r9_0, lengths)

    def recording(self, packets):
        yuv, offs, err = chunk(self, packets)
        got["chunks"].append(yuv.shape[0] + (err is not None))
        return yuv, offs, err
    monkeypatch.setattr(ak, "fastaudio_synth_host", counting)
    monkeypatch.setattr(VmemVideoDecoder, "decode_stream_chunk", recording)
    return got


def _same_pcm(got, want):
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        assert a.corrupt == b.corrupt, k
        assert (a.pcm is None) == (b.pcm is None), k
        if a.pcm is not None:
            np.testing.assert_array_equal(a.pcm, b.pcm, err_msg=f"frame {k}")


def _launches_with(chunks, carries) -> int:
    """The decode calls (``calls``' chunks, each its frames) whose frames
    carry FastAudio packets, ``carries[f]`` saying whether frame f does."""
    n, f = 0, 0
    for k in chunks:
        n += any(carries[f:f + k])
        f += k
    assert f == len(carries)
    return n


# each case: the streams (index, channels), each frame's chunk sizes in
# bytes per stream, audio before the video or after it, CHUNK_FRAMES
CASES = {
    # 3 rounds, 3 with 1 byte more, 3 and the last round's first packet
    # (dropped: channel 0 advanced), shorter than a packet, none (the
    # muxer writes no empty chunk), 2 rounds with 38 bytes more (no round
    # begun), one round
    "stereo": (((1, 2),), [[240], [241], [279], [5], [0], [198], [80]],
               True, 3),
    # 3 packets and 38 bytes: with the demuxer's 2-byte pad a 4th would
    # fit, but it is not decoded (more than 40 bytes must remain); 4
    # packets; 2 and 39 bytes; 4 and 2 bytes; one
    "mono": (((1, 1),), [[158], [160], [119], [162], [40]], True, 3),
    "after_video": (((1, 2),), [[240], [279], [160], [81], [80]], False, 3),
    # many launches: CHUNK_FRAMES 3 gives launches of 1, 3, 3, ...
    "many_launches": (((1, 2),), [[80 * (1 + f % 3) + 39 * (f == 5)]
                                  for f in range(11)], True, 3),
    # two FastAudio streams, stereo and mono, each its own state; the
    # ramp's own launches of 1, 3, then 12
    "two_streams": (((1, 2), (2, 1)), [[160 + 80 * (f % 2), 82 + 40 * (f % 3)]
                                       for f in range(6)], True, 16),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moflex_fastaudio_pcm_equals_the_oracles(monkeypatch, calls, case):
    streams, sizes, before, chunk = CASES[case]
    monkeypatch.setattr(pt, "CHUNK_FRAMES", chunk)
    blob = moflex_fastaudio(len(sizes), seed=sum(map(ord, case)),
                            streams=streams, sizes=sizes, before=before)
    got = list(pt.decode_moflex(blob, engine="cpu"))
    assert len(got) == len(sizes)
    want = list(pt.decode_moflex(blob, engine="oracle"))
    _same_pcm(got, want)
    _same_pcm(got, list(jt.decode_moflex(blob, engine="oracle")))
    # frame f carries the chunks muxed since frame f - 1's video; which
    # of them decode a packet: more than 40 bytes, with the demuxer's pad
    carry = [any(s + 2 > 40 for s in row) for row in sizes]
    carries = carry if before else [False] + carry[:-1]
    assert len(calls["synth"]) == _launches_with(calls["chunks"],
                                                 carries) > 0
    if case == "stereo":
        assert got[2].pcm is None and got[3].pcm.size == 0
        assert got[4].pcm is None
    if case == "mono":
        assert [f.pcm.size for f in got] == [768, 1024, 768, 1024, 256]


def test_dropped_chunk_advances_the_channels_before_it():
    """A stereo chunk whose last round has only channel 0's packet: its
    PCM is dropped, channel 0's state has taken the packet and channel
    1's has not, as the host loop leaves them; the next chunk decodes from
    those states."""
    from mobiclipdecoder_tpu_torch.containers.moflex import (AudioStream,
                                                             MoflexDemuxer)
    blob = moflex_fastaudio(3, seed=4, sizes=[[80], [80 * 2 + 41], [80]])
    payloads = []
    MoflexDemuxer(blob, on_frame=lambda c, p: payloads.append((c, p))
                  if isinstance(c, AudioStream) else None).demux_all()
    fa = pt._FastAudio()
    pieces = [fa.parse(p, c) for c, p in payloads]
    assert [p.counts.tolist() for p in pieces] == [[1, 1], [3, 2], [1, 1]]
    assert [p.dropped for p in pieces] == [False, True, False]
    out = fa.decode(pieces, types.SimpleNamespace(device=torch.device("cpu")))
    want = list(pt.decode_moflex(blob, engine="oracle"))
    assert out[1] is None and want[1].pcm is None
    for k in (0, 2):
        np.testing.assert_array_equal(out[k], want[k].pcm)
    hosts = [FastAudioDecoder() for _ in range(2)]
    for _c, p in payloads:      # the host loop, Form1.cs:561-599
        off = 0
        try:
            while off + 40 < len(p):
                for h in hosts:
                    h.data, h.offset = p, off
                    h.decode()
                    off = h.offset
        except IndexError:
            pass
    for c, h in enumerate(hosts):
        assert (fa.state[1][0][c].tolist(), int(fa.state[1][1][c])) == \
            _state(h), c


def test_fastaudio_samples_counted_per_launch(monkeypatch, calls):
    """``fastaudio_samples`` grows by each launch's per-channel samples,
    the padding left out, on the decoder and in TOTALS."""
    monkeypatch.setattr(pt, "CHUNK_FRAMES", 3)
    sizes = [[80 * (1 + f % 2)] for f in range(5)] + [[279]]
    blob = moflex_fastaudio(6, seed=8, sizes=sizes)
    before = metrics.TOTALS.fastaudio_samples
    decs = []
    make = pt._make_video_decoder

    def keep(*args):
        decs.append(make(*args))
        return decs[-1]
    monkeypatch.setattr(pt, "_make_video_decoder", keep)
    list(pt.decode_moflex(blob, engine="cpu"))
    # 2 x (1 + 2 + 1 + 2 + 1) packets, then 2 x 3 + 1 of the dropped chunk
    want = 256 * (2 * 7 + 7)
    assert sum(calls["synth"]) == want
    assert decs[0].metrics.fastaudio_samples == want
    assert metrics.TOTALS.fastaudio_samples - before == want


def test_unpack_equals_excitation_packet_by_packet():
    rng = np.random.default_rng(12)
    pk = rng.integers(0, 256, (3, 41, 40), dtype=np.uint8)
    pk[0, 0] = 0
    pk[0, 1] = 0xFF
    excit, coef = unpack(pk)
    assert excit.shape == (3, 41, 256) and coef.shape == (3, 41, 8)
    assert excit.dtype == coef.dtype == np.int32
    dec = FastAudioDecoder()
    for i in np.ndindex(3, 41):
        dec.data, dec.offset = pk[i].tobytes(), 0
        e, c = dec.excitation()
        np.testing.assert_array_equal(excit[i], e, err_msg=str(i))
        assert coef[i].tolist() == c, i
    assert unpack(np.zeros((2, 0, 40), np.uint8))[0].shape == (2, 0, 256)


def test_lattice_per_packet_on_ragged_rows_equals_the_host_decoder():
    """K8's form with a coefficient set per packet (host build and plain
    version): rows of 5, 1, 0 and 3 packets padded to 5, from states the
    host decoders reached over earlier packets, against each row's host
    decoder: the samples of its packets, and its state after them."""
    rng = np.random.default_rng(13)
    lens = np.array([5, 1, 0, 3], np.int32)
    B, P = len(lens), int(lens.max())
    hosts = [FastAudioDecoder() for _ in range(B)]
    for h in hosts:     # a state of its own in each row
        for _ in range(int(rng.integers(1, 4))):
            h.data, h.offset = rng.integers(0, 256, 40, np.uint8
                                            ).tobytes(), 0
            h.decode()
    start = [_state(h) for h in hosts]
    pk = rng.integers(0, 256, (B, P, 40), dtype=np.uint8)
    excit, coef = unpack(pk)
    want = np.zeros((B, P * 256), np.int16)
    for b, h in enumerate(hosts):
        for p in range(lens[b]):
            h.data, h.offset = pk[b, p].tobytes(), 0
            want[b, 256 * p:256 * (p + 1)] = h.decode()
    args = (excit.reshape(B, -1), coef, np.array([s[0] for s in start],
                                                 np.int32),
            np.array([s[1] for s in start], np.int32), lens)
    host = ak.fastaudio_synth_host(*args)
    plain = [t.numpy() for t in plpc.fastaudio_synth_plain(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in args))]
    for got in (host, plain):
        for b, h in enumerate(hosts):
            n = 256 * lens[b]
            np.testing.assert_array_equal(got[0][b, :n], want[b, :n])
            assert (got[1][b].tolist(), int(got[2][b])) == _state(h), b
    # the padding is left unwritten in the host build
    assert not host[0][1, 256:].any() and not host[0][2].any()
    # P = 1 with no lengths is the one-set form
    one = ak.fastaudio_synth_host(excit[:, 0], coef[:, 0], *args[2:4])
    for b in np.flatnonzero(lens):
        np.testing.assert_array_equal(one[0][b], host[0][b, :256])
    assert one[1][1].tolist() == host[1][1].tolist()
