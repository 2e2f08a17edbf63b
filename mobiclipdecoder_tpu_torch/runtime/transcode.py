"""Batch transcoder of the port: container file in -> raw YUV/PCM/RGB out.

The equivalent of the reference CLI converter (MobiConverter/Program.cs:
18-490): signature-based container dispatch, video decode through the
oracle (the spec) or the port's whole-GOP decoder, per-frame audio packet
round-robin across channels, channel interleave, raw writers instead of
the Windows AVI library.  A copy of the JAX package's
``runtime/transcode.py`` with the port's engines:

  ``"oracle"``  the sequential oracle (the spec);
  ``"cuda"``    ``VmemVideoDecoder`` on the GPU: the hand-written CUDA
                executor.  Raises where no CUDA device is present;
  ``"cpu"``     the same decoder on the CPU, where the executor is its
                plain PyTorch version.  For tests; never chosen on its own;
  ``"wavefront"``  ``WavefrontVideoDecoder`` on the GPU: the wavefront
                engine (the counterpart of the JAX package's
                ``"tpu-xla"``), batched torch per dependency level.  Raises
                where no CUDA device is present;
  ``"wavefront-cpu"``  the same decoder on the CPU, asked for explicitly.

Every container's frames go through one frame loop,
``_chunked_video_frames``: the container demuxes and hands it each frame's
packet and side data (audio, keyframe flag), and ``_Launches`` hides the
kinds of decoder from it.  The wavefront decoder has no
``decode_stream_chunk``, so it decodes one frame a call, as the JAX
package does ``"tpu-xla"``.  The JAX package's ``"tpu"`` and ``"tpu-xla"``
names raise ``ValueError`` here.

IMA ADPCM audio (MODS codec 3, Moflex codec 1) is decoded on the video
decoder's device: the packets of the frames one decode call emits go as
rows, one per channel and run of packets, through one ``decode_nibbles``
call (``ops/adpcm.py``): on a CUDA decoder one launch of K9 per chunk, on
a CPU decoder its plain version.  Moflex FastAudio (codec 0) takes the
same path: each chunk's packets are unpacked on arrival, and the packets
of the frames one decode call emits go as rows, one per stream and
channel, through one ``fastaudio_synth`` call (``ops/audio_lpc.py``): one
launch of K8 on a CUDA decoder.  The oracle engine keeps the host
``ImaAdpcmDecoder`` and ``FastAudioDecoder``, the spec.

Under ``torch.profiler`` the transcoder's layers record spans
(``runtime/metrics.py`` ``span``) beside the decoder's: ``mobiclip.setup``
(building the video decoder), ``mobiclip.demux`` (the container's parsing),
``mobiclip.audio`` (the audio decoders, the IMA and FastAudio calls'
copies, launch and wait included) and ``mobiclip.emit`` (each
``DecodedFrame``'s plane copies, in the frame loop).  None encloses another layer's span and
none is open across a ``yield``, so each stretch of host time belongs to
one layer.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
from pathlib import Path
from typing import Iterator, NamedTuple

import numpy as np
import torch

from ..containers.mods import ModsDemuxer
from ..models.audio_fastaudio import FastAudioDecoder
from ..models.audio_fastaudio_unpack import unpack
from ..models.audio_ima import ImaAdpcmDecoder
from ..models.audio_sx import SxDecoder
from ..models.oracle_video import MobiclipVersion, OracleDecoder
from ..ops import audio_kernels
from ..ops.adpcm import decode_nibbles
from ..ops.audio_lpc import fastaudio_synth
from ..ops.vmem_engine import VmemVideoDecoder
from ..utils import rawio
from .metrics import DecodeMetrics, span


@dataclasses.dataclass
class DecodedFrame:
    index: int
    y: np.ndarray       # (H, W) uint8
    u: np.ndarray       # (H/2, W/2)
    v: np.ndarray
    keyframe: bool
    pcm: np.ndarray | None  # interleaved int16 for this frame, or None
    corrupt: bool = False   # video decode raised; planes are best-effort


def _uv_halves(uv: np.ndarray, W: int, S: int) -> tuple[np.ndarray, np.ndarray]:
    """U/V halves of a packed UV slab in either layout: full-stride rows
    (U at [0,S/2), V at [S/2,S/2+W/2)) or the device-cropped rows the VMEM
    engine produces with crop=True (U|V adjacent in [0,W))."""
    if uv.shape[1] == S:
        return uv[:, :W // 2], uv[:, S // 2:S // 2 + W // 2]
    return uv[:, :W // 2], uv[:, W // 2:W]


def width_stride(width: int) -> int:
    """Reference stride policy (MobiclipDecoder.cs:50-52)."""
    return 256 if width <= 256 else (512 if width <= 512 else 1024)


ENGINES = ("oracle", "cuda", "cpu", "wavefront", "wavefront-cpu")
#: the corpus worker's engines (the JAX package's ``batch`` takes no
#: ``"tpu-xla"`` either)
BATCH_ENGINES = ("oracle", "cuda", "cpu")


def _make_video_decoder(width: int, height: int, version: MobiclipVersion,
                        engine: str):
    with span("mobiclip.setup"):
        return _new_video_decoder(width, height, version, engine)


def _new_video_decoder(width: int, height: int, version: MobiclipVersion,
                       engine: str):
    if engine == "oracle":
        return OracleDecoder(width, height, version)
    if engine in ("cuda", "cpu"):
        # crop=True: results come back at frame width (U|V adjacent)
        return VmemVideoDecoder(width, height, version, device=engine,
                                native=True, crop=True)
    if engine in ("wavefront", "wavefront-cpu"):
        from ..models.pipeline import WavefrontVideoDecoder
        return WavefrontVideoDecoder(
            width, height, version,
            device="cuda" if engine == "wavefront" else "cpu")
    if engine in ("tpu", "tpu-xla"):
        raise ValueError(f"engine {engine!r} belongs to the JAX package; "
                         f"the port's engines are {ENGINES}")
    raise ValueError(f"unknown engine {engine!r}")


#: frames decoded per fused device dispatch on the chunked transcode path
#: once a stream is past its first launches (``launch_frames``)
CHUNK_FRAMES = 16


def launch_frames(pos: int) -> int:
    """The length of a stream's next ``decode_stream_chunk`` call once the
    decoder has been handed ``pos`` of its frames (a frame that failed
    counts): 1, 3, 12, then ``CHUNK_FRAMES`` from a file's start.  The
    first frame waits for one frame's scan and executor launch; each later
    launch takes three times the frames before it, so the frames of a
    launch are decoded long before a player's clock reaches them, and the
    ramp costs two launches more than the parent's grid (each launch pays
    a fixed host cost, about a millisecond on an H100's host).  From frame
    ``CHUNK_FRAMES`` (16 = 1 + 3 + 12) on every launch covers the frames
    of a ``CHUNK_FRAMES`` grid."""
    return min(CHUNK_FRAMES, max(1, 3 * pos))


def launch_lengths(nframes: int, failed=()) -> list[int]:
    """The lengths of the ``decode_stream_chunk`` calls that the chunk
    path makes over a stream of ``nframes`` frames whose frames ``failed``
    fail to scan (``launch_frames``): a call ends at its first failed
    frame, and the next starts after it."""
    out, pos = [], 0
    while pos < nframes:
        n = min(launch_frames(pos), nframes - pos)
        out.append(n)
        bad = [f for f in failed if pos <= f < pos + n]
        pos = bad[0] + 1 if bad else pos + n
    return out


class _Launches:
    """The frame loop's one view of a video decoder: ``decode`` takes the
    next ``size()`` frames of the stream.  A chunk decoder
    (``VmemVideoDecoder``) takes ``launch_frames(pos)`` frames per
    ``decode_stream_chunk`` call, ``pos`` being how many of its frames it
    took (decoded or failed); a call that ``launch_frames`` made shorter
    than ``CHUNK_FRAMES`` is counted in the decoder's ``ramp_launches``
    when a later call shows frames were left over after it (a call cut
    short by the end of the file is not).  A frame decoder (the oracle,
    ``WavefrontVideoDecoder``) takes one frame a call."""

    def __init__(self, dec):
        self.dec = dec
        self.chunked = hasattr(dec, "decode_stream_chunk")
        self.pos = 0
        self._short = False

    def size(self) -> int:
        return launch_frames(self.pos) if self.chunked else 1

    def decode(self, packets: list[bytes]):
        """(the K frames decoded, (K, HH, ·) rows; their K end offsets;
        None, or for the frame that failed after them a function that
        gives the planes it shows)."""
        dec = self.dec
        if not self.chunked:
            try:
                return [self._frame(packets[0])], [dec.offset], None
            except Exception:
                # read at once: the wavefront decoder keeps no ring frame
                # and raises here, chained from the decode's error, as the
                # JAX package's "tpu-xla" engine does
                planes = self._planes()
                return [], [], lambda: planes
        if self._short:
            dec.metrics.add(ramp_launches=1)
        self._short = len(packets) == self.size() < CHUNK_FRAMES
        yuv, offs, err = dec.decode_stream_chunk(packets)
        self.pos += yuv.shape[0] + (err is not None)
        # the failed frame's planes are read when it is emitted, after the
        # call's audio
        return yuv, offs, None if err is None else self._planes

    def _frame(self, pkt: bytes) -> np.ndarray:
        dec = self.dec
        if not isinstance(dec, OracleDecoder):
            return np.concatenate(dec.decode_frame(pkt))
        dec.data, dec.offset = pkt, 0
        dec.decode_frame()
        return self._planes()

    def _planes(self) -> np.ndarray:
        """The decoder's current frame, (HH, S) rows: the oracle's planes,
        partly decoded where its frame failed; else ring slot 0, the last
        frame the decoder committed (the ring advances only when a round
        completes).  So a failed frame shows what the reference player
        shows after its ``catch {}`` (MobiclipDecoder.cs:325-326)."""
        dec = self.dec
        if isinstance(dec, OracleDecoder):
            return np.concatenate([dec.y_planes[0], dec.uv_planes[0]]
                                  ).reshape(-1, dec.stride)
        H, S = dec.height, dec.stride
        return dec.ring_frame_np()[8:8 + H + H // 2, 8:8 + S]


def _nibbles(body: np.ndarray) -> np.ndarray:
    """(..., L) uint8 IMA bytes -> (..., 2L) nibbles, the low one first
    (the host decoder's order)."""
    return np.stack([body & 0xF, body >> 4], axis=-1).reshape(
        *body.shape[:-1], -1)


def _pad(rows: list[np.ndarray], n: int) -> np.ndarray:
    """rows, each (k, ...) with k <= n, stacked int32 and zero-padded to
    (len(rows), n, ...)."""
    out = np.zeros((len(rows), n, *rows[0].shape[1:]), np.int32)
    for r, row in enumerate(rows):
        out[r, :len(row)] = row
    return out


def _upload(parts: list[np.ndarray], device) -> list[torch.Tensor]:
    """int32 arrays on ``device`` in one copy: one buffer, split back into
    views of the arrays' shapes."""
    buf = np.concatenate([np.ravel(a) for a in parts]).astype(np.int32)
    t = torch.from_numpy(buf).to(device)
    return [v.view(a.shape) for v, a in
            zip(torch.split(t, [a.size for a in parts]), parts)]


def _download(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Contiguous int32 or int16 tensors of one device (an even number of
    int16s a tensor) on the host in one copy, each as its dtype and
    shape."""
    words = [t.reshape(-1).view(torch.int32) for t in tensors]
    host = torch.cat(words).cpu().numpy()
    at = np.cumsum([0] + [w.numel() for w in words])
    return [host[a:b].view(np.int16 if t.dtype == torch.int16 else np.int32)
            .reshape(t.shape) for t, a, b in zip(tensors, at, at[1:])]


def _decode_ima(rows: list[np.ndarray], index0, last0, device):
    """IMA ADPCM rows of nibbles, each of its own length, with each row's
    starting (step index, sample), in one ``decode_nibbles`` call on
    ``device``: one copy of the rows (zero-padded to the longest) and their
    states to the device, one copy of the samples and final states back.
    Returns (each row's int16 samples, final index, final last); no call
    where there is no row."""
    if not rows:
        return [], np.empty(0, np.int32), np.empty(0, np.int32)
    lens = np.array([len(r) for r in rows], np.int32)
    args = _upload([_pad(rows, int(lens.max())), np.asarray(index0),
                    np.asarray(last0), lens], device)
    pcm, index, last = _download(*decode_nibbles(*args))
    return ([pcm[r, :n].astype(np.int16) for r, n in enumerate(lens)],
            index, last)


@dataclasses.dataclass
class _ImaRun:
    """One MODS channel's packets from a state to the next restart (or the
    end of a plan): one row of nibbles."""
    index0: int
    last0: int
    bodies: list = dataclasses.field(default_factory=list)
    nibbles: int = 0
    pcm: np.ndarray | None = None
    #: the state after the run's nibbles (its start until it is decoded)
    final: tuple[int, int] = dataclasses.field(init=False)

    def __post_init__(self):
        self.final = (self.index0, self.last0)


class _ModsIma:
    """MODS IMA ADPCM on the video decoder's device.  ``plan`` takes the
    frames about to be emitted, walks their packets as the host decoders
    take them (channels in turn, a 4-byte state header where a channel
    starts or restarts at a keyframe) and decodes them in one
    ``_decode_ima`` call, a row per channel and run of packets; ``take``
    hands each packet's channel and 256 samples out in that order, for
    ``audio_for``'s queues.  A run that goes on past the frames starts
    the next plan from its final state.

    A packet that runs past its payload decodes the nibbles there are and
    leaves zeros where the host decoder leaves ``np.empty``'s; where the
    host decoder raises (a header past the payload, a step index past the
    table), ``take`` raises the same error and planning stops."""

    def __init__(self, nch: int, device):
        self.nch, self.device = nch, device
        #: per channel, the (index, last) its next packet starts from, or
        #: None where that packet carries a header
        self.state: list[tuple[int, int] | None] = [None] * nch
        self.cur = 0
        self.ready: collections.deque = collections.deque()

    def take(self) -> tuple[int, np.ndarray]:
        """The next packet's (channel, 256 samples)."""
        got = self.ready.popleft()
        if isinstance(got, Exception):
            raise got
        return got

    def plan(self, frames) -> None:
        """``frames``: (packet, audio packets, keyframe, audio offset) of
        each frame whose ``audio_for`` decodes audio, in order."""
        runs, took, open_runs = self._walk(frames)
        live = [r for r in runs if r.nibbles]
        pcm, index, last = _decode_ima(
            [_nibbles(np.frombuffer(b"".join(r.bodies), np.uint8))
             for r in live],
            [r.index0 for r in live], [r.last0 for r in live], self.device)
        for r, p, i, v in zip(live, pcm, index, last):
            r.pcm, r.final = p, (int(i), int(v))
        for c, r in enumerate(open_runs):
            if r is not None:
                self.state[c] = r.final
        for t in took:
            if isinstance(t, Exception):
                self.ready.append(t)
                continue
            c, r, a, n = t
            out = np.zeros(256, np.int16)
            if n:
                out[:n] = r.pcm[a:a + n]
            self.ready.append((c, out))

    def _walk(self, frames):
        """The runs of ``frames``' packets; per packet (its channel, its
        run, its first nibble there, its nibbles), or the host decoder's
        error where it would raise, which ends the walk; and each
        channel's open run."""
        runs: list[_ImaRun] = []
        took: list = []
        open_runs: list[_ImaRun | None] = [None] * self.nch
        for pkt, n_audio, is_key, off in frames:
            if is_key:          # IMA restarts at keyframes
                self.state = [None] * self.nch
                open_runs = [None] * self.nch
            for _ in range(n_audio):
                c, self.cur = self.cur, (self.cur + 1) % self.nch
                run = open_runs[c]
                if run is None:
                    start = self.state[c]
                    if start is None:       # the decoder reads a header
                        try:
                            start = (
                                int(np.frombuffer(pkt, "<i2", 1, off)[0])
                                & 0x7F,
                                int(np.frombuffer(pkt, "<i2", 1, off + 2)[0]))
                        except ValueError as err:   # past the payload
                            took.append(err)
                            return runs, took, open_runs
                        off += 4
                    run = open_runs[c] = _ImaRun(*start)
                    runs.append(run)
                body = pkt[off:off + 128]
                off += 128
                if body and not run.nibbles and run.index0 > 88:
                    took.append(IndexError(f"IMA step index {run.index0} is "
                                           f"past the step table"))
                    return runs, took, open_runs
                took.append((c, run, run.nibbles, 2 * len(body)))
                run.bodies.append(body)
                run.nibbles += 2 * len(body)
        return runs, took, open_runs


def decode_mods(data: bytes, engine: str = "oracle") -> Iterator[DecodedFrame]:
    """Decode a MODS container (video + MODS-style per-frame audio packets,
    Program.cs:206-358).  Yields DecodedFrame per frame.

    The frames are read from the file as the frame loop asks for them; the
    per-frame bitstream end offsets the audio layer needs come from the
    video decoder.  The IMA packets of the frames one decode call emits are
    decoded together (``_ModsIma``)."""
    with span("mobiclip.demux"):
        dm = ModsDemuxer(data)
    h = dm.header
    dec = _make_video_decoder(h.width, h.height, MobiclipVersion.MODS_DS,
                              engine)
    nch = h.nb_channel
    has_audio = h.audio_codec in (1, 2, 3) and nch > 0 and h.frequency > 0

    def _fresh_decoders():
        return ([ImaAdpcmDecoder() for _ in range(nch)],
                [SxDecoder() for _ in range(nch)],
                [FastAudioDecoder() for _ in range(nch)],
                [False] * nch)

    adpcm, sxd, fad, sx_init = _fresh_decoders()
    queues: list[list[np.ndarray]] = [[] for _ in range(nch)]
    cur_channel = 0
    ima = (_ModsIma(nch, dec.device) if has_audio and h.audio_codec == 3
           and engine != "oracle" else None)

    def audio_offset(pkt: bytes, end_off: int) -> int:
        # audio starts where the video bit reader stopped, minus its
        # one-word over-read (Program.cs:250-252); TagId 'N3' quirk: +4
        off = end_off - 2
        if h.tag_id == 0x334E and len(pkt) >= 2 \
                and (pkt[0] | (pkt[1] << 8)) & 0x8000:
            off += 4
        return off

    def spec_packets(pkt: bytes, n_audio: int, is_key: bool,
                     end_off: int) -> None:
        """A frame's audio packets through the host decoders, into
        ``queues``."""
        nonlocal adpcm, sxd, fad, sx_init, cur_channel
        off = audio_offset(pkt, end_off)
        if is_key and h.audio_codec == 3:
            adpcm, sxd, fad, sx_init = _fresh_decoders()
        for _ in range(n_audio):
            if h.audio_codec == 3:          # IMA ADPCM
                d = adpcm[cur_channel]
                ln = 128 + (0 if d.is_init else 4)
                queues[cur_channel].append(d.decode(pkt, off, ln))
                off += ln
            elif h.audio_codec == 1:        # Sx (Program.cs:277-287)
                s = sxd[cur_channel]
                if not sx_init[cur_channel]:
                    s.codebook = dm.audio_codebooks[cur_channel]
                    sx_init[cur_channel] = True
                s.data = pkt
                s.offset = off
                queues[cur_channel].append(s.decode())
                off = s.offset
            elif h.audio_codec == 2:        # FastAudio (Program.cs:289-300)
                f = fad[cur_channel]
                f.data = pkt
                f.offset = off
                queues[cur_channel].append(f.decode())
                off = f.offset
            cur_channel = (cur_channel + 1) % nch

    def audio_for(pkt: bytes, n_audio: int, is_key: bool,
                  end_off: int) -> np.ndarray | None:
        nonlocal queues
        if n_audio <= 0 or not has_audio:
            return None
        if is_key and h.audio_codec == 3:
            # IMA resets at keyframes (Program.cs:255-265)
            queues = [[] for _ in range(nch)]
        if ima is not None:     # IMA ADPCM: the packets _ModsIma walked
            for _ in range(n_audio):
                c, pcm = ima.take()
                queues[c].append(pcm)
        else:
            spec_packets(pkt, n_audio, is_key, end_off)
        smallest = min((sum(len(a) for a in q) for q in queues), default=0)
        if smallest <= 0:
            return None
        chans = []
        for i in range(nch):
            buf = np.concatenate(queues[i]) if queues[i] else \
                np.empty(0, np.int16)
            chans.append(buf[:smallest])
            rest = buf[smallest:]
            queues[i] = [rest] if len(rest) else []
        return rawio.interleave_channels(chans)

    def records():
        while True:
            with span("mobiclip.demux"):
                rec = dm.read_frame()
            if rec is None:
                return
            yield rec

    def side(recs, offs):
        """Each frame's (keyframe, PCM): the IMA packets of the frames
        decoded, decoded together on the video decoder's device, then each
        frame's audio; a failed frame gets none.  Lazy, so that audio that
        raises does so after the frames before it were yielded, as the
        host decoders do."""
        if ima is not None:
            with span("mobiclip.audio"):
                ima.plan([(pkt, n, key, audio_offset(pkt, end))
                          for (pkt, n, key), end in zip(recs, offs) if n > 0])
        for rec, end in zip(recs, offs):
            with span("mobiclip.audio"):
                pcm = audio_for(*rec, end)
            yield rec[2], pcm
        if len(recs) > len(offs):
            yield recs[-1][2], None

    yield from _chunked_video_frames(dec, records(), side)


def transcode(path: str | Path, out_prefix: str | Path,
              engine: str = "oracle", fmt: str = "y4m") -> dict:
    """File -> <prefix>.y4m (+ <prefix>.wav when the container carries audio)
    or <prefix>.avi (``fmt="avi"``, the reference converter's output format,
    MobiConverter/Program.cs:72,329-353).  Signature-based container dispatch
    like the reference apps (Form1.cs:193-224).  Returns summary stats."""
    data = Path(path).read_bytes()

    def _write(frames, name, width, height, fps, freq=0, nch=1,
               moflex_rgb=True):
        if fmt == "avi":
            from ..utils.avi import AviWriter
            avi = AviWriter(str(out_prefix) + ".avi", width, height, fps,
                            audio_rate=freq, audio_channels=nch)
            n = 0
            has_pcm = False
            for fr in frames:
                avi.add_frame(rawio.yuv_to_rgb(fr.y, fr.u, fr.v, moflex_rgb))
                if fr.pcm is not None:
                    avi.add_audio(fr.pcm)
                    has_pcm = True
                n += 1
            avi.close()
            return {"container": name, "frames": n, "audio": has_pcm,
                    "width": width, "height": height, "format": "avi"}
        y4m = rawio.Y4MWriter(str(out_prefix) + ".y4m", width, height, fps)
        pcm_parts = []
        n = 0
        for fr in frames:
            y4m.add_frame(fr.y, fr.u, fr.v)
            if fr.pcm is not None:
                pcm_parts.append(fr.pcm)
            n += 1
        y4m.close()
        if pcm_parts and freq:
            rawio.write_wav(str(out_prefix) + ".wav",
                            np.concatenate(pcm_parts), freq, nch)
        return {"container": name, "frames": n, "audio": bool(pcm_parts),
                "width": width, "height": height, "format": "y4m"}

    if data[:4] == b"MOC5":
        from ..containers.moc5 import Moc5Header
        h = Moc5Header.parse(data)
        return _write(decode_moc5(data, engine=engine), "moc5",
                      h.width, h.height, h.fps)
    if str(path).endswith(".vx2"):
        from ..containers.vx import VX2_HEIGHT, VX2_WIDTH
        return _write(decode_vx2(data, engine=engine), "vx2",
                      VX2_WIDTH, VX2_HEIGHT, 20.0, freq=32768, nch=1)
    if data[:2] == b"\x4c\x32":
        from ..containers.moflex import MoflexDemuxer, VideoStream, \
            VideoStreamWithLayout, AudioStream
        # probe stream declarations for geometry/fps/audio params
        info = {}

        def probe(chunk, _):
            if isinstance(chunk, (VideoStream, VideoStreamWithLayout)) \
                    and "w" not in info:
                info.update(w=chunk.width, h=chunk.height,
                            fps=chunk.fps_rate / max(chunk.fps_scale, 1))
            if isinstance(chunk, AudioStream) and "freq" not in info:
                info.update(freq=chunk.frequency, nch=chunk.channels)
        dm = MoflexDemuxer(data, on_frame=probe)
        dm.read_packet()
        dm.read_packet()
        if "w" not in info:
            for _, (chunk, _b) in dm.streams.items():
                probe(chunk, b"")
        return _write(decode_moflex(data, engine=engine), "moflex",
                      info.get("w", 256), info.get("h", 192),
                      info.get("fps", 24.0), freq=info.get("freq", 0),
                      nch=info.get("nch", 1))
    if data[:4] == b"MODS":
        dm = ModsDemuxer(data)
        h = dm.header
        return _write(decode_mods(data, engine=engine), "mods",
                      h.width, h.height, h.fps_float, freq=h.frequency,
                      nch=h.nb_channel, moflex_rgb=False)
    raise ValueError("unrecognized container signature")


def probe_info(path: str | Path) -> dict:
    """Container header probe without decoding (the role of the reference
    apps' signature dispatch + header display, Form1.cs:188-224)."""
    data = Path(path).read_bytes()
    if data[:4] == b"MOC5":
        from ..containers.moc5 import Moc5Header
        h = Moc5Header.parse(data)
        return {"container": "moc5", "codec": "mobiclip/moflex3ds-profile",
                "width": h.width, "height": h.height, "fps": h.fps}
    if str(path).endswith(".vx2"):
        from ..containers.vx import VX2_HEIGHT, VX2_WIDTH
        return {"container": "vx2", "codec": "mobiclip/moflex3ds-profile",
                "width": VX2_WIDTH, "height": VX2_HEIGHT, "fps": 20.0,
                "audio": "pcm16 mono 32768 Hz"}
    if data[:4] == b"VXDS":
        from ..containers.vx import VxDemuxer
        h = VxDemuxer(data).header
        return {"container": "vx", "codec": "mobiclip-vx (decode stub)",
                "width": h.width, "height": h.height,
                "frame_count": h.frame_count}
    if data[:2] == b"\x4c\x32":
        from ..containers.moflex import (AudioStream, MoflexDemuxer,
                                         VideoStream, VideoStreamWithLayout)
        info: dict = {"container": "moflex", "streams": []}

        def probe(chunk, _):
            rec = None
            if isinstance(chunk, (VideoStream, VideoStreamWithLayout)):
                rec = {"type": "video", "index": chunk.stream_index,
                       "width": chunk.width, "height": chunk.height,
                       "fps": chunk.fps_rate / max(chunk.fps_scale, 1)}
                if isinstance(chunk, VideoStreamWithLayout):
                    rec["layout"] = int(chunk.layout)
            elif isinstance(chunk, AudioStream):
                rec = {"type": "audio", "index": chunk.stream_index,
                       "codec": {0: "fastaudio", 1: "ima-adpcm",
                                 2: "pcm16"}.get(chunk.codec_id,
                                                 str(chunk.codec_id)),
                       "frequency": chunk.frequency,
                       "channels": chunk.channels}
            if rec is not None and rec not in info["streams"]:
                info["streams"].append(rec)
        dm = MoflexDemuxer(data, on_frame=probe)
        dm.read_packet()
        dm.read_packet()
        for _, (chunk, _b) in dm.streams.items():
            probe(chunk, b"")
        return info
    if data[:4] == b"MODS":
        h = ModsDemuxer(data).header
        return {"container": "mods", "codec": "mobiclip/mods-ds-profile",
                "width": h.width, "height": h.height,
                "fps": h.fps_float, "frame_count": h.frame_count,
                "audio_codec": {1: "sx", 2: "fastaudio",
                                3: "ima-adpcm"}.get(h.audio_codec, "none"),
                "channels": h.nb_channel, "frequency": h.frequency,
                "keyframes": h.keyframe_count}
    raise ValueError("unrecognized container signature")


def play(path: str | Path, engine: str = "cuda", realtime: bool = True,
         dump_frame: int | None = None,
         dump_path: str | Path | None = None,
         pipe_y4m: str | None = None,
         pipe_wav: str | None = None) -> dict:
    """Player (the Form1 player's decode/pacing loop, Form1.cs:486-535):
    decodes frames, paces against 1/fps when ``realtime``, reports achieved
    fps + deadline misses.  ``dump_frame`` writes one RGB frame as PPM.
    ``pipe_y4m`` streams paced display frames as YUV4MPEG2 to a path/FIFO
    or stdout ('-') — the live viewing surface:
    ``play clip.mods --pipe-y4m - | mpv -``.  ``pipe_wav`` streams the
    decoded PCM alongside (the NAudio-output analog, Form1.cs:549-558):
    ``mpv video.y4m --audio-file=audio.wav`` over two FIFOs."""
    import time

    info = probe_info(path)
    data = Path(path).read_bytes()
    arate, ach = 0, 0
    is3d = False
    if info["container"] == "moflex":
        vids = [s for s in info["streams"] if s["type"] == "video"]
        fps = vids[0]["fps"] if vids else 24.0
        # 3D layouts: the reference player decodes every frame (decoder
        # state continuity) but DISPLAYS alternate frames (the left eye,
        # starting with the first) at a doubled interval
        # (Form1.cs:516-530: `left = !left`, 2000 ms / fps)
        is3d = bool(vids) and vids[0].get("layout", 0) != 0
        auds = [s for s in info["streams"] if s["type"] == "audio"]
        if auds:
            arate, ach = auds[0]["frequency"], auds[0]["channels"]
        frames = decode_moflex(data, engine=engine)
        moflex_rgb = True
    elif info["container"] == "mods":
        fps = info["fps"]
        if info.get("audio_codec", "none") != "none":
            arate, ach = info["frequency"], info["channels"]
        frames = decode_mods(data, engine=engine)
        moflex_rgb = False
    elif info["container"] == "moc5":
        fps = info["fps"]
        frames = decode_moc5(data, engine=engine)
        moflex_rgb = True
    elif info["container"] == "vx2":
        fps = info["fps"]
        arate, ach = 32768, 1
        frames = decode_vx2(data, engine=engine)
        moflex_rgb = True
    else:
        raise ValueError("unplayable container")
    period = (2.0 if is3d else 1.0) / max(fps, 1e-3)
    t0 = time.perf_counter()
    n = 0
    late = 0
    n_samples = 0
    sink = None
    asink = None
    left = False
    try:
        for fr in frames:
            left = not left
            # audio attached to ANY decoded frame plays — the reference only
            # toggles *display* on the left/right eye (Form1.cs:516-530);
            # audio chunks decode and buffer regardless of the toggle
            if pipe_wav is not None and fr.pcm is not None and arate:
                if asink is None:
                    asink = rawio.LiveWavPipe(pipe_wav, arate, ach)
                asink.add(fr.pcm)
                n_samples += len(fr.pcm)
            if dump_frame is not None and fr.index == dump_frame:
                rgb = rawio.yuv_to_rgb(fr.y, fr.u, fr.v, moflex_rgb)
                rawio.write_ppm(dump_path or (str(path)
                                              + f".{fr.index}.ppm"), rgb)
            if is3d and not left:
                # right-eye frame: decoded (state + audio), not displayed
                continue
            deadline = t0 + (n + 1) * period
            now = time.perf_counter()
            if pipe_y4m is not None:
                if sink is None:
                    sink = rawio.LiveY4MPipe(pipe_y4m, fr.y.shape[1],
                                             fr.y.shape[0],
                                             fps / 2 if is3d else fps)
                sink.add_rgb(rawio.yuv_to_rgb(fr.y, fr.u, fr.v, moflex_rgb))
            if realtime:
                if now > deadline:
                    late += 1
                else:
                    # busy-wait pacing like HiResTimer (Form1.cs:530-535)
                    while time.perf_counter() < deadline:
                        pass
            n += 1
    finally:
        if sink is not None:
            sink.close()
        if asink is not None:
            asink.close()
    wall = time.perf_counter() - t0
    return {"frames": n, "fps_target": round(fps, 3), "is3d": is3d,
            "fps_achieved": round(n / wall, 2) if wall else 0.0,
            "audio_samples": n_samples,
            "late_frames": late, "realtime": realtime and late == 0}


def decode_moflex(data: bytes, engine: str = "oracle",
                  video_stream: int | None = None):
    """Decode a Moflex container (video + audio streams; Form1.cs:510-633
    consumption policy).  Yields DecodedFrame for video frames; audio PCM is
    attached to the most recent video frame boundary (interleaved int16)."""
    from ..containers.moflex import (AudioStream, MoflexDemuxer, VideoStream,
                                     VideoStreamWithLayout)

    dec = None
    vid = video_stream
    # audio since the last video frame: PCM, and IMA and FastAudio chunks
    # not yet decoded
    pcm_pending: list[np.ndarray | _ImaChunk | _FastAudioChunk] = []
    fads: dict[int, list[FastAudioDecoder]] = {}
    fastaudio = _FastAudio()

    def decode_audio_chunk(chunk, payload: bytes) -> None:
        ch = chunk.channels
        if chunk.codec_id == 1 and engine != "oracle":
            # IMA ADPCM, decoded with the frame it is attached to
            pcm_pending.append(_ImaChunk.parse(payload, ch))
        elif chunk.codec_id == 0 and engine != "oracle":
            # FastAudio, decoded with the frame it is attached to
            pcm_pending.append(fastaudio.parse(payload, chunk))
        elif chunk.codec_id == 1:  # IMA ADPCM (Form1.cs:601-630)
            decs = [ImaAdpcmDecoder() for _ in range(ch)]
            for i in range(ch):
                decs[i].decode(payload, 4 * i, 4)
            chans: list[list[np.ndarray]] = [[] for _ in range(ch)]
            off = 4 * ch
            while off + 128 * ch < len(payload):
                for i in range(ch):
                    chans[i].append(decs[i].decode(payload, off, 128))
                    off += 128
            arrs = [np.concatenate(c) if c else np.empty(0, np.int16)
                    for c in chans]
            pcm_pending.append(rawio.interleave_channels(arrs))
        elif chunk.codec_id == 2:  # PCM16 (Form1.cs:631-633)
            n = len(payload) - (len(payload) % (ch * 2))
            pcm_pending.append(
                np.frombuffer(payload[:n], dtype="<i2").copy())
        elif chunk.codec_id == 0:  # FastAudio (Form1.cs:561-599)
            decs = fads.setdefault(chunk.stream_index,
                                   [FastAudioDecoder() for _ in range(ch)])
            chans2: list[list[np.ndarray]] = [[] for _ in range(ch)]
            off = 0
            while off + 40 < len(payload):
                for i in range(ch):
                    decs[i].data = payload
                    decs[i].offset = off
                    chans2[i].append(decs[i].decode())
                    off = decs[i].offset
            arrs = [np.concatenate(c) if c else np.empty(0, np.int16)
                    for c in chans2]
            pcm_pending.append(rawio.interleave_channels(arrs))

    def video_frames():
        """The chosen video stream's frames, each (payload, the audio
        pieces since the frame before it or None); the decoder is built
        at the first.  The demuxer's callback only queues each frame, so
        that the decode of a packet's frames runs outside its parse
        (mobiclip.demux); audio after the last video frame is dropped."""
        nonlocal dec, vid
        received: list[tuple[object, bytes]] = []
        dm = MoflexDemuxer(data,
                           on_frame=lambda c, p: received.append((c, p)))
        stall = 0
        last_pos = -1
        while True:
            with span("mobiclip.demux"):
                r = dm.read_packet()
            for chunk, payload in received:
                if isinstance(chunk, (VideoStream, VideoStreamWithLayout)):
                    if vid is None:
                        vid = chunk.stream_index
                    if chunk.stream_index != vid:
                        continue
                    if dec is None:
                        dec = _make_video_decoder(
                            chunk.width, chunk.height,
                            MobiclipVersion.MOFLEX_3DS, engine)
                    audio = list(pcm_pending) if pcm_pending else None
                    pcm_pending.clear()
                    yield payload, audio
                elif isinstance(chunk, AudioStream):
                    try:
                        with span("mobiclip.audio"):
                            decode_audio_chunk(chunk, payload)
                    except Exception:
                        pass  # corrupt audio packet: drop it, keep going
            received.clear()
            if r in (1, 0x80):
                return
            if dm.position == last_pos:
                stall += 1
                if stall > 2:
                    return
            else:
                stall = 0
            last_pos = dm.position

    def side(items, _offs):
        """Each frame's (keyframe, PCM); a failed frame keeps its PCM."""
        return [(False, pcm) for pcm in
                _frame_pcm([a for _p, a in items], dec, fastaudio)]

    frames = video_frames()
    first = next(frames, None)
    if first is not None:
        yield from _chunked_video_frames(
            dec, itertools.chain([first], frames), side)


class _ImaChunk(NamedTuple):
    """A Moflex IMA ADPCM audio chunk (Form1.cs:601-630), parsed when it
    arrives and decoded with the video frames it is attached to: each
    channel's 4-byte state, then 128-byte blocks, the channels in turn,
    taken while more than one block per channel remains."""
    index0: np.ndarray      # (ch,) int32
    last0: np.ndarray       # (ch,) int32
    nibbles: np.ndarray     # (ch, blocks * 256) uint8

    @classmethod
    def parse(cls, payload: bytes, ch: int) -> "_ImaChunk":
        """Raises where the host decoder raises, so that the chunk is
        dropped: a payload shorter than its headers, a step index past the
        table where a block is decoded."""
        if ch < 1 or len(payload) < 4 * ch:
            raise ValueError(f"IMA chunk of {len(payload)} bytes: shorter "
                             f"than the headers of {ch} channels")
        head = np.frombuffer(payload, "<i2", 2 * ch).reshape(ch, 2).astype(
            np.int32)
        index0 = head[:, 0] & 0x7F
        blocks = max(0, (len(payload) - 4 * ch - 1) // (128 * ch))
        if blocks and (index0 > 88).any():
            raise IndexError(f"IMA step index {index0.max()} is past the "
                             f"step table")
        body = np.frombuffer(payload, np.uint8, blocks * 128 * ch, 4 * ch)
        return cls(index0, head[:, 1], _nibbles(
            body.reshape(blocks, ch, 128).transpose(1, 0, 2).reshape(ch, -1)))


_NO_PCM = np.empty(0, np.int16)


class _FastAudioChunk(NamedTuple):
    """A Moflex FastAudio chunk (Form1.cs:561-599), parsed when it arrives
    and decoded with the video frames it is attached to: rounds of one
    40-byte packet per channel, the channels in turn, begun while more
    than 40 bytes remain.  Where a round's packet runs past the payload
    (or its channel has no decoder), the host loop raises there: the chunk
    is dropped, but the packets before that one have advanced their
    channels' state."""
    stream: int             # the stream whose decoders it advances
    counts: np.ndarray      # (n,) the packets channel c decodes
    excit: np.ndarray       # (n, P, 256) int32 each packet's excitation
    coef: np.ndarray        # (n, P, 8) int32 and its LPC coefficients
    dropped: bool           # the host loop raised: no PCM

    @classmethod
    def parse(cls, payload: bytes, ch: int, stream: int,
              decoders: int) -> "_FastAudioChunk":
        """``ch``: the chunk's channels; ``decoders``: how many channels
        its stream's decoders have (the stream's first chunk's)."""
        L, step = len(payload), 40 * ch
        begun = (L - 41) // step + 1 if L > 40 else 0
        whole = 0 if ch > decoders else min(begun, L // step)
        counts = np.full(min(ch, decoders), whole)
        if begun > whole:   # the round the host loop raises in
            counts[:min((L - whole * step) // 40, decoders)] += 1
        P = int(counts.max(initial=0))
        body = np.zeros(P * step, np.uint8)
        body[:min(L, P * step)] = np.frombuffer(payload, np.uint8,
                                                min(L, P * step))
        excit, coef = unpack(body.reshape(P, ch, 40)[:, :len(counts)]
                             .transpose(1, 0, 2))
        return cls(stream, counts, excit, coef, begun > whole)


class _FastAudio:
    """A Moflex file's FastAudio on the video decoder's device.  As the
    host loop keys its decoders by stream and makes them at the stream's
    first chunk, this keeps each stream's channel count from its first
    chunk and its channels' lattice state (hist, r9) from one decode call
    to the next; nothing resets it."""

    def __init__(self):
        self.channels: dict[int, int] = {}
        self.state: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def parse(self, payload: bytes, chunk) -> _FastAudioChunk:
        n = self.channels.setdefault(chunk.stream_index, chunk.channels)
        return _FastAudioChunk.parse(payload, chunk.channels,
                                     chunk.stream_index, n)

    def decode(self, chunks: list[_FastAudioChunk], dec) -> list:
        """Each chunk's interleaved PCM, None where it is dropped: every
        packet of ``chunks`` in one ``_decode_fastaudio`` call on ``dec``'s
        device, a row per stream and channel, each row's packets in the
        order they arrived.  Counts the samples in ``fastaudio_samples``."""
        runs: dict[tuple[int, int], list] = {}
        for c in chunks:
            for k, n in enumerate(c.counts):
                if n:
                    runs.setdefault((c.stream, k), []).append(
                        (c.excit[k, :n], c.coef[k, :n]))
        rows = list(runs)
        for s in {s for s, _k in rows} - set(self.state):
            n = self.channels[s]
            self.state[s] = (np.zeros((n, 8), np.int32),
                             np.zeros(n, np.int32))
        pcm, hist, r9 = _decode_fastaudio(
            [(np.concatenate([e for e, _c in runs[r]]),
              np.concatenate([c for _e, c in runs[r]])) for r in rows],
            np.array([self.state[s][0][k] for s, k in rows]).reshape(-1, 8),
            np.array([self.state[s][1][k] for s, k in rows], np.int32),
            dec.device)
        metrics = getattr(dec, "metrics", None) or DecodeMetrics()
        metrics.add(fastaudio_samples=sum(map(len, pcm)))
        for r, (s, k) in enumerate(rows):
            self.state[s][0][k], self.state[s][1][k] = hist[r], r9[r]
        pcm = dict(zip(rows, pcm))
        at: dict[tuple[int, int], int] = {}     # each row's samples taken
        out = []
        for c in chunks:
            chans = []
            for k, n in enumerate(c.counts):
                a = at.get((c.stream, k), 0)
                chans.append(pcm.get((c.stream, k), _NO_PCM)[a:a + 256 * n])
                at[c.stream, k] = a + 256 * n
            out.append(None if c.dropped else
                       rawio.interleave_channels(chans))
        return out


def _decode_fastaudio(rows: list[tuple[np.ndarray, np.ndarray]], hist0, r9_0,
                      device):
    """FastAudio rows, each its packets' excitation (n, 256) and LPC
    coefficients (n, 8) with its starting state (hist (8,), r9), in one
    ``fastaudio_synth`` call on ``device``: one copy of the rows (padded
    to the longest with packets of zeros), their states and packet counts
    to the device, one copy of the samples and final states back.  On the
    CPU the lattice is K8's own code in its g++ build, on the arrays as
    they are (``fastaudio_synth``'s plain version steps through the
    samples in Python).  Returns (each row's int16 samples, final hist
    (M, 8), final r9 (M,)); no call where there is no row."""
    if not rows:
        return [], np.empty((0, 8), np.int32), np.empty(0, np.int32)
    lens = np.array([len(e) for e, _c in rows], np.int32)
    P = int(lens.max())
    excit = _pad([e for e, _c in rows], P).reshape(len(rows), P * 256)
    parts = [excit, _pad([c for _e, c in rows], P),
             np.reshape(hist0, (-1, 8)), np.asarray(r9_0), lens]
    if torch.device(device).type == "cpu":
        pcm, hist, r9 = audio_kernels.fastaudio_synth_host(*parts)
    else:
        pcm, hist, r9 = _download(*fastaudio_synth(*_upload(parts, device)))
    return [pcm[b, :256 * k] for b, k in enumerate(lens)], hist, r9


def _frame_pcm(audio: list[list | None], dec,
               fastaudio: _FastAudio) -> list[np.ndarray | None]:
    """Each Moflex frame's PCM: its audio pieces in arrival order, joined
    (None where it has none, a dropped FastAudio chunk counting as none).
    The IMA chunks among them are decoded together, in one ``_decode_ima``
    call on the video decoder's device, and so are the FastAudio chunks,
    in one ``_decode_fastaudio`` call."""
    pieces = [p for a in audio if a for p in a]
    ima = [p for p in pieces if isinstance(p, _ImaChunk)]
    fas = [p for p in pieces if isinstance(p, _FastAudioChunk)]
    if ima or fas:
        with span("mobiclip.audio"):
            done_fa = iter(fastaudio.decode(fas, dec) if fas else ())
            rows = [(c, i) for c in ima if c.nibbles.shape[1]
                    for i in range(len(c.index0))]
            pcm = iter(_decode_ima([c.nibbles[i] for c, i in rows],
                                   [c.index0[i] for c, i in rows],
                                   [c.last0[i] for c, i in rows],
                                   dec.device)[0])
            done = iter([rawio.interleave_channels(
                [next(pcm) if c.nibbles.shape[1] else np.empty(0, np.int16)
                 for _ in c.index0]) for c in ima])
    out = []
    for a in audio:
        parts = [next(done) if isinstance(p, _ImaChunk) else
                 next(done_fa) if isinstance(p, _FastAudioChunk) else p
                 for p in a or ()]
        parts = [p for p in parts if p is not None]
        out.append(np.concatenate(parts) if parts else None)
    return out


def _chunked_video_frames(dec, items, side=None) -> Iterator[DecodedFrame]:
    """The transcoder's one frame loop, for every container and every
    engine.  ``items`` yields each frame's (packet, the container's side
    data...) in order, and is read only as far as the decoder needs: the
    loop takes ``size()`` items, or what is left, per ``_Launches.decode``
    call.  ``side(items, offsets)`` gives each item of a call, its K frames
    decoded (``offsets``: their end offsets) and then the failed one, its
    (keyframe, PCM); with no ``side`` each item is (packet, keyframe,
    PCM).  A failed frame shows the planes ``_Launches`` gives for it, with
    ``corrupt=True``."""
    launches = _Launches(dec)
    W, H, S = dec.width, dec.height, dec.stride
    items = iter(items)
    pending: list = []
    index = 0
    while True:
        pending += itertools.islice(items, launches.size() - len(pending))
        if not pending:
            return
        yuv, offs, shown = launches.decode([it[0] for it in pending])
        K = len(yuv)
        n = K + (shown is not None)
        done, pending = pending[:n], pending[n:]
        sides = side(done, offs) if side else (it[1:] for it in done)
        for k, (keyframe, pcm) in enumerate(sides):
            planes = yuv[k] if k < K else shown()
            with span("mobiclip.emit"):
                u, v = _uv_halves(planes[H:], W, S)
                frame = DecodedFrame(
                    index=index, y=planes[:H, :W].copy(), u=u.copy(),
                    v=v.copy(), keyframe=keyframe, pcm=pcm, corrupt=k == K)
            index += 1
            yield frame


def decode_moc5(data: bytes, engine: str = "oracle") -> Iterator[DecodedFrame]:
    """Decode a MOC5 (Wii) container: video-only, Moflex3DS codec profile
    (Form1.cs:282-320; audio format unknown upstream, README.md:14).  The
    whole frame walk runs up front under one ``mobiclip.demux`` span."""
    from ..containers.moc5 import Moc5Demuxer
    with span("mobiclip.demux"):
        dm = Moc5Demuxer(data)
        packets = list(dm.frames())
    h = dm.header
    dec = _make_video_decoder(h.width, h.height, MobiclipVersion.MOFLEX_3DS,
                              engine)
    yield from _chunked_video_frames(
        dec, ((pkt, i == 0, None) for i, pkt in enumerate(packets)))


def decode_vx2(data: bytes, engine: str = "oracle") -> Iterator[DecodedFrame]:
    """Decode a raw VX2 stream: 256x192 Moflex3DS-profile video with
    interleaved raw mono PCM16 chunks (Program.cs:367-438)."""
    from ..containers.vx import VX2_HEIGHT, VX2_WIDTH, Vx2Demuxer
    dm = Vx2Demuxer(data)
    dec = _make_video_decoder(VX2_WIDTH, VX2_HEIGHT,
                              MobiclipVersion.MOFLEX_3DS, engine)
    yield from _chunked_video_frames(dec, (
        (pkt, i == 0, None if pcm is None
         else np.frombuffer(pcm, dtype="<i2").copy())
        for i, (pkt, pcm) in enumerate(dm.frames())))


def read_y4m(path: str | Path):
    """Minimal YUV4MPEG2 reader (4:2:0): yields (y, u, v) + (W, H, fps)."""
    data = Path(path).read_bytes()
    nl = data.index(b"\n")
    fields = data[:nl].split(b" ")
    W = H = 0
    fps = 24.0
    for f in fields[1:]:
        if f[:1] == b"W":
            W = int(f[1:])
        elif f[:1] == b"H":
            H = int(f[1:])
        elif f[:1] == b"F":
            num, den = f[1:].split(b":")
            fps = int(num) / int(den)
    pos = nl + 1
    frames = []
    ysz, csz = W * H, (W // 2) * (H // 2)
    while pos < len(data) and data[pos:pos + 5] == b"FRAME":
        pos = data.index(b"\n", pos) + 1
        y = np.frombuffer(data, np.uint8, ysz, pos).reshape(H, W)
        u = np.frombuffer(data, np.uint8, csz, pos + ysz).reshape(H // 2, W // 2)
        v = np.frombuffer(data, np.uint8, csz,
                          pos + ysz + csz).reshape(H // 2, W // 2)
        frames.append((y, u, v))
        pos += ysz + 2 * csz
    return frames, (W, H, fps)


def encode_y4m_to_moflex(in_path: str | Path, out_path: str | Path,
                         qp: int = 0x16, gop: int = 30, *,
                         device="cuda") -> dict:
    """Encode a .y4m into a single-video-stream .moflex (the role of
    MoflexSimpleVideoMuxer, MoflexSimpleVideoMuxer.cs:14-71).  The motion
    search's SAD volume runs on ``device``."""
    from ..containers.moflex import MoflexMuxer, VideoStream
    from ..models.encoder import MobiclipEncoder
    frames, (W, H, fps) = read_y4m(in_path)
    enc = MobiclipEncoder(W, H, MobiclipVersion.MOFLEX_3DS,
                          quantizer=qp, gop=gop, device=device)
    mux = MoflexMuxer([VideoStream(stream_index=0, codec_id=0,
                                   fps_rate=int(round(fps * 1000)),
                                   fps_scale=1000, width=W, height=H)])
    for y, u, v in frames:
        mux.add_frame(0, enc.encode_frame(y, u, v))
    Path(out_path).write_bytes(mux.to_bytes())
    return {"frames": len(frames), "width": W, "height": H,
            "bytes": Path(out_path).stat().st_size}


def split_stereo(frames, layout):
    """3D stream handling (Form1.cs:516-535 parity): for the interleaved
    3D layouts, even/odd frames are left/right eyes; returns (left, right)
    frame lists.  For Simple2D returns (frames, [])."""
    from ..containers.moflex import VideoLayout
    frames = list(frames)
    if layout in (VideoLayout.INTERLEAVE_3D_LEFT_FIRST,
                  VideoLayout.INTERLEAVE_3D_RIGHT_FIRST):
        a = frames[0::2]
        b = frames[1::2]
        if layout == VideoLayout.INTERLEAVE_3D_RIGHT_FIRST:
            a, b = b, a
        return a, b
    return frames, []


def anaglyph(left_rgb, right_rgb):
    """Red/cyan anaglyph compositor (Form1.cs:652-675 role): left frame's
    red channel + right frame's green/blue."""
    out = right_rgb.copy()
    out[..., 0] = left_rgb[..., 0]
    return out
