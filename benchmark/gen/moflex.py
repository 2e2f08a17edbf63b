"""Moflex (3DS) container: packet-synchronized demuxer + muxer.

Mirror of the reference MoLiveDemux (LibMobiclip/Containers/Moflex/
MoLiveDemux.cs:11-416): packets framed by a 14-byte synchro header (magic
`4C 32`, 16-bit checksum, 64-bit BE timestamp, 16-bit packet size), optional
stream-declaration chunks (7-bit base-128 varints for id/size, MoLive.cs),
a data-block flags byte (variable-packet-size bit, packet-counting bit, 6-bit
synchro counter), then elementary packets (EPs) with a big-endian bit-packed
header: unary-length stream index, end-frame flag, unary frame type + signed
var-length PTS, 13-bit size-1.  Completed frames get 2 zero bytes appended
(the video bit reader's over-read tolerance, MoLiveDemux.cs:353).

Error codes and the Desynchronize/rescan recovery tier mirror the reference
(:57-65, 81-258) — this is the corrupt-stream resilience story for batch jobs.
"""
from __future__ import annotations

import dataclasses
import enum
import struct
from typing import Callable


# ------------------------------------------------------------- bit helpers
class BeBitReader:
    """64-bit big-endian bit reader with byte-granular consumption
    (MoLiveInBitStream.cs:9-57): after reads, `pos` counts whole bytes
    pulled, i.e. ceil(bits/8) — EP headers are byte-aligned via this."""

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.value = 0
        self.remaining = 0

    def pop(self, nbits: int) -> int:
        while self.remaining < nbits:
            self.value |= self.data[self.pos] << (56 - self.remaining)
            self.value &= (1 << 64) - 1
            self.pos += 1
            self.remaining += 8
        out = self.value >> (64 - nbits) if nbits else 0
        self.value = (self.value << nbits) & ((1 << 64) - 1)
        self.remaining -= nbits
        return out


class BeBitWriter:
    def __init__(self) -> None:
        self.bits: list[int] = []

    def put(self, value: int, nbits: int) -> None:
        for i in range(nbits - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def to_bytes(self) -> bytes:
        bits = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(
            sum(bits[i + j] << (7 - j) for j in range(8))
            for i in range(0, len(bits), 8))


def read_varint7(data: bytes, pos: int, psize: int) -> tuple[int, int] | None:
    """Base-128 BE varint, 1-4 bytes (MoLive.cs:34-51)."""
    value = 0
    for i in range(4):
        if pos >= psize:
            return None
        b = data[pos]
        pos += 1
        if i == 3:
            return (value << 7) | b, pos
        if b & 0x80 == 0:
            return (value << 7) | b if i else b, pos
        value = (value << 7) | (b & 0x7F) if i else (b & 0x7F)
    return None


def write_varint7(value: int) -> bytes:
    out = []
    if value < 0x80:
        return bytes([value])
    tmp = []
    tmp.append(value & 0x7F)
    value >>= 7
    while value:
        tmp.append((value & 0x7F) | 0x80)
        value >>= 7
    out = bytes(reversed(tmp))
    return out


# ------------------------------------------------------------------ chunks
class VideoLayout(enum.IntEnum):
    """3D layouts (MoLiveStreamVideoWithLayout.cs:10-20)."""

    INTERLEAVE_3D_LEFT_FIRST = 0
    INTERLEAVE_3D_RIGHT_FIRST = 1
    TOP_TO_BOTTOM_3D_LEFT_FIRST = 2
    TOP_TO_BOTTOM_3D_RIGHT_FIRST = 3
    SIDE_BY_SIDE_3D_LEFT_FIRST = 4
    SIDE_BY_SIDE_3D_RIGHT_FIRST = 5
    SIMPLE_2D = 6


@dataclasses.dataclass
class VideoStream:
    """Chunk type 1 (MoLiveStreamVideo.cs:10-69)."""

    stream_index: int = -1
    codec_id: int = 0
    fps_rate: int = 24
    fps_scale: int = 1
    width: int = 256
    height: int = 192
    pel_ratio_rate: int = 1
    pel_ratio_scale: int = 1
    chunk_id: int = 1
    chunk_size: int = 12

    @classmethod
    def parse(cls, d: bytes, off: int) -> "VideoStream":
        return cls(stream_index=d[off], codec_id=d[off + 1],
                   fps_rate=struct.unpack_from(">H", d, off + 2)[0],
                   fps_scale=struct.unpack_from(">H", d, off + 4)[0],
                   width=struct.unpack_from(">H", d, off + 6)[0],
                   height=struct.unpack_from(">H", d, off + 8)[0],
                   pel_ratio_rate=d[off + 10], pel_ratio_scale=d[off + 11])

    def pack(self) -> bytes:
        return bytes([self.stream_index, self.codec_id]) \
            + struct.pack(">HHHH", self.fps_rate, self.fps_scale,
                          self.width, self.height) \
            + bytes([self.pel_ratio_rate, self.pel_ratio_scale])


@dataclasses.dataclass
class VideoStreamWithLayout(VideoStream):
    """Chunk type 3 (MoLiveStreamVideoWithLayout.cs)."""

    layout: VideoLayout = VideoLayout.SIMPLE_2D
    rotation: int = 0
    chunk_id: int = 3
    chunk_size: int = 13

    @classmethod
    def parse(cls, d: bytes, off: int) -> "VideoStreamWithLayout":
        base = VideoStream.parse(d, off)
        v = cls(**{f.name: getattr(base, f.name)
                   for f in dataclasses.fields(VideoStream)
                   if f.name not in ("chunk_id", "chunk_size")})
        v.layout = VideoLayout(d[off + 12] & 0xF)
        v.rotation = d[off + 12] >> 4
        # faithful reference bug: Read() overwrites PelRatioRate with byte 9
        # instead of filling PelRatioScale (MoLiveStreamVideoWithLayout.cs:38)
        v.pel_ratio_rate = d[off + 9]
        return v

    def pack(self) -> bytes:
        return VideoStream.pack(self) + bytes([
            (int(self.layout) & 0xF) | ((self.rotation & 0xF) << 4)])


@dataclasses.dataclass
class AudioStream:
    """Chunk type 2 (MoLiveStreamAudio.cs:10-40).
    codec_id: 0 = FastAudio, 1 = IMA ADPCM, 2 = PCM16 (Form1.cs:559-633)."""

    stream_index: int = -1
    codec_id: int = 1
    frequency: int = 32728
    channels: int = 1
    chunk_id: int = 2
    chunk_size: int = 6

    @classmethod
    def parse(cls, d: bytes, off: int) -> "AudioStream":
        freq = (d[off + 2] << 16 | d[off + 3] << 8 | d[off + 4]) + 1
        return cls(stream_index=d[off], codec_id=d[off + 1],
                   frequency=freq, channels=d[off + 5] + 1)

    def pack(self) -> bytes:
        f = self.frequency - 1
        return bytes([self.stream_index, self.codec_id,
                      (f >> 16) & 0xFF, (f >> 8) & 0xFF, f & 0xFF,
                      self.channels - 1])


@dataclasses.dataclass
class TimelineStream:
    """Chunk type 4 (MoLiveStreamTimeline.cs)."""

    stream_index: int = -1
    associated_stream_index: int = 0
    chunk_id: int = 4
    chunk_size: int = 2

    @classmethod
    def parse(cls, d: bytes, off: int) -> "TimelineStream":
        return cls(stream_index=d[off], associated_stream_index=d[off + 1])

    def pack(self) -> bytes:
        return bytes([self.stream_index, self.associated_stream_index])


# ----------------------------------------------------------------- demuxer
def _synchro_checksum(ts: int) -> int:
    v19 = (ts >> 32) & 0xFFFFFFFF
    if ((v19 - 1) & 0xFFFFFFFF) >> 31:  # (int)((ts>>32)-1) < 0
        v19 &= 0x7FFFFFFF
    return (((ts >> 16) & 0xFFFF) ^ (v19 >> 16) ^ 0xAAAA
            ^ (v19 & 0xFFFF) ^ (ts & 0xFFFF)) & 0xFFFF


def read_synchro_header(packet: bytes, off: int) -> tuple[int, int] | None:
    """ReadSynchroHeader (MoLiveDemux.cs:375-414): returns (ts, packetsize)
    on checksum match (packetsize is the stored u16 + 1)."""
    if len(packet) - off < 14 or packet[off] != 0x4C or packet[off + 1] != 0x32:
        return None
    crc = struct.unpack_from(">H", packet, off + 2)[0]
    ts = struct.unpack_from(">Q", packet, off + 4)[0]
    psize = struct.unpack_from(">H", packet, off + 12)[0] + 1
    if crc != _synchro_checksum(ts):
        return None
    return ts, psize


class MoflexDemuxer:
    """Push demuxer: feed the file, receive complete per-stream frames via
    ``on_frame(chunk, data)`` (mirrors the OnCompleteFrameReceived event)."""

    def __init__(self, data: bytes,
                 on_frame: Callable[[object, bytes], None] | None = None):
        self.data = data
        self.position = 0
        self.on_frame = on_frame
        self.packet_size = 0
        self.gts = 0
        self.delta_gts = 0
        self.synchro_counter = 64
        self.last_counter = 65536
        self.variable_packet_size = True
        self.has_reference_ts = False
        self.synchronized = False
        self.streams: dict[int, tuple[object, bytearray]] = {}

    def demux_all(self, max_stall: int = 3) -> None:
        """Drive read_packet to end-of-data.  The faithful read_packet can
        spin on a tail error exactly like the reference player loop
        (Form1.cs:492-495 never exits on error 73); a no-progress guard
        bounds that here."""
        stall = 0
        last = -1
        while True:
            r = self.read_packet()
            if r in (1, 0x80):
                return
            if self.position == last:
                stall += 1
                if stall >= max_stall:
                    return
            else:
                stall = 0
            last = self.position

    # -- recovery ----------------------------------------------------------
    def desynchronize(self) -> None:
        """Desynchronize (MoLiveDemux.cs:57-65): reset and rescan for the
        `4C 32` pattern on the next read_packet."""
        self.gts = 0
        self.delta_gts = 0
        self.synchro_counter = 64
        self.last_counter = 65536
        self.synchronized = False
        self.streams.clear()

    def read_packet(self) -> int:
        """ReadPacket (MoLiveDemux.cs:67-164): 0 = ok, 1 = EOF-ish,
        other = reference error code."""
        packet = self.data[self.position:
                           self.position + (self.packet_size or 0x1000)]
        length = len(packet)
        if not self.synchronized:
            if length < 0xE:
                return 1
            off = 0
            while read_synchro_header(packet, off) is None:
                off += 1
                if off == length - 0xE:
                    return 0x80  # synchronization pattern not found
            ts, psize = read_synchro_header(packet, off)
            # (long)ts - 1 < 0  <=>  ts == 0 or the sign bit is set
            self.has_reference_ts = ts == 0 or bool(ts >> 63)
            if psize < 0x10:
                return 73
            self.synchronized = True
            self.position += off
            return 0
        if self.packet_size and self.packet_size != length:
            return 73
        pos = 0
        hdr = read_synchro_header(packet, 0) if length > 0xE else None
        if hdr is not None:
            ts, psize = hdr
            self.has_reference_ts = ts == 0 or bool(ts >> 63)
            if self.has_reference_ts:
                ts &= (1 << 63) - 1
            if psize < 0x10:
                return 73
            if ts != 0:
                if self.gts != 0 and self.delta_gts == 0:
                    self.delta_gts = ts - self.gts
                self.gts = ts
                self.streams.clear()
            if self.packet_size != psize:
                retry = (self.packet_size or 0x1000) < psize
                self.packet_size = psize
                if retry:
                    return 0
            pos = 0xE
            size = min(self.packet_size, length)
            while True:
                r, pos = self._read_synchro_chunk(packet, pos, size)
                if r == 0x100:
                    break
                if r != 0:
                    return r
            if pos > length:
                return 0x43
        r, pos = self._read_data_block(packet, pos, length)
        if not self.synchronized:
            return 0
        if r != 0:
            return r
        while True:
            r, pos = self._read_ep(packet, pos, length)
            if r == 0x101:
                break
            if r != 0:
                return r
        if pos > length:
            return 0x43
        self.position += pos
        return 0

    def _read_synchro_chunk(self, packet: bytes, pos: int,
                            psize: int) -> tuple[int, int]:
        """ReadSynchroChunk (MoLiveDemux.cs:168-215)."""
        t = read_varint7(packet, pos, psize)
        if t is None:
            self.desynchronize()
            return 0x43, pos
        ctype, pos = t
        t = read_varint7(packet, pos, psize)
        if t is None:
            self.desynchronize()
            return 0x43, pos
        csize, pos = t
        if ctype == 0:
            return 0x100, pos + csize
        parsers = {1: (VideoStream, 12), 2: (AudioStream, 6),
                   3: (VideoStreamWithLayout, 13), 4: (TimelineStream, 2)}
        if ctype == 0x100000:
            # MoLiveChunkFoo: the reference recognizes it (expected size
            # 20) but its Read throws NotImplementedException
            # (MoLiveChunkFoo.cs:13-16) — stub parity.
            if csize != 20:
                return 0x45, pos
            raise NotImplementedError(
                "Moflex 'foo' chunk (0x100000): unimplemented in the "
                "reference (MoLiveChunkFoo.cs)")
        if ctype not in parsers:
            return 0x44, pos
        cls, expect = parsers[ctype]
        if csize != expect:
            return 0x45, pos
        chunk = cls.parse(packet, pos)
        self.streams[chunk.stream_index] = (chunk, bytearray())
        pos += csize
        if pos <= psize:
            return 0, pos
        self.desynchronize()
        return 0x43, pos

    def _read_data_block(self, packet: bytes, pos: int,
                         psize: int) -> tuple[int, int]:
        """ReadDataBlock (MoLiveDemux.cs:217-263)."""
        if pos >= psize:
            self.desynchronize()
            return 67, pos
        flags = packet[pos]
        pos += 1
        self.variable_packet_size = bool(flags & 1)
        packet_counting = bool((flags >> 1) & 1)
        sc = flags >> 2
        if self.synchro_counter == 64:
            self.synchro_counter = sc
        elif self.synchro_counter != sc:
            if self.delta_gts == 0:
                self.desynchronize()
                return 70, pos
            # counter jump: advance global ts and drop partial frames
            self.gts += ((sc - self.synchro_counter) & 0xFFFFFFFF) \
                * self.delta_gts
            self.synchro_counter = sc
            for _, buf in self.streams.values():
                buf.clear()
        if packet_counting:
            val = struct.unpack_from(">H", packet, pos)[0]
            pos += 2
            if pos > psize:
                self.desynchronize()
                return 67, pos
            expected = val if self.last_counter == 65536 \
                else self.last_counter + 1
            if expected != val:
                self.last_counter = 65536
                return 0x50, pos
            self.last_counter = val
        return 0, pos

    def _read_ep(self, packet: bytes, pos: int, psize: int) -> tuple[int, int]:
        """ReadEp (MoLiveDemux.cs:270-373)."""
        if pos == psize:
            return 0x101, pos
        if pos > psize:
            self.desynchronize()
            return 0x43, pos
        if packet[pos] == 0:
            pos += 1
            if not self.variable_packet_size:
                pos = self.packet_size
            return 0x101, pos
        bs = BeBitReader(packet, pos)
        nbits = 1
        while bs.pop(1) == 0:
            nbits += 1
        stream_idx = bs.pop(nbits)
        end_frame = bs.pop(1) == 1
        if end_frame:
            ft_bits = 1
            while bs.pop(1) == 0:
                ft_bits += 1
            _frame_type = bs.pop(ft_bits)
            pts_bits = 28
            _neg = bs.pop(1) == 1
            while bs.pop(1) == 0:
                pts_bits += 2
            _pts = bs.pop(pts_bits)
        ep_size = bs.pop(13) + 1
        pos = bs.pos
        if pos + ep_size > psize:
            self.desynchronize()
            return 0x43, pos
        if stream_idx in self.streams:
            self.streams[stream_idx][1].extend(
                packet[pos:pos + ep_size])
        pos += ep_size
        if end_frame and stream_idx in self.streams:
            chunk, buf = self.streams[stream_idx]
            buf.extend(b"\x00\x00")  # over-read pad (MoLiveDemux.cs:353)
            if self.on_frame is not None:
                self.on_frame(chunk, bytes(buf))
            buf.clear()
        return (0, pos) if pos < psize else (0x101, pos)


# ------------------------------------------------------------------ muxer
class MoflexMuxer:
    """Fixture/export muxer (MoflexMuxer.cs:11-97 semantics, with the
    packeting made self-consistent for the faithful reader): every packet
    carries a synchro header (first packet ts != 0 + stream-declaration
    chunks; later packets ts = 0 so stream state persists), a chunk
    terminator, a variable-packet-size data block, EPs, and a 0 terminator.
    Packets are variable-sized back to back; the reader advances exactly
    through the consumed content, so the next synchro header lands at the
    read position.  The final packet is zero-padded so the tail read sees a
    full packet-size window."""

    PACKET = 0x1000

    def __init__(self, chunks: list[object], ts: int = 1):
        self.chunks = chunks
        self.ts = ts
        self.out = bytearray()
        self._packet = bytearray()
        self._first = True

    def _synchro_header(self, ts: int) -> bytes:
        hdr = bytearray(14)
        hdr[0], hdr[1] = 0x4C, 0x32
        struct.pack_into(">Q", hdr, 4, ts)
        # stored value + 1 is the packet size the reader adopts
        struct.pack_into(">H", hdr, 12, self.PACKET - 1)
        struct.pack_into(">H", hdr, 2, _synchro_checksum(ts))
        return bytes(hdr)

    def _begin_packet(self) -> None:
        self._packet = bytearray()
        self._packet += self._synchro_header(self.ts if self._first else 0)
        if self._first:
            for c in self.chunks:
                self._packet += write_varint7(c.chunk_id)
                self._packet += write_varint7(c.chunk_size)
                self._packet += c.pack()
            self._first = False
        self._packet += write_varint7(0) + write_varint7(0)  # chunk end
        self._packet.append(1)  # data block flags: variable packet size

    def _flush_packet(self) -> None:
        if not self._packet:
            return
        self._packet.append(0)  # EP terminator
        self.out += self._packet
        self._packet = bytearray()

    @staticmethod
    def _ep_header(stream_idx: int, size: int, end_frame: bool) -> bytes:
        bw = BeBitWriter()
        nbits = max(stream_idx.bit_length(), 1)
        bw.put(1, nbits)            # unary length terminated by 1
        bw.put(stream_idx, nbits)
        bw.put(1 if end_frame else 0, 1)
        if end_frame:
            bw.put(1, 1)            # frame-type unary length 1
            bw.put(0, 1)            # frame type 0
            bw.put(0, 1)            # pts sign
            bw.put(1, 1)            # pts length terminator (28 bits)
            bw.put(0, 28)           # pts 0
        bw.put(size - 1, 13)
        return bw.to_bytes()

    def add_frame(self, stream_idx: int, data: bytes) -> None:
        """Split one stream frame into EPs across packets
        (MoflexSimpleVideoMuxer.cs:36-62 policy)."""
        off = 0
        while off < len(data):
            if not self._packet:
                self._begin_packet()
            # 1 terminator byte + up to 8 header bytes must fit
            avail = self.PACKET - len(self._packet) - 1 - 8
            if avail < 0x20:
                self._flush_packet()
                continue
            n = min(len(data) - off, avail, self.PACKET - 0x80)
            end = off + n >= len(data)
            self._packet += self._ep_header(stream_idx, n, end)
            self._packet += data[off:off + n]
            off += n

    def to_bytes(self) -> bytes:
        self._flush_packet()
        # pad the tail so the reader's final fixed-size window is satisfied
        return bytes(self.out) + bytes(self.PACKET)
