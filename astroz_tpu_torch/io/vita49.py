"""VITA 49 (VRT) packet parsing.

Counterpart of ``astroz_tpu/io/vita49.py`` (the reference's
``src/Vita49.zig``: 4-byte header with the packet-type enum, TSI/TSF
timestamp modes, class ID, trailer, the payload range with its
malformed-range error). Layout per the published ANSI/VITA 49.0
standard; all words big-endian 32-bit. ``parse`` takes any bytes-like
buffer (bytes, bytearray, memoryview).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum
from typing import Optional, Union

from .parsers import NeedMoreData


class Vita49Error(ValueError):
    pass


class Vita49Incomplete(Vita49Error, NeedMoreData):
    """Frame extends past the buffer — streaming parsers wait."""


class PacketType(IntEnum):
    SIGNAL_DATA = 0x0
    SIGNAL_DATA_STREAM_ID = 0x1
    EXT_DATA = 0x2
    EXT_DATA_STREAM_ID = 0x3
    CONTEXT = 0x4
    EXT_CONTEXT = 0x5
    COMMAND = 0x6
    EXT_COMMAND = 0x7


class Tsi(IntEnum):
    NONE = 0
    UTC = 1
    GPS = 2
    OTHER = 3


class Tsf(IntEnum):
    NONE = 0
    SAMPLE_COUNT = 1
    REAL_TIME_PS = 2
    FREE_RUNNING = 3


@dataclass
class ClassId:
    oui: int
    info_class: int
    packet_class: int


@dataclass
class Trailer:
    raw: int


@dataclass
class Vita49:
    """One parsed VRT packet."""

    packet_type: PacketType
    has_class_id: bool
    has_trailer: bool
    tsi: Tsi
    tsf: Tsf
    packet_count: int
    packet_size_words: int
    stream_id: Optional[int]
    class_id: Optional[ClassId]
    integer_timestamp: Optional[int]
    fractional_timestamp: Optional[int]
    payload: bytes
    trailer: Optional[Trailer]
    raw: bytes

    @classmethod
    def parse(cls, data: Union[bytes, bytearray, memoryview]) -> "Vita49":
        if len(data) < 4:
            raise Vita49Incomplete("need at least one 32-bit header word")
        hdr = int.from_bytes(data[0:4], "big")
        ptype = PacketType((hdr >> 28) & 0xF)
        has_class = bool((hdr >> 27) & 1)
        has_trailer = bool((hdr >> 26) & 1)
        tsi = Tsi((hdr >> 22) & 0x3)
        tsf = Tsf((hdr >> 20) & 0x3)
        count = (hdr >> 16) & 0xF
        size_words = hdr & 0xFFFF
        if size_words == 0:
            raise Vita49Error("packet claims 0 words")  # corrupt
        if size_words * 4 > len(data):
            raise Vita49Incomplete(
                f"packet claims {size_words} words, have {len(data)//4}")

        off = 4
        stream_id = None
        if ptype in (PacketType.SIGNAL_DATA_STREAM_ID,
                     PacketType.EXT_DATA_STREAM_ID, PacketType.CONTEXT,
                     PacketType.EXT_CONTEXT, PacketType.COMMAND,
                     PacketType.EXT_COMMAND):
            stream_id = int.from_bytes(data[off:off + 4], "big")
            off += 4
        class_id = None
        if has_class:
            w1 = int.from_bytes(data[off:off + 4], "big")
            w2 = int.from_bytes(data[off + 4:off + 8], "big")
            class_id = ClassId(oui=w1 & 0xFFFFFF,
                               info_class=(w2 >> 16) & 0xFFFF,
                               packet_class=w2 & 0xFFFF)
            off += 8
        int_ts = None
        if tsi != Tsi.NONE:
            int_ts = int.from_bytes(data[off:off + 4], "big")
            off += 4
        frac_ts = None
        if tsf != Tsf.NONE:
            frac_ts = int.from_bytes(data[off:off + 8], "big")
            off += 8

        end = size_words * 4
        trailer_words = 4 if has_trailer else 0
        payload_end = end - trailer_words
        if payload_end < off:
            raise Vita49Error("malformed payload range")
        payload = bytes(data[off:payload_end])
        trailer = None
        if has_trailer:
            trailer = Trailer(
                raw=int.from_bytes(data[payload_end:end], "big"))
        return cls(packet_type=ptype, has_class_id=has_class,
                   has_trailer=has_trailer, tsi=tsi, tsf=tsf,
                   packet_count=count, packet_size_words=size_words,
                   stream_id=stream_id, class_id=class_id,
                   integer_timestamp=int_ts, fractional_timestamp=frac_ts,
                   payload=payload, trailer=trailer,
                   raw=bytes(data[:end]))

    @property
    def total_length(self) -> int:
        return self.packet_size_words * 4


def build_packet(payload: bytes, *, packet_type=PacketType.SIGNAL_DATA_STREAM_ID,
                 stream_id: Optional[int] = 1, tsi: Tsi = Tsi.UTC,
                 tsf: Tsf = Tsf.NONE, integer_timestamp: int = 0,
                 fractional_timestamp: int = 0,
                 packet_count: int = 0, trailer: Optional[int] = None
                 ) -> bytes:
    """Inverse of parse for tests/simulators. Payload padded to words."""
    pad = (-len(payload)) % 4
    payload = payload + b"\x00" * pad
    body = b""
    if stream_id is not None and packet_type not in (
            PacketType.SIGNAL_DATA, PacketType.EXT_DATA):
        body += int(stream_id).to_bytes(4, "big")
    if tsi != Tsi.NONE:
        body += int(integer_timestamp).to_bytes(4, "big")
    if tsf != Tsf.NONE:
        body += int(fractional_timestamp).to_bytes(8, "big")
    body += payload
    if trailer is not None:
        body += int(trailer).to_bytes(4, "big")
    size_words = 1 + len(body) // 4
    hdr = ((int(packet_type) & 0xF) << 28) | (0 << 27) \
        | ((1 if trailer is not None else 0) << 26) \
        | ((int(tsi) & 0x3) << 22) | ((int(tsf) & 0x3) << 20) \
        | ((packet_count & 0xF) << 16) | (size_words & 0xFFFF)
    return hdr.to_bytes(4, "big") + body
