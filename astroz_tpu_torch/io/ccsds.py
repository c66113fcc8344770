"""CCSDS Space Packet (CCSDS 133.0-B) parsing.

Counterpart of ``astroz_tpu/io/ccsds.py`` (the reference's
``src/Ccsds.zig``: bit-field primary header, JSON-configurable secondary
header). Field layout follows the published CCSDS 133.0-B-2 standard.
``parse`` takes any bytes-like buffer (bytes, bytearray, memoryview).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional, Union

from .parsers import NeedMoreData

PRIMARY_HEADER_LEN = 6


@dataclass
class CcsdsConfig:
    """Mission-specific knobs (reference: Config / HeaderMetadata JSON):
    length of the optional secondary header in bytes."""

    secondary_header_length: int = 0

    @classmethod
    def from_json(cls, text: str) -> "CcsdsConfig":
        obj = json.loads(text)
        # the reference's config JSON uses camelCase
        # (examples/create_ccsds_packet_config.json); accept both
        val = obj.get("secondary_header_length",
                      obj.get("secondaryHeaderLength", 0))
        return cls(secondary_header_length=int(val))


class CcsdsError(ValueError):
    pass


class CcsdsIncomplete(CcsdsError, NeedMoreData):
    """Frame extends past the buffer — streaming parsers wait."""


@dataclass
class Ccsds:
    """One parsed space packet."""

    version: int
    packet_type: int  # 0 = TM, 1 = TC
    secondary_header_flag: bool
    apid: int
    sequence_flags: int
    sequence_count: int
    data_length: int  # CCSDS convention: len(data field) - 1
    secondary_header: bytes
    payload: bytes
    raw: bytes

    @classmethod
    def parse(cls, data: Union[bytes, bytearray, memoryview],
              config: Optional[CcsdsConfig] = None) -> "Ccsds":
        if len(data) < PRIMARY_HEADER_LEN:
            raise CcsdsIncomplete(
                f"need >= {PRIMARY_HEADER_LEN} bytes, got {len(data)}")
        w0 = int.from_bytes(data[0:2], "big")
        w1 = int.from_bytes(data[2:4], "big")
        w2 = int.from_bytes(data[4:6], "big")
        version = (w0 >> 13) & 0x7
        ptype = (w0 >> 12) & 0x1
        shf = bool((w0 >> 11) & 0x1)
        apid = w0 & 0x7FF
        seq_flags = (w1 >> 14) & 0x3
        seq_count = w1 & 0x3FFF
        data_length = w2  # bytes in data field minus 1

        total = PRIMARY_HEADER_LEN + data_length + 1
        if len(data) < total:
            raise CcsdsIncomplete(
                f"packet claims {total} bytes, got {len(data)}")
        body = bytes(data[PRIMARY_HEADER_LEN:total])
        sh_len = (config.secondary_header_length
                  if (config and shf) else 0)
        if sh_len > len(body):
            raise CcsdsError("secondary header longer than data field")
        return cls(version=version, packet_type=ptype,
                   secondary_header_flag=shf, apid=apid,
                   sequence_flags=seq_flags, sequence_count=seq_count,
                   data_length=data_length,
                   secondary_header=body[:sh_len], payload=body[sh_len:],
                   raw=bytes(data[:total]))

    @property
    def total_length(self) -> int:
        return PRIMARY_HEADER_LEN + self.data_length + 1


def build_packet(apid: int, payload: bytes, *, version: int = 0,
                 packet_type: int = 0, sequence_count: int = 0,
                 sequence_flags: int = 3,
                 secondary_header: bytes = b"") -> bytes:
    """Inverse of parse — used by tests and simulators."""
    body = secondary_header + payload
    if not body:
        raise CcsdsError("CCSDS data field must be non-empty")
    w0 = ((version & 0x7) << 13) | ((packet_type & 1) << 12) \
        | ((1 if secondary_header else 0) << 11) | (apid & 0x7FF)
    w1 = ((sequence_flags & 0x3) << 14) | (sequence_count & 0x3FFF)
    w2 = len(body) - 1
    return (w0.to_bytes(2, "big") + w1.to_bytes(2, "big")
            + w2.to_bytes(2, "big") + body)
