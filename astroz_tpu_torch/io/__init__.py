"""Telemetry ingestion: CCSDS / VITA49 packet parsing and stream drivers.

Counterpart of ``astroz_tpu/io/`` (the reference's ``src/Ccsds.zig``,
``src/Vita49.zig``, ``src/parsers.zig``). Host-side ingestion: packets
are parsed in Python, and large buffers are scanned for frame
boundaries by the native scanner (``native/frame_scanner.cpp``).
"""

from .ccsds import Ccsds, CcsdsConfig
from .parsers import NeedMoreData, Parser, parse_file, parse_stream
from .vita49 import Vita49

__all__ = ["Ccsds", "CcsdsConfig", "Vita49", "NeedMoreData", "Parser",
           "parse_file", "parse_stream"]
