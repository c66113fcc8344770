"""Generic frame parser over files and TCP streams.

Counterpart of ``astroz_tpu/io/parsers.py`` (the reference's
``src/parsers.zig``: ``Parser(Frame)`` with file parsing, an optional
sync-pattern resync, and live TCP ingestion with a callback). A "frame
type" here is any class with a ``parse(buffer) -> frame`` classmethod
that takes a bytes-like buffer and a ``total_length`` property:
:class:`~astroz_tpu_torch.io.ccsds.Ccsds` and
:class:`~astroz_tpu_torch.io.vita49.Vita49` both qualify.
"""

from __future__ import annotations

import socket
from typing import Callable, Iterator, List, Optional, Tuple, Type

#: buffers from this size on of the built-in frame types go through the
#: native scanner
NATIVE_MIN_BYTES = 2048


class NeedMoreData(ValueError):
    """A frame's length fields demand more bytes than the buffer holds
    — streaming parsers wait for more data; corrupt frames (anything
    else) are skipped byte-by-byte instead."""


class Parser:
    """Frame-type-generic parser (reference: Parser(Frame))."""

    def __init__(self, frame_type: Type,
                 sync_pattern: Optional[bytes] = None,
                 config=None):
        self.frame_type = frame_type
        self.sync_pattern = sync_pattern
        self.config = config

    def _parse_one(self, buf):
        if self.config is not None:
            return self.frame_type.parse(buf, self.config)
        return self.frame_type.parse(buf)

    def _native_kind(self) -> Optional[str]:
        from .ccsds import Ccsds
        from .vita49 import Vita49
        if self.frame_type is Ccsds and self.config is None:
            return "ccsds"
        if self.frame_type is Vita49:
            return "vita49"
        return None

    def iter_frames(self, data: bytes) -> Iterator:
        """Parse back-to-back frames out of a buffer. With a sync
        pattern, scan forward to each occurrence before parsing
        (reference resync behavior); without one, a malformed frame
        skips one byte and rescans.

        Buffers of NATIVE_MIN_BYTES or more of the built-in frame types
        go through the C++ scanner (``native.scan_frames``), which finds
        the same frames as the Python walk; field extraction stays in
        Python. The scanner raises ``RuntimeError`` when the native
        library does not build."""
        kind = self._native_kind()
        if kind is None or len(data) < NATIVE_MIN_BYTES:
            for _, frame in self._walk(data):
                yield frame
            return
        from .. import native
        offsets, lengths = native.scan_frames(kind, data, self.sync_pattern)
        for o, ln in zip(offsets.tolist(), lengths.tolist()):
            yield self._parse_one(data[o:o + ln])

    def _walk(self, data) -> Iterator[Tuple[int, object]]:
        """The Python walk, the native scanner's plain version: yields
        ``(offset, frame)``. It parses zero-copy views of the buffer, so
        it stays linear in the buffer's size."""
        view = memoryview(data)
        pos = 0
        n = len(view)
        while pos < n:
            if self.sync_pattern:
                idx = data.find(self.sync_pattern, pos)
                if idx < 0:
                    return
                pos = idx + len(self.sync_pattern)  # frame follows sync
            try:
                frame = self._parse_one(view[pos:])
            except Exception:  # any parse failure: resync one byte on
                pos += 1
                continue
            yield pos, frame
            pos += max(frame.total_length, 1)

    def parse_from_file(self, path: str) -> List:
        with open(path, "rb") as f:
            return list(self.iter_frames(f.read()))

    def start(self, host: str, port: int, *,
              callback: Optional[Callable] = None,
              max_frames: Optional[int] = None,
              timeout: float = 5.0) -> List:
        """Connect to a TCP server and parse frames off the stream,
        invoking ``callback(frame)`` per frame. Stops at EOF, after
        ``max_frames``, or on timeout."""
        frames: List = []
        buf = b""
        with socket.create_connection((host, port), timeout=timeout) as s:
            s.settimeout(timeout)
            while max_frames is None or len(frames) < max_frames:
                try:
                    chunk = s.recv(65536)
                except socket.timeout:
                    break
                if not chunk:
                    break
                buf += chunk
                progress = True
                while progress and (max_frames is None
                                    or len(frames) < max_frames):
                    progress = False
                    start = 0
                    if self.sync_pattern:
                        idx = buf.find(self.sync_pattern)
                        if idx < 0:
                            buf = buf[-(len(self.sync_pattern) - 1):] \
                                if len(self.sync_pattern) > 1 else b""
                            break
                        start = idx + len(self.sync_pattern)
                    try:
                        frame = self._parse_one(buf[start:])
                    except NeedMoreData:
                        # incomplete: wait for more bytes — unless the
                        # buffer already exceeds any real frame (a
                        # garbage header can CLAIM an arbitrary length
                        # and look incomplete forever)
                        if len(buf) - start > 1 << 20:
                            buf = buf[start + 1:]
                            progress = True
                            continue
                        break
                    except Exception:
                        # corrupt bytes at the head: skip one byte and
                        # keep scanning; waiting would stall the stream
                        buf = buf[start + 1:]
                        progress = True
                        continue
                    frames.append(frame)
                    if callback is not None:
                        callback(frame)
                    buf = buf[start + max(frame.total_length, 1):]
                    progress = True
        # EOF/timeout drain: a garbage header mid-buffer may have held
        # the loop in 'incomplete' state — recover every still-valid
        # frame from the remainder with the skip-scanning iterator
        for frame in self.iter_frames(buf):
            if max_frames is not None and len(frames) >= max_frames:
                break
            frames.append(frame)
            if callback is not None:
                callback(frame)
        return frames


def parse_file(frame_type: Type, path: str,
               sync_pattern: Optional[bytes] = None, config=None) -> List:
    return Parser(frame_type, sync_pattern, config).parse_from_file(path)


def parse_stream(frame_type: Type, host: str, port: int,
                 sync_pattern: Optional[bytes] = None, config=None,
                 **kwargs) -> List:
    """Stream-parse frames off a TCP connection (the same
    sync_pattern/config arguments as :func:`parse_file`; remaining
    kwargs go to :meth:`Parser.start`)."""
    return Parser(frame_type, sync_pattern, config).start(host, port,
                                                          **kwargs)
