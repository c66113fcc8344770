"""FITS file reading — pure Python + numpy, no cfitsio/astropy.

Counterpart of ``astroz_tpu/fits.py`` (the reference's ``src/Fits.zig``:
HDU enumeration, image HDU extraction, ASCII/binary tables,
image-as-table). It reads the published FITS 4.0 standard directly:
2880-byte blocks, 80-char ASCII header cards, big-endian data,
BSCALE/BZERO scaling, binary-table TFORM column decoding. Host-side.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

BLOCK = 2880
CARD = 80


class FitsError(ValueError):
    pass


def _parse_card(card: bytes) -> Optional[Tuple[str, Union[str, int, float,
                                                          bool, None], str]]:
    """One 80-byte header card -> (key, value, comment)."""
    text = card.decode("ascii", errors="replace")
    key = text[:8].strip()
    if not key or key in ("COMMENT", "HISTORY"):
        return (key, text[8:].strip(), "") if key else None
    if text[8:10] != "= ":
        return (key, None, text[8:].strip())
    rest = text[10:]
    comment = ""
    if rest.lstrip().startswith("'"):
        # string value: find closing quote ('' escapes)
        s = rest.lstrip()
        out = []
        i = 1
        while i < len(s):
            if s[i] == "'":
                if i + 1 < len(s) and s[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            out.append(s[i])
            i += 1
        tail = s[i + 1:]
        if "/" in tail:
            comment = tail.split("/", 1)[1].strip()
        return key, "".join(out).rstrip(), comment
    if "/" in rest:
        value_str, comment = rest.split("/", 1)
        comment = comment.strip()
    else:
        value_str = rest
    value_str = value_str.strip()
    if value_str == "T":
        return key, True, comment
    if value_str == "F":
        return key, False, comment
    if not value_str:
        return key, None, comment
    try:
        return key, int(value_str), comment
    except ValueError:
        pass
    try:
        return key, float(value_str.replace("D", "E").replace("d", "e")), \
            comment
    except ValueError:
        return key, value_str, comment


_BITPIX_DTYPE = {8: ">u1", 16: ">i2", 32: ">i4", 64: ">i8",
                 -32: ">f4", -64: ">f8"}

_TFORM_DTYPE = {"L": ("?", 1), "B": (">u1", 1), "I": (">i2", 2),
                "J": (">i4", 4), "K": (">i8", 8), "E": (">f4", 4),
                "D": (">f8", 8), "A": ("S", 1)}


@dataclass
class Hdu:
    """One header-data unit."""

    index: int
    header: Dict[str, Union[str, int, float, bool, None]]
    comments: Dict[str, str] = field(default_factory=dict)
    data_bytes: bytes = b""

    @property
    def kind(self) -> str:
        xt = self.header.get("XTENSION", "")
        if self.index == 0:
            return "image" if self.header.get("NAXIS", 0) else "primary"
        xt = str(xt).strip().upper()
        return {"IMAGE": "image", "TABLE": "ascii_table",
                "BINTABLE": "binary_table"}.get(xt, xt.lower() or "unknown")

    @property
    def shape(self) -> Tuple[int, ...]:
        n = int(self.header.get("NAXIS", 0) or 0)
        return tuple(int(self.header[f"NAXIS{i}"])
                     for i in range(n, 0, -1))

    def image(self) -> np.ndarray:
        """Decode an image HDU to a numpy array (BSCALE/BZERO applied)."""
        bitpix = int(self.header["BITPIX"])
        if bitpix not in _BITPIX_DTYPE:
            raise FitsError(f"unsupported BITPIX {bitpix}")
        shape = self.shape
        count = int(np.prod(shape)) if shape else 0
        arr = np.frombuffer(self.data_bytes, dtype=_BITPIX_DTYPE[bitpix],
                            count=count).reshape(shape)
        bscale = float(self.header.get("BSCALE", 1.0) or 1.0)
        bzero = float(self.header.get("BZERO", 0.0) or 0.0)
        if bscale != 1.0 or bzero != 0.0:
            arr = arr * bscale + bzero
        return arr

    def table(self) -> Dict[str, np.ndarray]:
        """Decode a binary or ASCII table HDU into named columns."""
        if self.kind == "binary_table":
            return self._binary_table()
        if self.kind == "ascii_table":
            return self._ascii_table()
        raise FitsError(f"HDU {self.index} is not a table ({self.kind})")

    def image_as_table(self) -> Dict[str, np.ndarray]:
        """Represent a 2-D image HDU as (x, y, value) columns — the
        reference's readImageAsTable CSV layout (Fits.zig:268-344)."""
        if self.kind != "image":
            raise FitsError(f"HDU {self.index} is not an image"
                            f" ({self.kind})")
        arr = self.image()
        if arr.ndim != 2:
            raise FitsError("image_as_table needs a 2-D image")
        h, w = arr.shape
        y, x = np.mgrid[0:h, 0:w]
        return {"x": x.ravel(), "y": y.ravel(),
                "value": arr.ravel()}

    def _binary_table(self) -> Dict[str, np.ndarray]:
        n_rows = int(self.header["NAXIS2"])
        row_len = int(self.header["NAXIS1"])
        n_fields = int(self.header["TFIELDS"])
        cols: List[Tuple[str, int, str, int]] = []  # name, repeat, code, sz
        offset = 0
        for i in range(1, n_fields + 1):
            tform = str(self.header[f"TFORM{i}"]).strip()
            name = str(self.header.get(f"TTYPE{i}", f"col{i}")).strip()
            rep = ""
            k = 0
            while k < len(tform) and tform[k].isdigit():
                rep += tform[k]
                k += 1
            repeat = int(rep) if rep else 1
            code = tform[k:k + 1].upper()
            if code not in _TFORM_DTYPE:
                raise FitsError(f"unsupported TFORM {tform!r}")
            cols.append((name, repeat, code, offset))
            offset += repeat * _TFORM_DTYPE[code][1]
        if offset > row_len:
            raise FitsError("TFORMs exceed NAXIS1 row length")
        raw = np.frombuffer(self.data_bytes, dtype=np.uint8,
                            count=n_rows * row_len).reshape(n_rows, row_len)
        out = {}
        for name, repeat, code, off in cols:
            dt, size = _TFORM_DTYPE[code]
            nbytes = repeat * size
            chunk = raw[:, off:off + nbytes].tobytes()
            if code == "A":
                a = np.frombuffer(chunk, dtype=f"S{repeat}")
                out[name] = np.char.strip(a.astype(str))
            else:
                a = np.frombuffer(chunk, dtype=dt)
                out[name] = (a.reshape(n_rows, repeat) if repeat > 1
                             else a.copy())
        return out

    def _ascii_table(self) -> Dict[str, np.ndarray]:
        n_rows = int(self.header["NAXIS2"])
        row_len = int(self.header["NAXIS1"])
        n_fields = int(self.header["TFIELDS"])
        text = self.data_bytes[:n_rows * row_len].decode(
            "ascii", errors="replace")
        out: Dict[str, List] = {}
        specs = []
        for i in range(1, n_fields + 1):
            name = str(self.header.get(f"TTYPE{i}", f"col{i}")).strip()
            tbcol = int(self.header[f"TBCOL{i}"]) - 1
            tform = str(self.header[f"TFORM{i}"]).strip().upper()
            width = int("".join(c for c in tform[1:].split(".")[0]
                                if c.isdigit()) or 1)
            kind = tform[0]
            specs.append((name, tbcol, width, kind))
            out[name] = []
        for r in range(n_rows):
            row = text[r * row_len:(r + 1) * row_len]
            for name, tbcol, width, kind in specs:
                fieldtxt = row[tbcol:tbcol + width].strip()
                if kind == "I":
                    out[name].append(int(fieldtxt or 0))
                elif kind in ("F", "E", "D"):
                    out[name].append(float(fieldtxt.replace("D", "E")
                                           or 0.0))
                else:
                    out[name].append(fieldtxt)
        return {k: np.asarray(v) for k, v in out.items()}


@dataclass
class Fits:
    hdus: List[Hdu]

    @classmethod
    def open(cls, path: str) -> "Fits":
        with open(path, "rb") as f:
            data = f.read()
        if not data.startswith(b"SIMPLE"):
            raise FitsError("not a FITS file (missing SIMPLE)")
        hdus = []
        pos = 0
        idx = 0
        while pos < len(data):
            header: Dict = {}
            comments: Dict = {}
            end_found = False
            hstart = pos
            while pos < len(data) and not end_found:
                block = data[pos:pos + BLOCK]
                if len(block) < BLOCK:
                    raise FitsError("truncated header block")
                for c in range(0, BLOCK, CARD):
                    card = block[c:c + CARD]
                    if card[:8].rstrip() == b"END":
                        end_found = True
                        break
                    parsed = _parse_card(card)
                    if parsed and parsed[0]:
                        key, val, com = parsed
                        if key not in header:
                            header[key] = val
                            if com:
                                comments[key] = com
                pos += BLOCK
            # data size
            bitpix = abs(int(header.get("BITPIX", 8) or 8))
            naxis = int(header.get("NAXIS", 0) or 0)
            n_el = 1
            for i in range(1, naxis + 1):
                n_el *= int(header.get(f"NAXIS{i}", 0) or 0)
            if naxis == 0:
                n_el = 0
            pcount = int(header.get("PCOUNT", 0) or 0)
            gcount = int(header.get("GCOUNT", 1) or 1)
            nbytes = (bitpix // 8) * gcount * (n_el + pcount)
            dstart = pos
            pos += ((nbytes + BLOCK - 1) // BLOCK) * BLOCK
            hdus.append(Hdu(index=idx, header=header, comments=comments,
                            data_bytes=data[dstart:dstart + nbytes]))
            idx += 1
            if pos >= len(data):
                break
        return cls(hdus=hdus)

    def __len__(self) -> int:
        return len(self.hdus)

    def __getitem__(self, i: int) -> Hdu:
        return self.hdus[i]


def open_and_parse(path: str) -> Fits:
    """Reference-parity entry point (Fits.zig open_and_parse)."""
    return Fits.open(path)


def image_to_pgm(arr: np.ndarray, path: str, *,
                 stretch: str = "linear") -> None:
    """Export a 2-D image to 8-bit PGM with linear/log/sqrt stretch —
    the dependency-free counterpart of the reference's PNG export via
    zignal (Fits.zig:219)."""
    a = np.asarray(arr, np.float64)
    if a.ndim != 2:
        raise FitsError("PGM export needs a 2-D image")
    if stretch == "log":
        a = np.log1p(a - a.min())
    elif stretch == "sqrt":
        a = np.sqrt(a - a.min())
    elif stretch != "linear":
        raise FitsError(f"unknown stretch {stretch!r}")
    lo, hi = float(a.min()), float(a.max())
    scale = 255.0 / (hi - lo) if hi > lo else 0.0
    img = ((a - lo) * scale).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(f"P5\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
        f.write(img.tobytes())


def _asinh_stretch(arr: np.ndarray, stretch: float, bend: float
                   ) -> np.ndarray:
    """Percentile-clipped asinh stretch to [0, 1] — the reference's
    display transfer curve (Fits.zig:346-394: clip at the 0.05% / 99.75%
    percentiles, then asinh((x-bend)/s) / asinh((1-bend)/s) * 0.5+0.5)."""
    a = np.asarray(arr, np.float64)
    flat = np.sort(a.ravel())
    vmin = flat[len(flat) // 2000]
    vmax = flat[len(flat) * 1995 // 2000]
    span = vmax - vmin if vmax > vmin else 1.0
    x = np.clip((a - vmin) / span, 0.0, 1.0)
    out = (np.arcsinh((x - bend) / stretch)
           / np.arcsinh((1.0 - bend) / stretch) * 0.5 + 0.5)
    return np.clip(out, 0.0, 1.0)


def image_to_png(arr: np.ndarray, path: str, *, stretch: float = 0.15,
                 bend: float = 0.5) -> None:
    """Export a 2-D image to an 8-bit grayscale PNG with the
    percentile-clip + asinh stretch of the reference's readImage
    (Fits.zig:219-266,346-394). Dependency-free: the PNG container is
    written directly (zlib is in the standard library)."""
    import struct
    import zlib

    a = np.asarray(arr)
    if a.ndim != 2:
        raise FitsError("PNG export needs a 2-D image")
    img = (_asinh_stretch(a, stretch, bend) * 255.0).astype(np.uint8)
    h, w = img.shape

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    # filter byte 0 (None) before each scanline
    raw = b"".join(b"\x00" + img[row].tobytes() for row in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)  # 8-bit gray
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 9)))
        f.write(chunk(b"IEND", b""))
