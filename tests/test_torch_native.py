"""The port's native ingest layer (``astroz_tpu_torch/native``): the bulk
TLE parser on ``build_catalog``'s path and the telemetry frame scanner,
on the CPU, against the port's Python parser and walk and against the
JAX package on the same inputs.

Tolerances:

* the port's native parser against its Python parser (``tle.py``) and
  against JAX's Python parser: every column and satellite number equal,
  bit for bit, and the same records kept and skipped;
* against JAX's native parser (``astroz_tpu/native/tle_parser.cpp``):
  equal on every column but ``ecco``, ``bstar`` and ``nddot``, which
  JAX's parser builds as a sum of digit * 0.1^k (one rounding a digit,
  at most 8 digits), so within 8 ulps there (measured up to 4); its own
  test gates it against its Python parser at 1e-15 absolute;
* ``build_catalog(device="cpu")`` through the native parser: every host
  element equal, bit for bit, to the catalog built from Python-parsed
  columns and to JAX's host elements from the same columns;
* the frame scanner: the same offsets and lengths as the port's Python
  walk and as JAX's scanner, and the same frames as JAX's
  ``Parser.iter_frames``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from astroz_tpu import native as jnative
from astroz_tpu import propagation as J
from astroz_tpu import tle as jtle
from astroz_tpu.io import Ccsds as JCcsds, Parser as JParser
from astroz_tpu.io import Vita49 as JVita49

import astroz_tpu_torch as P
from astroz_tpu_torch import native as pnative
from astroz_tpu_torch import tle as ptle
from astroz_tpu_torch.io import Ccsds, Parser, Vita49
from astroz_tpu_torch.io.ccsds import build_packet as ccsds_packet
from astroz_tpu_torch.io.vita49 import build_packet as vita49_packet

from test_propagation import MIXED_TEXT
from test_screening import synthetic_leo_text

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: MIXED_TEXT (3LE: ISS, GPS, GEO, HEO, ISS2) without its name lines
TWO_LINE = "\n".join(ln for ln in MIXED_TEXT.splitlines()
                     if ln.startswith(("1 ", "2 ")))

COLS = ("epoch_jd", "jdsatepoch", "jdsatepochF", "no_kozai", "ecco",
        "inclo", "nodeo", "argpo", "mo", "bstar", "ndot", "nddot")
DIGIT_SUMS = ("ecco", "bstar", "nddot")  # JAX's native parser's sums

ALPHA5_L1 = ("1 E5544U 98067A   24001.50000000  .00016717  00000-0"
             "  10270-3 0  9993")
ALPHA5_L2 = ("2 E5544  51.6400 200.0000 0001234  90.0000 270.0000 "
             "15.50000000000017")
MISMATCH_L2 = ("2 99999  51.6400 200.0000 0001234  90.0000 270.0000 "
               "15.50000000000017")


def _field_fuzz(n_tles=300, n_hits=1500, seed=3):
    """Synthetic text with characters overwritten inside the fields: the
    alphabet is what float() and int() may read or refuse (no 'e', no
    '_', no 'inf'/'nan', which only Python's float takes), so both
    parsers must keep and skip the same records."""
    rng = np.random.default_rng(seed)
    lines = synthetic_leo_text(n_tles, seed=seed).splitlines()
    alphabet = np.array(list("0123456789 .+-X"))
    for _ in range(n_hits):
        k = int(rng.integers(len(lines)))
        col = int(rng.integers(2, len(lines[k])))
        lines[k] = lines[k][:col] + str(rng.choice(alphabet)) \
            + lines[k][col + 1:]
    return "\n".join(lines)


# name -> (text, expected number of records or None)
CASES = {
    "mixed": (MIXED_TEXT, 5),
    "synthetic": (synthetic_leo_text(200), 200),
    "garbage_lines": ("garbage line\n" + MIXED_TEXT + "\n1 truncated\n"
                      "2 25544 orphan-without-line1\n", 5),
    "crlf_blank_lines": (MIXED_TEXT.replace("\n", "\r\n\r\n"), 5),
    "alpha5": (ALPHA5_L1 + "\n" + ALPHA5_L2, 1),
    "satnum_mismatch": (ALPHA5_L1.replace("E5544", "25544") + "\n"
                        + MISMATCH_L2, 0),
    "field_fuzz": (_field_fuzz(), None),
}


def _columns(arrays):
    return [np.asarray(getattr(arrays, c)) for c in COLS]


@pytest.mark.parametrize("case", CASES)
def test_native_parser_equals_python(case):
    """Native columns equal the port's Python parser and JAX's Python
    parser bit for bit; the record count is the case's."""
    text, expect = CASES[case]
    nat = ptle.TleArrays.from_text(text)
    py = ptle.TleArrays.from_text(text, allow_native=False)
    jpy = jtle.TleArrays.from_text(text, allow_native=False)
    assert len(nat) == len(py) == len(jpy)
    if expect is not None:
        assert len(nat) == expect
    np.testing.assert_array_equal(nat.satnum, py.satnum)
    np.testing.assert_array_equal(nat.satnum, jpy.satnum)
    for c, a, b, j in zip(COLS, _columns(nat), _columns(py), _columns(jpy)):
        assert a.dtype == np.float64
        np.testing.assert_array_equal(a, b, err_msg=c)
        np.testing.assert_array_equal(a, j, err_msg=c)
    if case == "alpha5":
        assert nat.satnum[0] == 145544  # E -> 14
    if case == "field_fuzz":
        assert 0 < len(nat) < 300  # the fuzz skipped records, kept others


@pytest.mark.parametrize("case", [c for c in CASES if c != "field_fuzz"])
def test_native_parser_vs_jax_native(case):
    """Against JAX's native parser: the same records and satellite
    numbers, equal columns but for its digit sums (8 ulps there). (On
    corrupt fields JAX's parser keeps records that its Python parser
    and the port skip, so the field fuzz is held to the Python parsers
    only.)"""
    text, _ = CASES[case]
    cols, satnums = pnative.parse_catalog(text)
    jcols, jsatnums = jnative.parse_catalog(text)
    assert cols.shape == (pnative.N_COLS, len(satnums))
    np.testing.assert_array_equal(satnums, jsatnums)
    for c, a, b in zip(COLS, cols, jcols):
        if c in DIGIT_SUMS:
            np.testing.assert_array_less(
                np.abs(a - b), 8 * np.spacing(np.abs(a)) + 1e-300,
                err_msg=c)
        else:
            np.testing.assert_array_equal(a, b, err_msg=c)


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


def _assert_same_elements(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is not None or y is not None:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=f)


def test_build_catalog_native_equals_python_and_jax(chip_smoke,
                                                    monkeypatch):
    """A mixed catalog from two-line text goes through the native parser
    and initializes, bit for bit, as from Python-parsed columns and as
    JAX's host elements from those columns."""
    text = chip_smoke.mixed_catalog_text(400)
    calls = []
    parse = pnative.parse_catalog
    monkeypatch.setattr(pnative, "parse_catalog",
                        lambda t: calls.append(len(t)) or parse(t))
    cat = P.build_catalog(text, device="cpu")
    monkeypatch.undo()
    assert calls == [len(text)] and cat.names is None
    ref = P.build_catalog(ptle.TleArrays.from_text(text, allow_native=False),
                          device="cpu")
    jcat = J.build_catalog(jtle.TleArrays.from_text(text,
                                                    allow_native=False))
    assert cat.n_deep == ref.n_deep > 0
    _assert_same_elements(cat.host, ref.host)
    _assert_same_elements(cat.deep_host, ref.deep_host)
    np.testing.assert_array_equal(cat.satnum, ref.satnum)
    np.testing.assert_array_equal(cat.satnum, np.asarray(jcat.satnum))
    for f in cat.host._fields:
        np.testing.assert_array_equal(getattr(cat.host, f),
                                      np.asarray(getattr(jcat.els, f)),
                                      err_msg=f)


def test_named_catalog_keeps_names_and_elements(monkeypatch):
    """3LE text keeps the Python path and its names; its unnamed twin
    takes the native parser; both give the same elements. Constellation
    inherits the route."""
    calls = []
    parse = pnative.parse_catalog
    monkeypatch.setattr(pnative, "parse_catalog",
                        lambda t: calls.append(1) or parse(t))
    cat_named = P.build_catalog(MIXED_TEXT, device="cpu")
    assert calls == []
    assert cat_named.names == ("ISS", "GPS", "GEO", "HEO", "ISS2")
    cat = P.build_catalog(TWO_LINE, device="cpu")
    assert calls == [1] and cat.names is None
    _assert_same_elements(cat.host, cat_named.host)
    _assert_same_elements(cat.deep_host, cat_named.deep_host)
    con = P.Constellation(TWO_LINE, device="cpu")
    assert calls == [1, 1] and con.num_satellites == 5


@pytest.mark.parametrize("text", ["", "\n  \r\n", "1 short\n2 short"])
def test_build_catalog_empty_raises(text):
    with pytest.raises(ValueError, match="no TLEs"):
        P.build_catalog(text, device="cpu")


@pytest.fixture
def broken_build(monkeypatch, tmp_path):
    """The native library as it is where g++ fails: nothing built, and
    the compile raising as g++ does."""
    def fail(out, cmd_tail):
        raise subprocess.CalledProcessError(1, ["g++"],
                                            stderr="g++: broken")

    monkeypatch.setattr(pnative, "_LIB", None)
    monkeypatch.setattr(pnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(pnative, "_compile", fail)


@pytest.mark.parametrize("call", ["build_catalog", "from_text",
                                  "scan_frames", "iter_frames"])
def test_failed_build_raises(broken_build, call):
    """Without the library the native routes raise with g++'s output;
    nothing falls back to the Python parser or walk."""
    blob = b"\x00" * 4096
    calls = {
        "build_catalog": lambda: P.build_catalog(TWO_LINE, device="cpu"),
        "from_text": lambda: ptle.TleArrays.from_text(TWO_LINE),
        "scan_frames": lambda: pnative.scan_frames("ccsds", blob),
        "iter_frames": lambda: list(Parser(Ccsds).iter_frames(blob)),
    }
    with pytest.raises(RuntimeError, match="g\\+\\+: broken"):
        calls[call]()


def test_scan_frames_rejects_unknown_kind():
    with pytest.raises(ValueError, match="kind"):
        pnative.scan_frames("ax25", b"\x00" * 16)


def _fuzz_blob(rng, packets, sync):
    parts = []
    for p in packets:
        parts.append(rng.bytes(int(rng.integers(0, 9))))
        if sync:
            parts.append(sync)
        parts.append(p)
    parts.append(rng.bytes(11))
    return b"".join(parts)


@pytest.mark.parametrize("kind", ["ccsds", "vita49"])
@pytest.mark.parametrize("sync", [None, b"\x1a\xcf\xfc\x1d"])
def test_frame_scanner_parity_fuzz(kind, sync):
    """``tests/test_native.py``'s parity fuzz, port against JAX: on
    garbage-embedded random streams the native scan equals the port's
    Python walk and JAX's scanner (offsets and lengths), and
    ``iter_frames`` gives JAX's frames on the native and the Python
    route."""
    rng = np.random.default_rng(5)
    if kind == "ccsds":
        pkts = [ccsds_packet(apid=int(rng.integers(0, 2048)),
                             payload=rng.bytes(int(rng.integers(1, 40))),
                             sequence_count=i) for i in range(50)]
        ptype, jtype = Ccsds, JCcsds

        def key(f):
            return (f.apid, f.sequence_count, f.payload, f.raw)
    else:
        pkts = [vita49_packet(payload=rng.bytes(4 * int(rng.integers(1, 10))),
                              stream_id=int(rng.integers(0, 100)))
                for _ in range(50)]
        ptype, jtype = Vita49, JVita49

        def key(f):
            return (f.stream_id, f.payload, f.raw)
    blob = _fuzz_blob(rng, pkts, sync)
    big = blob + b"\0" * 2048  # past the native size gate
    parser = Parser(ptype, sync_pattern=sync)
    jparser = JParser(jtype, sync_pattern=sync)
    for data in (blob, big):
        walk = [(o, f.total_length) for o, f in parser._walk(data)]
        offsets, lengths = pnative.scan_frames(kind, data, sync)
        assert walk == list(zip(offsets.tolist(), lengths.tolist()))
        jo, jl = jnative.scan_frames(kind, data, sync)
        np.testing.assert_array_equal(offsets, jo)
        np.testing.assert_array_equal(lengths, jl)
        frames = [key(f) for f in parser.iter_frames(data)]
        assert frames == [key(f) for f in jparser.iter_frames(data)]
        if sync:
            assert len(frames) >= 50  # every sync-framed packet found
