"""Telemetry ingestion (``astroz_tpu_torch.io``) and the host-side domain
modules of the port (``equatorial``, ``spice``, ``fits``, ``mission``,
``constants``, ``config``, ``profiling``), on the CPU: the cases of
``tests/test_io.py``, ``tests/test_fits.py`` and the mission plan of
``tests/test_mission_mc.py``, each run against the port and held to the
JAX package on the same inputs.

Every comparison is exact (the same Python and numpy code on both
sides): encoded packets byte for byte, parsed frames field for field,
FITS headers, comments and data equal, PGM/PNG files byte for byte,
RA/Dec and precession results equal, the mission plan's numbers and
trajectory equal. The TCP tests serve on loopback only.
"""

import dataclasses
import socket
import threading
import time

import numpy as np
import pytest
import torch

import astroz_tpu.constants as jconst
import astroz_tpu.equatorial as jeq
import astroz_tpu.fits as jfits
import astroz_tpu.mission as jmission
import astroz_tpu.spice as jspice
from astroz_tpu.io import ccsds as jccsds, vita49 as jvita49
from astroz_tpu.io import Parser as JParser

import astroz_tpu_torch.constants as pconst
from astroz_tpu_torch import config, equatorial as peq, fits as pfits
from astroz_tpu_torch import mission as pmission, profiling
from astroz_tpu_torch import spice as pspice
from astroz_tpu_torch.io import (Ccsds, CcsdsConfig, NeedMoreData, Parser,
                                 Vita49, parse_file, parse_stream)
from astroz_tpu_torch.io.ccsds import CcsdsError, build_packet as ccsds_build
from astroz_tpu_torch.io.vita49 import (PacketType, Tsf, Tsi, Vita49Error,
                                        build_packet as vita_build)

from test_fits import make_bintable_fits, make_image_fits
from test_fits import _card, _header, _pad_data

SYNC = b"\x1a\xcf\xfc\x1d"


def _fields(frame):
    """A frame's fields as plain values (enums by value), for comparing
    the two packages' dataclasses."""
    out = {}
    for f in dataclasses.fields(frame):
        v = getattr(frame, f.name)
        if dataclasses.is_dataclass(v):
            v = dataclasses.asdict(v)
        elif hasattr(v, "value"):
            v = int(v.value)
        out[f.name] = v
    return out


# ---------------------------------------------------------------------------
# CCSDS and VITA-49 packets
# ---------------------------------------------------------------------------


def test_ccsds_roundtrip():
    kw = dict(apid=0x123, payload=b"hello", sequence_count=7, packet_type=1)
    raw = ccsds_build(**kw)
    assert raw == jccsds.build_packet(**kw)
    pkt = Ccsds.parse(raw)
    assert pkt.apid == 0x123
    assert pkt.packet_type == 1
    assert pkt.sequence_count == 7
    assert pkt.payload == b"hello"
    assert not pkt.secondary_header_flag
    assert pkt.total_length == len(raw)
    assert _fields(pkt) == _fields(jccsds.Ccsds.parse(raw))
    assert _fields(Ccsds.parse(memoryview(raw))) == _fields(pkt)


def test_ccsds_secondary_header():
    raw = ccsds_build(apid=1, payload=b"data", secondary_header=b"\x01\x02")
    assert raw == jccsds.build_packet(apid=1, payload=b"data",
                                      secondary_header=b"\x01\x02")
    pkt = Ccsds.parse(raw, CcsdsConfig(secondary_header_length=2))
    assert pkt.secondary_header_flag
    assert pkt.secondary_header == b"\x01\x02"
    assert pkt.payload == b"data"
    jpkt = jccsds.Ccsds.parse(raw, jccsds.CcsdsConfig(
        secondary_header_length=2))
    assert _fields(pkt) == _fields(jpkt)


def test_ccsds_truncated_raises():
    raw = ccsds_build(apid=1, payload=b"abcdef")
    for cut in (8, 3):
        with pytest.raises(CcsdsError):
            Ccsds.parse(raw[:cut])
        with pytest.raises(NeedMoreData):  # streaming parsers wait
            Ccsds.parse(raw[:cut])


def test_ccsds_config_json():
    for text in ('{"secondary_header_length": 10}',
                 '{"secondaryHeaderLength": 10}'):
        cfg = CcsdsConfig.from_json(text)
        assert cfg.secondary_header_length == 10
        assert cfg.secondary_header_length == \
            jccsds.CcsdsConfig.from_json(text).secondary_header_length


def test_vita49_roundtrip():
    kw = dict(stream_id=42, tsi=Tsi.UTC, integer_timestamp=1700000000,
              packet_count=3, trailer=0xDEADBEEF)
    raw = vita_build(b"payload!", **kw)
    jkw = dict(kw, tsi=jvita49.Tsi.UTC)
    assert raw == jvita49.build_packet(b"payload!", **jkw)
    pkt = Vita49.parse(raw)
    assert pkt.packet_type == PacketType.SIGNAL_DATA_STREAM_ID
    assert pkt.stream_id == 42
    assert pkt.integer_timestamp == 1700000000
    assert pkt.packet_count == 3
    assert pkt.payload == b"payload!"
    assert pkt.trailer.raw == 0xDEADBEEF
    assert pkt.total_length == len(raw)
    assert _fields(pkt) == _fields(jvita49.Vita49.parse(raw))


def test_vita49_malformed_raises():
    with pytest.raises(Vita49Error):
        Vita49.parse(b"\x00\x01")
    raw = vita_build(b"xx")
    with pytest.raises(Vita49Error):
        Vita49.parse(raw[:4])  # claims more words than present
    with pytest.raises(Vita49Error):
        Vita49.parse(b"\x10\x00\x00\x00")  # 0 words: corrupt, not short
    with pytest.raises(NeedMoreData):
        Vita49.parse(raw[:4])


def test_vita49_fractional_timestamp_roundtrip():
    raw = vita_build(b"payload!", tsi=Tsi.UTC, integer_timestamp=7,
                     tsf=Tsf.REAL_TIME_PS,
                     fractional_timestamp=123456789012345)
    assert raw == jvita49.build_packet(
        b"payload!", tsi=jvita49.Tsi.UTC, integer_timestamp=7,
        tsf=jvita49.Tsf.REAL_TIME_PS, fractional_timestamp=123456789012345)
    pkt = Vita49.parse(raw)
    assert pkt.fractional_timestamp == 123456789012345
    assert pkt.payload == b"payload!"
    assert _fields(pkt) == _fields(jvita49.Vita49.parse(raw))


# ---------------------------------------------------------------------------
# Parser: files, sync patterns, TCP streams
# ---------------------------------------------------------------------------


def test_parser_file_back_to_back(tmp_path):
    """Back-to-back CCSDS frames parse in order, on the Python walk (a
    small file) and through the native scanner (padded past its size
    gate), as JAX's parser reads them."""
    p1 = ccsds_build(apid=5, payload=b"one")
    p2 = ccsds_build(apid=6, payload=b"two")
    path = tmp_path / "stream.bin"
    for blob in (p1 + p2, p1 + p2 + ccsds_build(apid=7,
                                                payload=b"\0" * 4096)):
        path.write_bytes(blob)
        frames = parse_file(Ccsds, str(path))
        assert [f.apid for f in frames][:2] == [5, 6]
        assert [f.payload for f in frames][:2] == [b"one", b"two"]
        jframes = JParser(jccsds.Ccsds).parse_from_file(str(path))
        assert [_fields(f) for f in frames] == [_fields(f) for f in jframes]


def test_parser_sync_pattern(tmp_path):
    """Sync-pattern resync: only frames following the pattern parse."""
    p1 = vita_build(b"frame one!!!")
    path = tmp_path / "sync.bin"
    path.write_bytes(b"junkjunk" + SYNC + p1 + b"trailing")
    frames = list(Parser(Vita49, sync_pattern=SYNC).iter_frames(
        path.read_bytes()))
    assert len(frames) == 1
    assert frames[0].payload.rstrip(b"\x00") == b"frame one!!!"
    jframes = list(JParser(jvita49.Vita49, sync_pattern=SYNC).iter_frames(
        path.read_bytes()))
    assert [_fields(f) for f in frames] == [_fields(f) for f in jframes]


def _serve(chunks, pause=0.01):
    """A loopback server that sends ``chunks`` to its first client;
    returns its port and thread."""
    server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    server.bind(("127.0.0.1", 0))
    server.listen(1)

    def serve():
        try:
            conn, _ = server.accept()
            with conn:
                for c in chunks:
                    conn.sendall(c)
                    time.sleep(pause)  # force fragmented delivery
        finally:
            server.close()

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    return server.getsockname()[1], th


def test_parser_tcp_stream():
    """Live TCP ingestion with a callback."""
    pkts = [ccsds_build(apid=i, payload=bytes([i]) * 5, sequence_count=i)
            for i in range(4)]
    port, th = _serve(pkts)
    seen = []
    frames = Parser(Ccsds).start("127.0.0.1", port, callback=seen.append,
                                 max_frames=4, timeout=5.0)
    th.join(timeout=5)
    assert not th.is_alive()
    assert [f.apid for f in frames] == [0, 1, 2, 3]
    assert seen == frames
    assert [f.raw for f in frames] == pkts


def test_parser_tcp_stream_resyncs_past_corrupt_frame():
    """A corrupt frame mid-stream (a VITA49 header claiming 0 words)
    does not stall the stream parser."""
    good = [vita_build(payload=bytes([i]) * 8, stream_id=i)
            for i in range(3)]
    corrupt = b"\x10\x00\x00\x00" + b"\xab" * 12  # size_words == 0
    port, th = _serve([good[0], corrupt, good[1] + good[2]])
    frames = Parser(Vita49).start("127.0.0.1", port, max_frames=3,
                                  timeout=5.0)
    th.join(timeout=5)
    assert not th.is_alive()
    assert [f.stream_id for f in frames] == [0, 1, 2]


def test_parse_stream_accepts_sync_pattern():
    """parse_stream forwards sync_pattern/config to the Parser."""
    pkts = [ccsds_build(apid=i, payload=b"xyz", sequence_count=i)
            for i in range(2)]
    port, th = _serve([b"\x00garbage" + SYNC + p for p in pkts])
    frames = parse_stream(Ccsds, "127.0.0.1", port, sync_pattern=SYNC,
                          max_frames=2, timeout=5.0)
    th.join(timeout=5)
    assert not th.is_alive()
    assert [f.apid for f in frames] == [0, 1]


# ---------------------------------------------------------------------------
# equatorial, spice, constants, config
# ---------------------------------------------------------------------------


def test_equatorial_conversions():
    ra = peq.RightAscension(hours=5, minutes=55, seconds=10.3)
    assert abs(ra.to_degrees() - 88.79291666) < 1e-6
    dec = peq.Declination(degrees=7, arcminutes=24, arcseconds=25.4)
    assert abs(dec.to_degrees() - 7.40705555) < 1e-6
    dec_neg = peq.Declination(degrees=-16, arcminutes=42, arcseconds=58.0)
    assert dec_neg.to_degrees() < -16.7
    back = peq.RightAscension.from_degrees(ra.to_degrees())
    assert back.hours == 5 and back.minutes == 55
    assert abs(back.seconds - 10.3) < 1e-6
    assert ra.to_radians() == jeq.RightAscension(5, 55, 10.3).to_radians()
    assert dataclasses.astuple(back) == dataclasses.astuple(
        jeq.RightAscension.from_degrees(ra.to_degrees()))


def test_precession_betelgeuse_50_years():
    """Betelgeuse J2000 -> J2050: RA grows ~0.64 deg, Dec northward."""
    jd_2050 = 2451545.0 + 50 * 365.25
    ra2, dec2 = peq.precess(peq.RightAscension(5, 55, 10.3),
                            peq.Declination(7, 24, 25.4), jd_2050)
    dra_deg = ra2.to_degrees() - peq.RightAscension(5, 55, 10.3).to_degrees()
    ddec_deg = dec2.to_degrees() - peq.Declination(7, 24, 25.4).to_degrees()
    assert 0.5 < dra_deg < 1.2
    assert 0.0 < ddec_deg < 0.3
    jra2, jdec2 = jeq.precess(jeq.RightAscension(5, 55, 10.3),
                              jeq.Declination(7, 24, 25.4), jd_2050)
    assert dataclasses.astuple(ra2) == dataclasses.astuple(jra2)
    assert dataclasses.astuple(dec2) == dataclasses.astuple(jdec2)


def test_declination_subdegree_sign_roundtrip():
    for deg in (-0.5, -0.004, -16.7, 0.5, 0.0):
        d = peq.Declination.from_degrees(deg)
        assert abs(d.to_degrees() - deg) < 1e-9, deg
        assert dataclasses.astuple(d) == dataclasses.astuple(
            jeq.Declination.from_degrees(deg))


def test_spice_pure_time_math():
    assert pspice.jd_to_et(2451545.0) == 0.0
    assert pspice.et_to_jd(86400.0) == 2451546.0
    for jd in (2451545.0, 2460310.5, 2400000.25):
        assert pspice.jd_to_et(jd) == jspice.jd_to_et(jd)
    assert pspice.DEFAULT_KERNELS == jspice.DEFAULT_KERNELS


def test_spice_gated():
    assert pspice.HAVE_SPICE == jspice.HAVE_SPICE
    if pspice.HAVE_SPICE:
        pytest.skip("spiceypy is installed here")
    with pytest.raises(pspice.SpiceNotEnabled):
        pspice.get_sun_position(0.0)
    with pytest.raises(pspice.SpiceNotEnabled):
        pspice.load_kernel("nonexistent.tls")


def test_constants_equal_jax():
    """Every upper-case constant and celestial body of the JAX package,
    equal in the port."""
    names = [n for n in dir(jconst) if n.isupper()]
    assert "EARTH" in names and "AU_KM" in names
    for n in names:
        assert repr(getattr(pconst, n)) == repr(getattr(jconst, n)), n
    assert set(pconst.BODIES) == set(jconst.BODIES)


def test_config_default_dtype():
    assert config.DEFAULT_DTYPE is torch.float64
    assert config.default_dtype() is torch.float64


# ---------------------------------------------------------------------------
# FITS: each file read by both packages into equal HDUs
# ---------------------------------------------------------------------------


def _same_hdus(path):
    """Both packages' readings of one file: headers, comments, kinds,
    shapes and raw data equal; returns the port's."""
    ours, theirs = pfits.Fits.open(str(path)), jfits.Fits.open(str(path))
    assert len(ours) == len(theirs)
    for a, b in zip(ours.hdus, theirs.hdus):
        assert (a.index, a.header, a.comments, a.kind, a.shape,
                a.data_bytes) == (b.index, b.header, b.comments, b.kind,
                                  b.shape, b.data_bytes)
    return ours, theirs


def test_fits_image_hdu(tmp_path):
    img = np.arange(12, dtype=np.int16).reshape(3, 4)
    p = tmp_path / "img.fits"
    make_image_fits(str(p), img)
    fits, jf = _same_hdus(p)
    hdu = pfits.open_and_parse(str(p))[0]
    assert hdu.kind == "image"
    assert hdu.header["OBJECT"] == "TESTOBJ"
    assert hdu.comments.get("OBJECT") == "synthetic"
    data = hdu.image()
    assert data.shape == (3, 4)
    np.testing.assert_array_equal(data, img * 2.0 + 100.0)
    np.testing.assert_array_equal(data, jf[0].image())


def test_fits_binary_table(tmp_path):
    p = tmp_path / "tab.fits"
    make_bintable_fits(str(p))
    fits, jf = _same_hdus(p)
    assert len(fits) == 2
    assert fits[0].kind == "primary"
    assert fits[1].kind == "binary_table"
    cols, jcols = fits[1].table(), jf[1].table()
    np.testing.assert_array_equal(cols["ID"], np.arange(5))
    np.testing.assert_allclose(cols["FLUX"], np.linspace(1, 2, 5))
    assert list(cols["NAME"]) == [f"SRC{i}" for i in range(5)]
    assert cols.keys() == jcols.keys()
    for k in cols:
        np.testing.assert_array_equal(cols[k], jcols[k])


def test_fits_not_fits_raises(tmp_path):
    p = tmp_path / "bad.fits"
    p.write_bytes(b"NOTAFITSFILE" + b" " * 3000)
    with pytest.raises(pfits.FitsError):
        pfits.Fits.open(str(p))


@pytest.mark.parametrize("stretch", ["linear", "log", "sqrt"])
def test_fits_pgm_export(tmp_path, stretch):
    img = np.random.default_rng(0).uniform(0, 1000, (16, 16))
    out, jout = tmp_path / "a.pgm", tmp_path / "b.pgm"
    pfits.image_to_pgm(img, str(out), stretch=stretch)
    jfits.image_to_pgm(img, str(jout), stretch=stretch)
    raw = out.read_bytes()
    assert raw.startswith(b"P5\n16 16\n255\n")
    assert len(raw) == len(b"P5\n16 16\n255\n") + 256
    assert raw == jout.read_bytes()


def test_fits_image_as_table(tmp_path):
    img = np.arange(12, dtype=np.int16).reshape(3, 4)
    p = tmp_path / "img.fits"
    make_image_fits(str(p), img)
    fits, jf = _same_hdus(p)
    cols, jcols = fits[0].image_as_table(), jf[0].image_as_table()
    assert set(cols) == {"x", "y", "value"}
    k = 1 * 4 + 2  # row-major: pixel (x=2, y=1)
    assert cols["x"][k] == 2 and cols["y"][k] == 1
    assert cols["value"][k] == img[1, 2] * 2.0 + 100.0
    for c in cols:
        np.testing.assert_array_equal(cols[c], jcols[c])


def test_fits_png_export(tmp_path):
    """The PNG files of both packages are equal byte for byte, and the
    decoded scanlines are the asinh-stretched input."""
    import struct
    import zlib

    img = np.random.default_rng(1).uniform(0, 1000, (8, 5))
    out, jout = tmp_path / "a.png", tmp_path / "b.png"
    pfits.image_to_png(img, str(out))
    jfits.image_to_png(img, str(jout))
    raw = out.read_bytes()
    assert raw == jout.read_bytes()
    assert raw.startswith(b"\x89PNG\r\n\x1a\n")
    pos, chunks = 8, {}
    while pos < len(raw):
        (length,), tag = struct.unpack(">I", raw[pos:pos + 4]), \
            raw[pos + 4:pos + 8]
        payload = raw[pos + 8:pos + 8 + length]
        assert struct.unpack(">I", raw[pos + 8 + length:pos + 12 + length]
                             )[0] == zlib.crc32(tag + payload)
        chunks[tag] = payload
        pos += 12 + length
    assert struct.unpack(">IIBB", chunks[b"IHDR"][:10]) == (5, 8, 8, 0)
    decoded = np.frombuffer(zlib.decompress(chunks[b"IDAT"]),
                            np.uint8).reshape(8, 6)
    assert (decoded[:, 0] == 0).all()
    expect = (pfits._asinh_stretch(img, 0.15, 0.5) * 255.0).astype(np.uint8)
    np.testing.assert_array_equal(decoded[:, 1:], expect)


def test_fits_endtime_keyword_not_mistaken_for_end(tmp_path):
    arr = np.asarray(np.arange(4, dtype=np.int16).reshape(2, 2), ">i2")
    cards = [_card("SIMPLE", True), _card("BITPIX", 16),
             _card("NAXIS", 2), _card("NAXIS1", 2), _card("NAXIS2", 2),
             _card("ENDTIME", "2024-01-01"), _card("OBJECT", "X")]
    p = tmp_path / "endtime.fits"
    with open(p, "wb") as f:
        f.write(_header(cards))
        f.write(_pad_data(arr.tobytes()))
    fits, _ = _same_hdus(p)
    hdu = fits[0]
    assert hdu.header["ENDTIME"] == "2024-01-01"
    assert hdu.header["OBJECT"] == "X"
    assert hdu.image().shape == (2, 2)


# ---------------------------------------------------------------------------
# mission planning, profiling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", [("earth", "mars", 0.0),
                                   ("mars", "earth", 120.0)])
def test_mission_plan_equals_jax(route):
    """The plan (Earth->Mars: ~5.6 km/s, ~259 days, synodic ~780 days)
    and every trajectory point equal JAX's; an inward leg with a later
    departure too."""
    origin, dest, t0 = route
    params = pmission.MissionParameters(origin=origin, destination=dest,
                                        departure_time_days=t0)
    plan = pmission.plan_mission(params)
    jplan = jmission.plan_mission(jmission.MissionParameters(
        origin=origin, destination=dest, departure_time_days=t0))
    if origin == "earth":
        assert abs(plan.total_dv_kms - 5.6) < 0.2
        assert abs(plan.transfer_time_days - 259.0) < 5
        assert 750 < plan.synodic_period_days < 800
    for f in ("departure_dv_kms", "arrival_dv_kms", "total_dv_kms",
              "transfer_time_days", "synodic_period_days",
              "phase_angle_rad"):
        assert getattr(plan, f) == getattr(jplan, f), f
    assert len(plan.trajectory) == len(jplan.trajectory)
    for a, b in zip(plan.trajectory, jplan.trajectory):
        assert (a.time_days, a.kind.value, a.label) == \
            (b.time_days, b.kind.value, b.label)
        np.testing.assert_array_equal(a.position_km, b.position_km)
    dep, arr = plan.trajectory[0], plan.trajectory[-1]
    assert abs(np.linalg.norm(dep.position_km)
               - pconst.BODIES[origin].semi_major_axis) < 1e3
    assert abs(np.linalg.norm(arr.position_km)
               - pconst.BODIES[dest].semi_major_axis) < 1e3


def test_mission_validation():
    with pytest.raises(ValueError):
        pmission.MissionParameters(origin="earth", destination="earth")
    with pytest.raises(ValueError):
        pmission.MissionParameters(origin="earth", destination="sun")


@pytest.mark.parametrize("pipelined", [True, False])
def test_measure_throughput_cpu(pipelined):
    calls = []

    def fn(x):
        calls.append(1)
        return {"r": x * 2.0, "err": (x > 0,)}

    res = profiling.measure_throughput(fn, torch.ones(8), items_per_call=8,
                                       n_calls=3, warmup=2,
                                       pipelined=pipelined)
    assert len(calls) == 5 and res.n_calls == 3
    assert res.seconds_per_call > 0
    assert res.items_per_second == pytest.approx(8 / res.seconds_per_call)
    assert "M items/s" in str(res)


def test_profiling_trace_and_memory_stats_cpu(tmp_path):
    assert profiling.device_memory_stats("cpu") is None
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.ones(64).sum()
    assert prof is not None
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
