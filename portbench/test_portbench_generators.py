"""The seeded catalogs: the same text for a seed, the configuration's
regime and shell counts for every seed, TLE text the reference reads."""

import json
from pathlib import Path

import numpy as np
import pytest

from portbench import tle_text
from portbench.catalogs import mixed_catalog, walker_shells
from portbench.reference import catalog as ref
from portbench.reference.tle import parse_catalog

HERE = Path(__file__).resolve().parent
ACTIVE = json.loads((HERE / "configs/active-catalog-13478.json").read_text())
STARLINK = json.loads((HERE / "configs/starlink-gen1-4408.json").read_text())
BIG_SEED = 2**31 + 123


@pytest.mark.parametrize("gen, config", [(mixed_catalog, ACTIVE),
                                         (walker_shells, STARLINK)])
def test_deterministic_per_seed(gen, config):
    a = gen.text(config, BIG_SEED)
    assert a == gen.text(config, BIG_SEED)
    assert a != gen.text(config, BIG_SEED + 1)


@pytest.mark.parametrize("seed", [1, BIG_SEED])
def test_active_catalog_regimes(seed):
    assert mixed_catalog.counts(ACTIVE) == {"leo": 12804, "geo": 404,
                                            "gps_heo": 270}
    cat = ref.build(mixed_catalog.text(ACTIVE, seed))
    s = cat.summary()
    assert cat.n_sats == 13478 and s["deep"] == 404 + 270
    assert s["geosynchronous"] == 404
    # e >= 0.5 makes a half-day lane resonant; e > 0.7 one bin either way
    assert abs(s["half_day"] - 0.24 / 0.73 * 270) <= 1.5
    assert abs(s["half_day_heo"] - 0.04 / 0.73 * 270) <= 1.5
    assert (cat.els.error == 0).all()


@pytest.mark.parametrize("seed", [1, BIG_SEED])
def test_starlink_shells(seed):
    cols = parse_catalog(walker_shells.text(STARLINK, seed))
    inc = np.round(np.degrees(cols["inclo"]), 4)
    assert len(inc) == 4408
    assert {k: int((inc == k).sum()) for k in (53.0, 53.2, 70.0, 97.6)} \
        == {53.0: 1584, 53.2: 1584, 70.0: 720, 97.6: 520}
    assert ((cols["ecco"] >= 1e-4) & (cols["ecco"] <= 2.5e-4)).all()
    cat = ref.build(walker_shells.text(STARLINK, seed))
    assert cat.summary()["deep"] == 0


def test_tle_text_round_trips():
    line = tle_text.lines(12345, tle_text.epoch_field(2460310.75), 0.0012345,
                          98.7654, 123.4567, 45.6789, 300.1234, 14.87654321,
                          -2.3456e-5)
    l1, l2 = line.splitlines()
    assert len(l1) == len(l2) == 69
    cols = parse_catalog(line)
    assert cols["epoch_jd"][0] == pytest.approx(2460310.75, abs=1e-8)
    assert cols["ecco"][0] == 0.0012345
    assert np.degrees(cols["inclo"][0]) == pytest.approx(98.7654)
    assert cols["bstar"][0] == pytest.approx(-2.3456e-5)
    assert cols["no_kozai"][0] * 1440 / (2 * np.pi) == pytest.approx(
        14.87654321)
