"""The reference against python-sgp4's golden vectors, and its pair
search against brute force."""

import numpy as np
import pytest
import torch

from portbench.reference import catalog as ref
from portbench.reference.pairs import close_pairs

#: python-sgp4 v2.25 (WGS-72): (minutes since epoch, TEME r km)
ISS = ("1 25544U 98067A   24001.50000000  .00016717  00000-0  10270-3 0  9993\n"
       "2 25544  51.6400 200.0000 0001234  90.0000 270.0000 15.50000000000017")
ISS_R = [(0.0, (-6388.6251039457, -2316.4105418668, -10.5105608841)),
         (360.0, (-5564.4087742750, 1216.0553986884, -3713.3763010911)),
         (720.0, (-1479.3844792026, 3958.1883289274, -5328.0625952509)),
         (1440.0, (6475.4254340451, 2031.6698883792, -355.1829280487))]
#: GPS 20413, GEO 28626 (Lyddane branch), Molniya 09880 (half-day
#: resonance, e 0.73): python-sgp4 at 0, 720 and 1440 minutes
DEEP = "\n".join([
    "1 20413U 90005A   24186.00000000  .00000012  00000+0  10000-3 0  9992",
    "2 20413  55.4408  61.4858 0112981 129.5765 231.5553  2.00561730104446",
    "1 28626U 05004A   24186.00000000 -.00000098  00000+0  00000+0 0  9998",
    "2 28626   0.0163 279.8379 0003069  20.3251 343.1766  1.00270142 70992",
    "1 09880U 77021B   24186.00000000  .00000023  00000+0  00000+0 0  9999",
    "2 09880  63.4300  75.8891 7318036 269.8735  16.7549  2.00611684 54321"])
DEEP_R = {
    0.0: [(12743.39105131, 23518.44806062, 28.23195962),
          (9727.65902952, -41014.43193269, -9.39974955),
          (2575.93297901, 13237.27540045, 1419.07364030)],
    720.0: [(12513.21380970, 23633.30126287, 414.75154681), None, None],
    1440.0: [(12279.27857794, 23740.96214221, 801.15912584),
             (10430.11028794, -40841.32649665, None),
             (2175.00194988, 14214.96552375, 2741.44350110)]}
DEEP_V0 = [(-1.93584727, 1.00575086, 3.16821707),
           (2.99252607, 0.71003488, 0.00039212),
           (-1.59368245, 3.99224937, 5.03078896)]


def _at(cat, minutes):
    """The reference at ``minutes`` after each lane's (shared) epoch."""
    jd = np.full(len(minutes), float(cat.els.epoch_jd[0]))
    fr = np.asarray(minutes, np.float64) / 1440.0
    return ref.propagate(cat, jd, fr, device="cpu")


def test_iss_golden():
    cat = ref.build(ISS)
    r, _, err = _at(cat, [t for t, _ in ISS_R])
    assert (err == 0).all()
    for k, (_, want) in enumerate(ISS_R):
        np.testing.assert_allclose(r[k, 0].numpy(), want, atol=1e-6)


def test_deep_goldens():
    cat = ref.build(DEEP)
    assert list(cat.deep_idx) == [0, 1, 2]
    assert list(np.asarray(cat.deep.irez)) == [0, 1, 2]
    times = sorted(DEEP_R)
    r, v, err = _at(cat, times)
    assert (err == 0).all()
    for k, t in enumerate(times):
        for s, want in enumerate(DEEP_R[t]):
            if want is None:
                continue
            known = [c for c in range(3) if want[c] is not None]
            np.testing.assert_allclose(r[k, s, known].numpy(),
                                       [want[c] for c in known], atol=0.01)
    np.testing.assert_allclose(v[0].numpy(), DEEP_V0, atol=1e-5)


def test_float32_is_the_same_mathematics():
    """The control's float32 propagation stays within a few km of f64 a
    day out (and is not equal to it)."""
    cat = ref.build(DEEP + "\n" + ISS)
    r64, _, _ = _at(cat, [1440.0])
    r32, _, _ = ref.propagate(cat, np.full(1, float(cat.els.epoch_jd[0])),
                              np.ones(1), dtype=torch.float32, device="cpu")
    gap = (r32.double() - r64).norm(dim=-1)
    assert float(gap.max()) < 20.0 and float(gap.min()) > 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_pairs_equal_brute_force(seed):
    rng = np.random.default_rng(seed)
    r = torch.as_tensor(rng.uniform(-40.0, 40.0, (6, 300, 3)))
    ok = torch.as_tensor(rng.uniform(size=(6, 300)) > 0.1)
    got = close_pairs(r, ok, 6.0, rows=4)
    d = torch.cdist(r, r)
    d = torch.where(ok[:, :, None] & ok[:, None, :], d, torch.inf)
    want = {}
    for t, i, j in zip(*np.nonzero(d.numpy() <= 6.0)):
        if i < j and ((i, j) not in want or d[t, i, j] < want[(i, j)][0]):
            want[(int(i), int(j))] = (float(d[t, i, j]), int(t))
    assert got.keys() == want.keys() and len(want) > 50
    for k, (dist, t) in want.items():
        assert got[k][0] == pytest.approx(dist, abs=1e-9)
