"""The roofline arithmetic on hand-worked shapes."""

import pytest

from portbench import roofline


def test_bound_takes_the_larger_side():
    assert roofline.bound_s(3.35e12) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12 * 2) == pytest.approx(2.0)
    assert roofline.bound_s(3.35e12, 0, 34e12 * 3) == pytest.approx(3.0)


def test_fast_sweep_of_the_headline_catalog():
    # 13,478 x 1,440 with 674 deep lanes: 28 B a point is 0.543 GB,
    # 0.1622 ms at 3.35 TB/s; the f32 work (444 and 861 a point) is
    # 9.03e9 operations, 0.135 ms at 67 TFLOP/s: the bytes bound it
    near, deep = 12804 * 1440, 674 * 1440
    assert roofline.fast_sweep_s(near, deep, True) == pytest.approx(
        28 * 13478 * 1440 / 3.35e12)
    # without velocities a point writes 16 B and the operations bound it
    assert roofline.fast_sweep_s(near, deep, False) == pytest.approx(
        (444 * near + 861 * deep) / 67e12)


def test_f64_finalize_and_screen():
    pts = 13478 * 1440
    assert roofline.f64_sweep_s(pts, True) == pytest.approx(
        52 * pts / 3.35e12)
    # planes to time-major ECEF with velocities: 24 B read, 24 B written
    assert roofline.finalize_s(4408 * 8640, 4, True, "time_major",
                               "ecef") == pytest.approx(
        48 * 4408 * 8640 / 3.35e12)
    # 13,478 satellites: 90,821,503 pairs x 1,440 epochs x 9 operations
    assert roofline.screen_s(13478, 1440) == pytest.approx(
        9 * 90821503 * 1440 / 67e12)
    assert roofline.screen_s(13478, 1440) * 1e3 == pytest.approx(17.57,
                                                                 abs=0.01)
