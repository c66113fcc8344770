"""The yardstick of the roofline metrics: published peaks, and the
operations and bytes each kernel's work needs, frozen as constants so
that a roofline reads the same work whatever implements it.

Peaks: NVIDIA H100 SXM data sheet (dense, at the 700 W limit): HBM3 at
3.35 TB/s, 67 TFLOP/s f32 and 34 TFLOP/s f64 outside the tensor cores;
an FMA counts as two operations.

Operations a point: counted once (PR 18) by running the program's plain
torch versions under an operation counter at the headline catalog's
sizes on an H100 (13,478 x 1,440), then frozen here:
the near-earth SGP4 point (K1, and K3's near-earth columns) 444 f32 and
28 f64, the deep-space SDP4 point (K2) 861 f32 and 50 f64, the f64
kernel's point (DENSE, the mixed catalog's mean over near-earth and deep
lanes) 262 f64, an ECEF rotation 12 f32, a screen pair-epoch 9 f32
(3 subtracts, 3 multiplies, 2 adds and a min).

Bytes: each input byte read once and each output byte written once;
per-lane elements and per-epoch times are left out (under 0.1% at these
sizes).
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
PEAK_F64_OPS_S = 34e12

NEAR_POINT_OPS = (444.0, 28.0)
DEEP_POINT_OPS = (861.0, 50.0)
F64_POINT_OPS = 262.0
ECEF_POINT_OPS = 12.0
PAIR_EPOCH_OPS = 9.0

def bound_s(n_bytes: float, f32_ops: float = 0.0,
            f64_ops: float = 0.0) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate of their type
    (f32 and f64 run on separate units)."""
    return max(n_bytes / PEAK_BYTES_S, f32_ops / PEAK_F32_OPS_S,
               f64_ops / PEAK_F64_OPS_S)


def point_bytes(dtype_bytes: int, velocities: bool) -> int:
    """Bytes a point of a sweep writes: r (and v), 3 values each, and
    its i32 code."""
    return 3 * dtype_bytes * (2 if velocities else 1) + 4


def fast_sweep_s(near_points: int, deep_points: int,
                 velocities: bool) -> float:
    """The fast path's kernels over a sweep: every point's outputs
    written once, SGP4's operations on near-earth points and SDP4's on
    deep ones."""
    return bound_s(point_bytes(4, velocities) * (near_points + deep_points),
                   NEAR_POINT_OPS[0] * near_points
                   + DEEP_POINT_OPS[0] * deep_points,
                   NEAR_POINT_OPS[1] * near_points
                   + DEEP_POINT_OPS[1] * deep_points)


def f64_sweep_s(points: int, velocities: bool) -> float:
    """The f64 kernel over a sweep."""
    return bound_s(point_bytes(8, velocities) * points, 0.0,
                   F64_POINT_OPS * points)


def finalize_s(points: int, dtype_bytes: int, velocities: bool,
               layout: str, output: str) -> float:
    """The epilogue over a sweep's planes: r (and v) read once and
    written once in the caller's layout; the codes are read and written
    only where the layout moves them (sat_major)."""
    n_bytes = 2 * 3 * dtype_bytes * (2 if velocities else 1) * points
    if layout == "sat_major":
        n_bytes += 8 * points
    ops = ECEF_POINT_OPS * points if output != "teme" else 0.0
    if dtype_bytes == 8:
        return bound_s(n_bytes, 0.0, ops)
    return bound_s(n_bytes, ops, 0.0)


def screen_s(n_sats: int, epochs: int) -> float:
    """The coarse screen: every pair i < j at every epoch, f32 positions
    read once."""
    pair_epochs = epochs * n_sats * (n_sats - 1) // 2
    return bound_s(12 * n_sats * epochs, PAIR_EPOCH_OPS * pair_epochs)
