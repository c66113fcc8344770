"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

(``python3 chip_smoke.py --cpu-screen N`` only times the screen of N
shell lanes with ``device="cpu"``; see :func:`cpu_screen_cost`.)

Phases (any failure exits non-zero; nothing is caught):

0. the card: ``torch.cuda.is_available()``, its name and power limit from
   nvidia-smi; the port imports without JAX;
1. build kernels K1-K6 (``astroz_tpu_torch/csrc/*.cu``) with nvcc, one
   process per source, and print ptxas' registers and spills;
2. K1 vs its plain torch version on the card, on a small ragged
   near-earth catalog with backward and forward times and at the full
   13,478 x 1,440 shape, with and without velocities, at 3 and 8 Newton
   trips: error codes identical, positions within 1e-3 km, velocities
   within 1e-6 km/s, kernel positions bit-equal with and without
   velocities;
2b. K2 (deep subset) and K3 (merge) vs their plain versions under the
   same bounds: a small mixed catalog with spread epochs and failing
   deep lanes, backward and forward times, at 6 and 8 trips, with and
   without velocities, and again at the headline mixed catalog's deep
   subset x 1,440; K3's deep columns must equal K2's planes bit for bit;
2c. K5 (dense tsince) and K6 (the tail on the f64 spine's grids) vs
   their plain versions under the same bounds: a ragged 1,002-satellite
   catalog with spread epochs and a decaying lane on a dense grid of
   mixed sign and on a (T, 1) column, and bench_single_sat's ISS at one
   full (4,096, 1,024) chunk, at 3 and 8 trips, with and without
   velocities; K5 on ``t_time - t_sat`` must equal K1, K6 must equal K5,
   and K5's positions must not change without velocities, bit for bit;
3. the near-earth main path: 13,478 synthetic near-earth TLEs as text ->
   ``Constellation(text, device="cuda")`` -> ``propagate`` over 1,440
   one-minute epochs, as planes, as ECEF planes and time-major. Each
   call must launch K1 once (and K2, K3 never); outputs must be finite
   CUDA tensors, |r| in the LEO band on healthy lanes, a 512-column
   sample equal to the plain version run on the CPU within the phase-2
   bounds, and the python-sgp4 golden trajectory within 0.1 km;
3b. the mixed main path: the headline catalog of bench.py (13,478 TLEs,
   667 deep lanes, 14 of them HEO-escape lanes) through the same calls.
   Each call must launch K2 once and K3 once (and K1 never); outputs
   finite CUDA tensors; healthy LEO, GEO and HEO/GPS columns in their
   radius bands; every column at 145 of the epochs equal to the plain
   path run on the CPU within the phase-2 bounds; the python-sgp4 GEO
   and Molniya golden vectors within 0.1 km;
3c. the single-satellite time-grid path (bench_single_sat.py): the ISS
   golden TLE broadcast to 1,024 lanes, minutes as (rows, 1,024) f64
   chunks of at most 2^22 points, over 1day_1min, 1week_1min and
   1year_1s (31,536,000 points, 8 chunks) through ``propagate_fast_fused``
   (K5, once a chunk), ``propagate_fast_grids`` (K6, once a chunk, equal
   to K5 bit for bit) and the f64 ``sgp4_propagate``: finite CUDA
   outputs, error codes all 0 on the short scenarios and equal between
   fast and f64 on all, |r| in the LEO band on healthy points, the f64
   path within 0.1 km of the python-sgp4 trajectory, fast within the JAX
   package's 30 m / 50 m of f64 on the short scenarios (the year's
   largest distance printed);
3d. the f64 main path: the headline mixed catalog x 1,440 through
   ``Constellation.propagate(method="f64")`` as planes, time-major and
   with ``scan_times=True``, which launch no kernel: error codes equal
   the fast path's, the fast path within 0.05 km of f64 on healthy
   near-earth points, 0.1 km on deep ones (the worst lane of each regime
   printed) and 5e-3 km on the escape lanes, scan within 1e-6 km
   and 1e-9 km/s of dense, the GEO and Molniya golden vectors within
   0.01 km, and ``propagate_tsince`` on a (16, 1) grid equal to
   ``sdp4_propagate``;
4. timings with CUDA events: K1 alone and its plain version on the card,
   in turns, and the whole near-earth ``propagate`` call;
4b. the same for K2 and K3, plus the HEO escape, the resonance tables
   and the whole mixed ``propagate`` call, and the peak device memory of
   a mixed sweep;
5. K4 (the coarse screening pass) vs its plain version on the card, in
   both modes. Matrix mode bit for bit on every entry checked (NaN where
   NaN, +inf at and below the diagonal): a ragged 1,002-satellite x
   100-epoch shell with parked failed lanes and one NaN position,
   single-shot and in ragged column chunks, and ``coarse_min_all`` of the
   full 13,478 x 240 planes (one chunk of all columns) on the column
   blocks of K4_SAMPLE_BLOCKS. Candidate mode with the same (i, j) pairs
   in order as its plain version: the small shell at 200 km, once with
   room for all pairs and once through the overflow path (two launches),
   and the 13,478 x 240 planes at 10 km, where it also equals the
   thresholded matrix. The plain matrix version's device memory an entry
   must stay within the bytes its column blocks are sized by;
6. the screening main path: bench_screening's shell (13,478 TLEs) ->
   ``Constellation(text, device="cuda").screen`` over 240 one-minute
   epochs at 10 km, which must launch K1 once and K4's candidate mode
   once (matrix mode never); the pairs (numpy, i < j, d < 10 km, sorted)
   must equal those of the plain candidate version of phase 5 (the same
   planes and threshold), then the same refine;
6b. the same screen over the mixed headline catalog (K2, the escape, K3,
   then K4's candidate mode), and ``screen_target`` of the ISS golden TLE
   against it, equal to a direct reduction of the propagated planes;
7. timings with CUDA events: K4's two modes at 13,478 x 240 and their
   plain versions, in turns, each mode's share of its operation bound and
   of the FMA instruction floor, K4's registers and spills from ptxas, the
   ``torch.cdist`` yardstick on one column chunk, the pieces and the whole
   of a ``screen`` call (CUDA events and wall clock), ``screen_target``,
   and the peak device memory of a screen;
4c. timings with CUDA events: K5 and K6 alone at one (4,096, 1,024) chunk
   and their plain versions, in turns, the torch spine that feeds K6, the
   whole 1year_1s sweep through K5 and through the f64 ``sgp4_propagate``,
   the f64 ``propagate`` of the mixed catalog (planes, time-major,
   ``scan_times=True``), and the peak device memory of each.

The last three lines of output are the card line from nvidia-smi, a
JSON line describing the kernels (with each one's bound: the larger of
its bytes over the card's memory rate and its operations over the peak
rate for their type), and ``{"ok": true, "device": ...}``.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

DEVICE = "cuda"
N_SATS = 13478
N_TIMES = 1440
EPOCH_JD = 2460310.5
POS_TOL_KM = 1e-3
VEL_TOL_KMS = 1e-6
SAMPLE_COLS = 512
#: geocentric radius band of the synthetic catalogs' healthy near-earth
#: lanes: above the surface, below the 12 rev/day, e = 0.02 apogee
#: (~8,220 km)
LEO_BAND_KM = (6378.135, 8300.0)
#: GEO lanes (rev/day ~1.0027, e < 5e-4) stay within this of 42,164 km
GEO_RADIUS_KM, GEO_BAND_KM = 42164.0, 100.0
#: the headline generator's 1.9-2.1 rev/day lanes with e up to 0.74:
#: apogee at most (1 + 0.74) x 27,540 km = 47,920 km
HEO_BAND_KM = (6378.135, 48500.0)
#: facts of the headline generator (bench.py) at 13,478 satellites
HEADLINE_DEEP, HEADLINE_ESCAPE = 667, 14

#: the screening scenario: bench_screening's shell at N_SATS satellites,
#: 240 one-minute epochs from its epoch (24001.5), a 10 km threshold
SCREEN_TIMES = 240
SCREEN_EPOCH_JD = 2460311.0
SCREEN_KM = 10.0
#: column chunk of K4's plain version on the card: (13,478, 2,048) f64
#: temporaries of 0.22 GB each (the rows below a chunk's last column
#: only, so narrow chunks skip most of the lower triangle)
PLAIN_COLS = 2048
#: K4's matrix mode at 13,478 x 240 is held against its plain version on
#: these column blocks (start, width): the first, one across the middle
#: and the ragged last
K4_SAMPLE_BLOCKS = ((0, 512), (6400, 512), (N_SATS - 300, 300))
#: column chunk of the cdist yardstick: a (240, 13,478, 512) f32 result
#: of 6.6 GB
CDIST_COLS = 512

#: NVIDIA H100 SXM peaks (data sheet; the f32 rate counts an FMA as two
#: operations, the f64 rate is the vector rate outside the tensor cores)
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
PEAK_F64_OPS_S = 34e12
#: K4's f32 operations a pair-time: 3 subtracts, 3 multiplies, 2 adds
#: and a min (an FMA counts as a multiply and an add); and the
#: instructions it issues with FMA (3 FADD, 1 FMUL, 2 FFMA, 1 FMNMX),
#: against 128 f32 lanes an SM at the card's largest SM clock
K4_OPS, K4_INSTRUCTIONS, LANES_PER_SM = 9, 7, 128

#: python-sgp4 v2.25 reference trajectory of the TLE below (WGS-72):
#: (minutes since epoch, TEME position km)
GOLDEN_L1 = ("1 25544U 98067A   24001.50000000  .00016717  00000-0  "
             "10270-3 0  9993")
GOLDEN_L2 = ("2 25544  51.6400 200.0000 0001234  90.0000 270.0000 "
             "15.50000000000017")
GOLDEN = [(0.0, (-6388.6251039457, -2316.4105418668, -10.5105608841)),
          (360.0, (-5564.4087742750, 1216.0553986884, -3713.3763010911)),
          (720.0, (-1479.3844792026, 3958.1883289274, -5328.0625952509)),
          (1440.0, (6475.4254340451, 2031.6698883792, -355.1829280487))]

#: python-sgp4 deep-space golden vectors (GEO 28626 on the Lyddane
#: branch, Molniya-class 09880 on half-day resonance, an escape lane):
#: (minutes since epoch, TEME position km; None where not recorded)
GOLDEN_DEEP_TLES = (
    "1 28626U 05004A   24186.00000000 -.00000098  00000+0  00000+0 0  9998\n"
    "2 28626   0.0163 279.8379 0003069  20.3251 343.1766  1.00270142 70992\n"
    "1 09880U 77021B   24186.00000000  .00000023  00000+0  00000+0 0  9999\n"
    "2 09880  63.4300  75.8891 7318036 269.8735  16.7549  2.00611684 54321")
GOLDEN_DEEP = {
    0.0: [(9727.65902952, -41014.43193269, -9.39974955),
          (2575.93297901, 13237.27540045, 1419.07364030)],
    1440.0: [(10430.11028794, -40841.32649665, None),
             (2175.00194988, 14214.96552375, 2741.44350110)]}


#: bench_single_sat's scenarios that phase 3c runs: (name, points, step
#: in seconds), one ISS TLE (GOLDEN_L1/L2) folded into SINGLE_SAT_LANES
#: lanes and cut into chunks of at most SINGLE_SAT_CHUNK points
SINGLE_SAT_SCENARIOS = (("1day_1min", 1440, 60.0),
                        ("1week_1min", 10080, 60.0),
                        ("1year_1s", 31536000, 1.0))
SINGLE_SAT_LANES = 1024
SINGLE_SAT_CHUNK = 1 << 22
#: the JAX package's fast-vs-f64 gates of those scenarios, km
#: (tests/test_fast.py)
SINGLE_SAT_GATE_KM = {"1day_1min": 0.03, "1week_1min": 0.05}


def check(ok, what):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def sync():
    torch.cuda.synchronize()


def reset_launches():
    """Set every kernel's launch count to 0."""
    from astroz_tpu_torch.ops import cuda_screen, cuda_sgp4

    for counts in (cuda_sgp4.LAUNCHES, cuda_screen.LAUNCHES):
        for name in counts:
            counts[name] = 0


def launches():
    """Every kernel's launch count, by kernel."""
    from astroz_tpu_torch.ops import cuda_screen, cuda_sgp4

    return {**cuda_sgp4.LAUNCHES, **cuda_screen.LAUNCHES}


#: aten ops that write floats without arithmetic: they make, move,
#: reshape, cast or select data
_NOT_ARITHMETIC = frozenset((
    "_to_copy", "_unsafe_view", "alias", "as_strided", "cat", "clone",
    "copy_", "detach", "empty", "empty_like", "expand", "fill_", "full",
    "full_like", "gather", "index", "index_select", "lift_fresh",
    "masked_fill", "masked_fill_", "new_empty", "ones", "ones_like",
    "permute", "scalar_tensor", "select", "slice", "stack", "unbind",
    "unsqueeze", "view", "where", "zeros", "zeros_like"))


def count_ops(fn):
    """Run ``fn``, a kernel's plain version, and count its floating-point
    arithmetic: the elements written by every aten op whose result is f32
    or f64, outside :data:`_NOT_ARITHMETIC`, by the result's type. Casts,
    selects and data movement are not counted, nor are comparisons and
    integer or boolean ops (their results are not floats). A divide, a
    square root or an ``fmod`` counts as one operation. Returns
    ``(f32_ops, f64_ops)``."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    counts = {torch.float32: 0, torch.float64: 0}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            outs = [x for x in tree_flatten(out)[0]
                    if isinstance(x, torch.Tensor)]
            if (outs and outs[0].dtype in counts
                    and func.overloadpacket.__name__ not in _NOT_ARITHMETIC):
                counts[outs[0].dtype] += outs[0].numel()
            return out

    with Count():
        fn()
    return counts[torch.float32], counts[torch.float64]


def nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors
               if x is not None)


def bound(n_bytes, f32_ops, f64_ops):
    """The least time the card could take, ms, and what bounds it: the
    larger of the bytes over the memory rate and the operations over the
    peak rate for their type (f32 and f64 run on separate units)."""
    by_bytes = n_bytes / PEAK_BYTES_S
    by_ops = max(f32_ops / PEAK_F32_OPS_S, f64_ops / PEAK_F64_OPS_S)
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def _tle_text(epoch, ecco, inclo, nodeo, argpo, mo, rev_day, bstar):
    from astroz_tpu_torch.tle import format_lines

    lines = []
    for k in range(len(ecco)):
        lines += format_lines(
            satnum=10000 + k, epoch_jd=float(epoch[k]), ecco=float(ecco[k]),
            inclo_deg=float(inclo[k]), nodeo_deg=float(nodeo[k]),
            argpo_deg=float(argpo[k]), mo_deg=float(mo[k]),
            no_rev_day=float(rev_day[k]), bstar=float(bstar[k]))
    return "\n".join(lines)


def near_earth_catalog_text(n, seed=42, epoch_spread_days=0.0):
    """The headline benchmark's synthetic catalog, near-earth lanes only:
    rev/day U(12, 16), e U(1e-4, 0.02), i U(17, 103) deg, bstar
    U(-1e-4, 1e-3), epoch JD 2460310.5 (plus a uniform spread if
    asked), as 2-line TLE text."""
    rng = np.random.default_rng(seed)
    rev_day = rng.uniform(12.0, 16.0, n)
    ecco = rng.uniform(1e-4, 0.02, n)
    inclo = rng.uniform(17.0, 103.0, n)
    nodeo = rng.uniform(0, 360.0, n)
    argpo = rng.uniform(0, 360.0, n)
    mo = rng.uniform(0, 360.0, n)
    bstar = rng.uniform(-1e-4, 1e-3, n)
    epoch = EPOCH_JD + rng.uniform(-epoch_spread_days, epoch_spread_days, n)
    return _tle_text(epoch, ecco, inclo, nodeo, argpo, mo, rev_day, bstar)


def mixed_catalog_text(n, seed=42, epoch_spread_days=0.0):
    """The headline benchmark's synthetic catalog (``bench.py``'s
    ``synthetic_catalog_text``, the same draws in the same order): ~95%
    LEO (rev/day U(12, 16), e U(1e-4, 0.02)), ~3% GEO (rev/day
    N(1.0027, 1e-4), e U(1e-4, 5e-4), i U(0, 5.7) deg), ~2% GPS/HEO
    (rev/day U(1.9, 2.1), e U(0.01, 0.74)); i U(17, 103) deg off GEO,
    bstar U(-1e-4, 1e-3), epoch JD 2460310.5 (plus a uniform spread if
    asked, drawn last), as 2-line TLE text."""
    rng = np.random.default_rng(seed)
    kind = rng.choice(3, size=n, p=[0.95, 0.03, 0.02])
    rev_day = np.where(kind == 0, rng.uniform(12.0, 16.0, n),
                       np.where(kind == 1, rng.normal(1.0027, 1e-4, n),
                                rng.uniform(1.9, 2.1, n)))
    ecco = np.where(kind == 0, rng.uniform(1e-4, 0.02, n),
                    np.where(kind == 1, rng.uniform(1e-4, 5e-4, n),
                             rng.uniform(0.01, 0.74, n)))
    inclo = np.where(kind == 1, rng.uniform(0.0, 5.7, n),
                     rng.uniform(17.0, 103.0, n))
    nodeo = rng.uniform(0, 360.0, n)
    argpo = rng.uniform(0, 360.0, n)
    mo = rng.uniform(0, 360.0, n)
    bstar = rng.uniform(-1e-4, 1e-3, n)
    epoch = np.full(n, EPOCH_JD)
    if epoch_spread_days:
        epoch = epoch + rng.uniform(-epoch_spread_days, epoch_spread_days, n)
    return _tle_text(epoch, ecco, inclo, nodeo, argpo, mo, rev_day, bstar)


def screening_shell_text(n, seed=7):
    """The screening benchmark's synthetic shell
    (``benchmarks/bench_screening.py``, the same draws in the same
    order): inclination 53 +- 2 deg, RAAN and mean anomaly U(0, 360) deg,
    e = 1e-4, argument of perigee 90 deg, 14-15.5 rev/day, bstar 0, one
    epoch (24001.5, JD 2460311.0), as 2-line TLE text."""
    rng = np.random.default_rng(seed)
    lines = []
    for k in range(n):
        incl = 53.0 + rng.uniform(-2, 2)
        raan = rng.uniform(0, 360)
        mo = rng.uniform(0, 360)
        lines.append(f"1 {10000+k:05d}U 98067A   24001.50000000  "
                     f".00000000  00000-0  00000+0 0  9990")
        lines.append(f"2 {10000+k:05d} {incl:8.4f} {raan:8.4f} 0001000 "
                     f" 90.0000 {mo:8.4f} {14.0 + rng.uniform(0, 1.5):11.8f}10")
    return "\n".join(lines)


def single_sat_chunks(n_points, step_s, lanes=None, max_chunk=None,
                      device=None):
    """bench_single_sat's time grid, time folded into the lanes: minutes
    ``k * step_s / 60`` for k < ``n_points`` padded to a multiple of
    ``lanes`` (SINGLE_SAT_LANES), in chunks of at most ``max_chunk``
    points (SINGLE_SAT_CHUNK), each a (rows, lanes) f64 tensor on
    ``device`` (DEVICE), made as the bench makes them."""
    lanes = lanes or SINGLE_SAT_LANES
    max_chunk = max_chunk or SINGLE_SAT_CHUNK
    device = device or DEVICE
    n_pad = n_points + (-n_points) % lanes
    chunk = min(n_pad, max_chunk)
    tmpl = (torch.arange(chunk, dtype=torch.float64, device=device)
            .reshape(-1, lanes) * (step_s / 60.0))
    done = 0
    while done < n_pad:
        n = min(chunk, n_pad - done)
        yield tmpl[:n // lanes] + done * (step_s / 60.0)
        done += n


def single_sat_elements(cat, lanes=None):
    """A one-satellite catalog's elements broadcast to ``lanes`` lanes
    (SINGLE_SAT_LANES)."""
    from astroz_tpu_torch.ops.sgp4 import Sgp4Elements

    return Sgp4Elements(*(x.expand(lanes or SINGLE_SAT_LANES)
                          for x in cat.els))


def phase0_card():
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    import astroz_tpu_torch  # noqa: F401
    check("jax" not in sys.modules, "importing the port loaded jax")
    print(f"# phase 0: torch {torch.__version__} cuda {torch.version.cuda} "
          f"on {torch.cuda.get_device_name(0)} ({smi})")
    return smi


def phase1_build():
    from astroz_tpu_torch import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    print(f"# phase 1: nvcc built {path.name} in "
          f"{time.perf_counter() - t0:.1f} s "
          f"(flags: {' '.join(_build.NVCC_FLAGS)})")
    for name, regs, spill_st, spill_ld in _build.ptxas_report():
        print(f"# phase 1: ptxas {name}: {regs} registers, spill stores "
              f"{spill_st} B, spill loads {spill_ld} B")


def _kernel_vs_twin(st, t_time, grav, label, codes=None):
    """K1 vs its plain version at one shape, both Newton rungs, with and
    without velocities; returns the largest position and velocity
    differences. ``codes``: the error codes the points must show."""
    from astroz_tpu_torch.ops import cuda_sgp4

    args = (t_time, st.t_sat, st.spine, st.tail, st.flags)
    worst_r = worst_v = 0.0
    for iters in (3, 8):
        r, v, e = cuda_sgp4.propagate_fast_sep(*args, grav=grav,
                                               kepler_iters=iters)
        r0, v0, e0 = cuda_sgp4.propagate_fast_sep(
            *args, grav=grav, kepler_iters=iters, want_vel=False)
        rr, vr, er = cuda_sgp4.propagate_fast_sep_reference(
            *args, grav=grav, kepler_iters=iters)
        sync()
        check(v0 is None, "want_vel=False returned velocities")
        check(torch.equal(e, er) and torch.equal(e0, er),
              f"{label} iters={iters}: error codes differ from the plain "
              "version")
        dr = (r - rr).abs().max().item()
        dv = (v - vr).abs().max().item()
        codes_seen = sorted(set(torch.unique(e).tolist()))
        print(f"# phase 2: K1 {label} iters={iters}: max|dr| {dr:.3e} km, "
              f"max|dv| {dv:.3e} km/s, error codes {codes_seen}, "
              f"r bit-equal without v: {torch.equal(r, r0)}")
        check(dr <= POS_TOL_KM, f"{label}: |dr| {dr} > {POS_TOL_KM} km")
        check(dv <= VEL_TOL_KMS, f"{label}: |dv| {dv} > {VEL_TOL_KMS} km/s")
        check(torch.equal(r, r0), f"{label}: kernel positions differ with "
              "and without velocities")
        check(codes is None or set(codes) == set(codes_seen),
              f"{label}: error codes {codes_seen}, expected {codes}")
        worst_r, worst_v = max(worst_r, dr), max(worst_v, dv)
    return worst_r, worst_v


def phase2_kernel_vs_twin(headline_cat):
    from astroz_tpu_torch import build_catalog
    from astroz_tpu_torch.tle import format_lines

    # 333 spread-epoch lanes plus one that decays from the earliest
    # epoch, so that every error code of the tail (1, 4, 6) occurs
    decaying = format_lines(satnum=99999, epoch_jd=EPOCH_JD - 2.0,
                            ecco=5e-4, inclo_deg=51.6, nodeo_deg=10.0,
                            argpo_deg=20.0, mo_deg=30.0, no_rev_day=16.0,
                            bstar=0.5)
    small = build_catalog(near_earth_catalog_text(333, seed=7,
                                                  epoch_spread_days=2.0)
                          + "\n" + "\n".join(decaying), device=DEVICE)
    t_small = torch.linspace(-1440.0, 1440.0, 37, dtype=torch.float64,
                             device=DEVICE)
    worst = _kernel_vs_twin(small.fast_staging, t_small, small.grav,
                            "334 sats x 37 times (-1 .. +1 day)",
                            codes={0, 1, 4, 6})
    t_head = torch.arange(N_TIMES, dtype=torch.float64, device=DEVICE)
    head = _kernel_vs_twin(headline_cat.fast_staging, t_head,
                           headline_cat.grav,
                           f"{N_SATS} sats x {N_TIMES} times")
    return max(worst[0], head[0]), max(worst[1], head[1])


def _max_diff(a, b):
    return (a - b).abs().max().item() if a.numel() else 0.0


def _deep_and_merge_vs_twin(cat, t_time, label, k2_codes=None):
    """K2 vs its plain version at 6 and 8 trips, then K3 over the whole
    catalog on K2's planes vs its plain version, each with and without
    velocities. Returns the worst (K2 dr, K2 dv, K3 dr, K3 dv)."""
    from astroz_tpu_torch.ops import cuda_sgp4
    from astroz_tpu_torch.propagation import resonance_steps

    st, ds = cat.fast_staging, cat.fast_staging.deep
    jd_sum = cat.epoch_min_jd + t_time.cpu().numpy() / 1440.0
    steps = resonance_steps(jd_sum, cat.deep_epochs_jd)
    dargs = (t_time, ds.t_sat, ds.spine, ds.tail, ds.flags,
             cat.resonance_tables(steps))
    margs = (t_time, st.t_sat, st.spine, st.tail, st.flags, ds.slot)
    mkw = dict(grav=cat.grav, kepler_iters=cat.kepler_iters)
    cols = torch.as_tensor(cat.deep_idx, device=DEVICE)
    worst = [0.0] * 4
    for iters in (6, 8):
        kw = dict(grav=cat.grav, kepler_iters=iters)
        r, v, e = cuda_sgp4.propagate_deep_sep(*dargs, **kw)
        r0, v0, e0 = cuda_sgp4.propagate_deep_sep(*dargs, **kw,
                                                  want_vel=False)
        rr, vr, er = cuda_sgp4.propagate_deep_sep_reference(*dargs, **kw)
        sync()
        dr, dv = _max_diff(r, rr), _max_diff(v, vr)
        codes = sorted(set(torch.unique(e).tolist()))
        print(f"# phase 2b: K2 {label} steps={steps} iters={iters}: "
              f"max|dr| {dr:.3e} km, max|dv| {dv:.3e} km/s, error codes "
              f"{codes}, r bit-equal without v: {torch.equal(r, r0)}")
        check(v0 is None, "K2 want_vel=False returned velocities")
        check(torch.equal(e, er) and torch.equal(e0, er),
              f"K2 {label} iters={iters}: error codes differ")
        check(dr <= POS_TOL_KM and dv <= VEL_TOL_KMS,
              f"K2 {label} iters={iters}: |dr| {dr} km, |dv| {dv} km/s")
        check(torch.equal(r, r0), f"K2 {label}: positions differ with and "
              "without velocities")
        check(k2_codes is None or set(k2_codes) <= set(codes),
              f"K2 {label}: error codes {codes} lack {k2_codes}")
        worst[0], worst[1] = max(worst[0], dr), max(worst[1], dv)

        m = cuda_sgp4.propagate_fast_sep_merge(*margs, r, v, e, **mkw)
        m0 = cuda_sgp4.propagate_fast_sep_merge(*margs, r0, None, e0, **mkw,
                                                want_vel=False)
        mr = cuda_sgp4.propagate_fast_sep_merge_reference(*margs, r, v, e,
                                                          **mkw)
        sync()
        dr, dv = _max_diff(m[0], mr[0]), _max_diff(m[1], mr[1])
        codes = sorted(set(torch.unique(m[2]).tolist()))
        print(f"# phase 2b: K3 {label} on K2's iters={iters} planes: "
              f"max|dr| {dr:.3e} km, max|dv| {dv:.3e} km/s, error codes "
              f"{codes}, r bit-equal without v: {torch.equal(m[0], m0[0])}")
        check(m0[1] is None, "K3 want_vel=False returned velocities")
        check(torch.equal(m[2], mr[2]) and torch.equal(m0[2], mr[2]),
              f"K3 {label}: error codes differ")
        check(dr <= POS_TOL_KM and dv <= VEL_TOL_KMS,
              f"K3 {label}: |dr| {dr} km, |dv| {dv} km/s")
        check(torch.equal(m[0], m0[0]), f"K3 {label}: positions differ "
              "with and without velocities")
        check(torch.equal(m[0][:, :, cols], r)
              and torch.equal(m[1][:, :, cols], v)
              and torch.equal(m[2][:, cols], e),
              f"K3 {label}: deep columns are not K2's planes")
        worst[2], worst[3] = max(worst[2], dr), max(worst[3], dv)
    return worst


def phase2b_deep_and_merge(headline_cat):
    from astroz_tpu_torch import build_catalog
    from astroz_tpu_torch.tle import format_lines

    # spread epochs, plus two failing deep lanes: a perigee below the
    # surface (error 6 near perigee) and a huge bstar (error 1)
    failing = [format_lines(satnum=99990 + k, epoch_jd=EPOCH_JD - 1.5,
                            ecco=ecc, inclo_deg=30.0, nodeo_deg=40.0,
                            argpo_deg=50.0, mo_deg=60.0, no_rev_day=rev,
                            bstar=bstar)
               for k, (rev, ecc, bstar) in enumerate(((6.3, 0.75, 0.01),
                                                      (6.0, 0.5, 5.0)))]
    small = build_catalog(
        mixed_catalog_text(1000, seed=7, epoch_spread_days=2.0) + "\n"
        + "\n".join(line for pair in failing for line in pair),
        device=DEVICE)
    irez = np.asarray(small.deep_host.irez)[small.deep_idx]
    print(f"# phase 2b: small mixed catalog: {len(small)} sats, "
          f"{small.n_deep} deep (irez 0/1/2: "
          f"{[int((irez == k).sum()) for k in range(3)]})")
    t_small = torch.linspace(-1440.0, 1440.0, 37, dtype=torch.float64,
                             device=DEVICE) + 2880.0
    w_small = _deep_and_merge_vs_twin(small, t_small,
                                      f"{len(small)} sats x 37 times",
                                      k2_codes={0, 1, 6})
    t_head = torch.arange(N_TIMES, dtype=torch.float64, device=DEVICE)
    w_head = _deep_and_merge_vs_twin(headline_cat, t_head,
                                     f"{N_SATS} sats x {N_TIMES} times")
    return [max(a, b) for a, b in zip(w_small, w_head)]


def _dense_vs_twin(els, tsince, grav, label, codes=None):
    """K5 and K6 vs their plain versions at one shape, both Newton rungs,
    with and without velocities; K6 on the torch spine's grids must equal
    K5 bit for bit. Returns the largest K5 position and velocity
    differences."""
    from astroz_tpu_torch.ops import cuda_sgp4
    from astroz_tpu_torch.ops.fast import shallow_staging

    staged = shallow_staging(els)
    grids, tail, flags = cuda_sgp4.spine_grids(els, tsince)
    worst_r = worst_v = 0.0
    for iters in (3, 8):
        kw = dict(grav=grav, kepler_iters=iters)
        r, v, e = cuda_sgp4.propagate_fast_dense(tsince, *staged, **kw)
        r0, v0, e0 = cuda_sgp4.propagate_fast_dense(tsince, *staged, **kw,
                                                    want_vel=False)
        rr, vr, er = cuda_sgp4.propagate_fast_dense_reference(tsince, *staged,
                                                              **kw)
        g = cuda_sgp4.propagate_fast_spine_grids(grids, tail, flags, **kw)
        g0 = cuda_sgp4.propagate_fast_spine_grids(grids, tail, flags, **kw,
                                                  want_vel=False)
        gr = cuda_sgp4.propagate_fast_spine_grids_reference(grids, tail,
                                                            flags, **kw)
        sync()
        check(v0 is None and g0[1] is None,
              "want_vel=False returned velocities")
        check(torch.equal(e, er) and torch.equal(e0, er),
              f"K5 {label} iters={iters}: error codes differ from the plain "
              "version")
        dr, dv = _max_diff(r, rr), _max_diff(v, vr)
        gdr, gdv = _max_diff(g[0], gr[0]), _max_diff(g[1], gr[1])
        same = all(torch.equal(a, b) for a, b in zip(g, (r, v, e)))
        codes_seen = sorted(set(torch.unique(e).tolist()))
        print(f"# phase 2c: {label} iters={iters}: K5 max|dr| {dr:.3e} km, "
              f"max|dv| {dv:.3e} km/s; K6 max|dr| {gdr:.3e} km, max|dv| "
              f"{gdv:.3e} km/s; error codes {codes_seen}; K6 bit-equal to "
              f"K5: {same}; r bit-equal without v: K5 {torch.equal(r, r0)}, "
              f"K6 {torch.equal(g[0], g0[0])}")
        check(dr <= POS_TOL_KM and dv <= VEL_TOL_KMS,
              f"K5 {label}: |dr| {dr} km, |dv| {dv} km/s")
        check(gdr <= POS_TOL_KM and gdv <= VEL_TOL_KMS
              and torch.equal(g[2], gr[2]),
              f"K6 {label}: |dr| {gdr} km, |dv| {gdv} km/s or error codes")
        check(same, f"{label}: K6 on the torch spine differs from K5")
        check(torch.equal(r, r0) and torch.equal(g[0], g0[0])
              and torch.equal(g0[2], e),
              f"{label}: positions differ with and without velocities")
        check(codes is None or set(codes) <= set(codes_seen),
              f"{label}: error codes {codes_seen} lack {codes}")
        worst_r, worst_v = max(worst_r, dr, gdr), max(worst_v, dv, gdv)
    return worst_r, worst_v


def phase2c_dense_vs_twin():
    """K5 and K6 against their plain versions; returns the largest
    position and velocity differences."""
    from astroz_tpu_torch import build_catalog
    from astroz_tpu_torch.ops import cuda_sgp4
    from astroz_tpu_torch.tle import format_lines

    decaying = format_lines(satnum=99999, epoch_jd=EPOCH_JD - 2.0,
                            ecco=5e-4, inclo_deg=51.6, nodeo_deg=10.0,
                            argpo_deg=20.0, mo_deg=30.0, no_rev_day=16.0,
                            bstar=0.5)
    small = build_catalog(near_earth_catalog_text(1001, seed=7,
                                                  epoch_spread_days=2.0)
                          + "\n" + "\n".join(decaying), device=DEVICE)
    st = small.fast_staging
    n = len(small)
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    base = torch.linspace(-1440.0, 1440.0, 37, dtype=torch.float64,
                          device=DEVICE)
    dense = (base[:, None] - st.t_sat[None, :]
             + (torch.rand((37, n), generator=gen, dtype=torch.float64,
                           device=DEVICE) - 0.5) * 60.0)
    worst = [_dense_vs_twin(small.els, dense, small.grav,
                            f"{n} sats x 37 times (dense)",
                            codes={0, 1, 6}),
             _dense_vs_twin(small.els, base[:, None].contiguous(),
                            small.grav, f"{n} sats x 37 times (column)",
                            codes={0, 1})]
    iss = build_catalog(GOLDEN_L1 + "\n" + GOLDEN_L2, device=DEVICE)
    chunk = next(single_sat_chunks(*SINGLE_SAT_SCENARIOS[-1][1:]))
    worst.append(_dense_vs_twin(single_sat_elements(iss), chunk, iss.grav,
                                f"ISS x {tuple(chunk.shape)} (one 1year_1s "
                                "chunk)", codes={0}))
    # K5 on t_time - t_sat is K1
    kw = dict(grav=small.grav, kepler_iters=small.kepler_iters)
    k1 = cuda_sgp4.propagate_fast_sep(base, st.t_sat, st.spine, st.tail,
                                      st.flags, **kw)
    tsince = (base[:, None] - st.t_sat[None, :]).contiguous()
    k5 = cuda_sgp4.propagate_fast_dense(tsince, st.spine, st.tail, st.flags,
                                        **kw)
    sync()
    same = all(torch.equal(a, b) for a, b in zip(k1, k5))
    print(f"# phase 2c: K5 on t_time - t_sat bit-equal to K1 ({n} sats x "
          f"37 times, {small.kepler_iters} trips): {same}")
    check(same, "K5 on a separable grid differs from K1")
    return tuple(max(w[k] for w in worst) for k in range(2))


def phase3_main_path(text):
    from astroz_tpu_torch import Constellation
    from astroz_tpu_torch.ops import cuda_sgp4

    t0 = time.perf_counter()
    con = Constellation(text, device=DEVICE)
    sync()
    print(f"# phase 3: Constellation({N_SATS} TLEs) on cuda in "
          f"{time.perf_counter() - t0:.2f} s, kepler_iters "
          f"{con.catalog.kepler_iters}")
    assert con.num_deep_space == 0 and con.catalog.fast_staging.deep is None, \
        "near_earth_catalog_text made deep lanes"
    times = np.arange(float(N_TIMES))

    reset_launches()
    r_p, v_p, e_p = con.propagate(times, start_time=EPOCH_JD,
                                  layout="planes")
    n1 = dict(cuda_sgp4.LAUNCHES)
    r_e, v_e, e_e = con.propagate(times, start_time=EPOCH_JD,
                                  layout="planes", output="ecef")
    n2 = dict(cuda_sgp4.LAUNCHES)
    r_t, v_t, e_t = con.propagate(times, start_time=EPOCH_JD)
    sync()
    launches = dict(cuda_sgp4.LAUNCHES)
    print(f"# phase 3: kernel launches after each call {[n1, n2, launches]}")
    check([n["sgp4_shallow"] for n in (n1, n2, launches)] == [1, 2, 3],
          "each propagate call must launch K1 exactly once")
    check(launches["sgp4_deep"] == launches["sgp4_shallow_merge"] == 0,
          "the near-earth path launched K2 or K3")

    outs = (r_p, v_p, e_p, r_e, v_e, e_e, r_t, v_t, e_t)
    check(all(x.device.type == DEVICE for x in outs),
          "an output is not on the card")
    check(tuple(r_p.shape) == (3, N_TIMES, N_SATS)
          and tuple(r_t.shape) == (N_TIMES, N_SATS, 3)
          and tuple(e_p.shape) == (N_TIMES, N_SATS), "output shapes")
    check(all(torch.isfinite(x).all().item()
              for x in (r_p, v_p, r_e, v_e, r_t, v_t)), "non-finite output")
    check(torch.equal(e_p, e_e) and torch.equal(e_p, e_t),
          "error codes differ between calls")
    check(torch.equal(r_t, r_p.permute(1, 2, 0)),
          "time_major differs from planes")
    check(torch.equal(r_e[2], r_p[2]), "ECEF z differs from TEME z")
    # an f32 rotation keeps |r| to a few ulps (an ulp is 4.9e-4 km here)
    d_norm = (r_e.norm(dim=0) - r_p.norm(dim=0)).abs().max().item()
    check(d_norm <= 5e-3, f"ECEF rotation changed |r| by {d_norm} km")

    ok = e_p == 0
    radius = r_p.norm(dim=0)[ok]
    share = ok.float().mean().item()
    print(f"# phase 3: healthy points {share:.6f}, |r| "
          f"{radius.min().item():.1f} .. {radius.max().item():.1f} km, "
          f"error codes {sorted(set(torch.unique(e_p).tolist()))}")
    check(share > 0.9, f"only {share} of the points are healthy")
    check(radius.min().item() > LEO_BAND_KM[0]
          and radius.max().item() < LEO_BAND_KM[1], "|r| outside LEO band")

    # a 512-column sample against the plain version on the CPU
    cat = con.catalog
    st = cat.fast_staging
    cols = np.sort(np.random.default_rng(0).choice(N_SATS, SAMPLE_COLS,
                                                   replace=False))
    idx = torch.as_tensor(cols, device=DEVICE)
    jd = EPOCH_JD + times / 1440.0
    t_time = torch.as_tensor((jd - cat.epoch_min_jd) * 1440.0)
    rr, vr, er = cuda_sgp4.propagate_fast_sep_reference(
        t_time, st.t_sat[idx].cpu(), st.spine[:, idx].cpu().contiguous(),
        st.tail[:, idx].cpu().contiguous(),
        st.flags[:, idx].cpu().contiguous(), grav=cat.grav,
        kepler_iters=cat.kepler_iters)
    dr = (r_p[:, :, idx].cpu() - rr).abs().max().item()
    dv = (v_p[:, :, idx].cpu() - vr).abs().max().item()
    print(f"# phase 3: {SAMPLE_COLS} columns vs the CPU plain version: "
          f"max|dr| {dr:.3e} km, max|dv| {dv:.3e} km/s")
    check(torch.equal(e_p[:, idx].cpu(), er), "sample error codes differ")
    check(dr <= POS_TOL_KM and dv <= VEL_TOL_KMS, "sample differs")

    golden = Constellation(GOLDEN_L1 + "\n" + GOLDEN_L2, device=DEVICE)
    rg, _, eg = golden.propagate([m for m, _ in GOLDEN],
                                 start_time=golden.epochs_jd[0])
    d_gold = max(np.linalg.norm(rg[i, 0].cpu().double().numpy()
                                - np.asarray(ref))
                 for i, (_, ref) in enumerate(GOLDEN))
    print(f"# phase 3: golden trajectory max|dr| {d_gold * 1e3:.2f} m")
    check((eg == 0).all().item() and d_gold < 0.1,
          "golden trajectory off by more than 0.1 km")
    return con, launches["sgp4_shallow"]


def _golden_deep(method="fast"):
    """The GEO and Molniya golden vectors through the mixed path of
    ``method``; returns the largest distance in km."""
    from astroz_tpu_torch import Constellation

    con = Constellation(GOLDEN_DEEP_TLES, device=DEVICE)
    check(con.num_deep_space == 2
          and con.catalog.heo_escape is not None, "golden deep catalog")
    times = sorted(GOLDEN_DEEP)
    r, _, e = con.propagate(times, start_time=con.epochs_jd[0],
                            method=method)
    check((e == 0).all().item(), "golden deep lanes report errors")
    worst = 0.0
    for i, t in enumerate(times):
        for s, ref in enumerate(GOLDEN_DEEP[t]):
            known = [c for c in range(3) if ref[c] is not None]
            got = r[i, s].cpu().double().numpy()[known]
            worst = max(worst, float(np.linalg.norm(
                got - np.asarray([ref[c] for c in known]))))
    return worst


def phase3b_mixed_path(text):
    from astroz_tpu_torch import Constellation
    from astroz_tpu_torch.ops import cuda_sgp4

    t0 = time.perf_counter()
    con = Constellation(text, device=DEVICE)
    sync()
    cat = con.catalog
    esc = cat.heo_escape
    print(f"# phase 3b: Constellation({N_SATS} mixed TLEs) on cuda in "
          f"{time.perf_counter() - t0:.2f} s: {cat.n_deep} deep, "
          f"{0 if esc is None else len(esc.idx)} escape lanes, "
          f"kepler_iters {cat.kepler_iters}, deep {cat.deep_kepler_iters}")
    check(cat.n_deep == HEADLINE_DEEP and esc is not None
          and len(esc.idx) == HEADLINE_ESCAPE,
          "the headline catalog's deep and escape lanes")
    times = np.arange(float(N_TIMES))

    reset_launches()
    calls = []
    r_p, v_p, e_p = con.propagate(times, start_time=EPOCH_JD,
                                  layout="planes")
    calls.append(dict(cuda_sgp4.LAUNCHES))
    r_e, v_e, e_e = con.propagate(times, start_time=EPOCH_JD,
                                  layout="planes", output="ecef")
    calls.append(dict(cuda_sgp4.LAUNCHES))
    r_t, v_t, e_t = con.propagate(times, start_time=EPOCH_JD)
    sync()
    launches = dict(cuda_sgp4.LAUNCHES)
    calls.append(launches)
    print(f"# phase 3b: kernel launches after each call {calls}")
    check([(n["sgp4_deep"], n["sgp4_shallow_merge"]) for n in calls]
          == [(1, 1), (2, 2), (3, 3)],
          "each mixed propagate call must launch K2 and K3 exactly once")
    check(launches["sgp4_shallow"] == 0, "the mixed path launched K1")

    outs = (r_p, v_p, e_p, r_e, v_e, e_e, r_t, v_t, e_t)
    check(all(x.device.type == DEVICE for x in outs),
          "an output is not on the card")
    check(tuple(r_p.shape) == (3, N_TIMES, N_SATS)
          and tuple(r_t.shape) == (N_TIMES, N_SATS, 3), "output shapes")
    check(all(torch.isfinite(x).all().item()
              for x in (r_p, v_p, r_e, v_e, r_t, v_t)), "non-finite output")
    check(torch.equal(e_p, e_e) and torch.equal(e_p, e_t),
          "error codes differ between calls")
    check(torch.equal(r_t, r_p.permute(1, 2, 0)),
          "time_major differs from planes")

    # radius bands by kind on healthy points
    irez = np.zeros(N_SATS, np.int64)
    irez[cat.deep_idx] = np.asarray(cat.deep_host.irez)[cat.deep_idx]
    kinds = {"LEO": ~cat.is_deep, "GEO": cat.is_deep & (irez == 1),
             "GPS/HEO": cat.is_deep & (irez != 1)}
    bands = {"LEO": LEO_BAND_KM,
             "GEO": (GEO_RADIUS_KM - GEO_BAND_KM,
                     GEO_RADIUS_KM + GEO_BAND_KM),
             "GPS/HEO": HEO_BAND_KM}
    radius = r_p.norm(dim=0)
    share = (e_p == 0).float().mean().item()
    print(f"# phase 3b: healthy points {share:.6f}, error codes "
          f"{sorted(set(torch.unique(e_p).tolist()))}")
    check(share > 0.9, f"only {share} of the points are healthy")
    for kind, cols in kinds.items():
        idx = torch.as_tensor(np.nonzero(cols)[0], device=DEVICE)
        rad = radius[:, idx][e_p[:, idx] == 0]
        lo, hi = rad.min().item(), rad.max().item()
        print(f"# phase 3b: {kind}: {len(idx)} columns, healthy |r| "
              f"{lo:.1f} .. {hi:.1f} km (band {bands[kind]})")
        check(bands[kind][0] < lo and hi < bands[kind][1],
              f"{kind} |r| outside its band")

    # every column at 145 of the epochs against the plain path on the CPU
    t_idx = np.r_[0:N_TIMES:10, N_TIMES - 1]
    cpu = Constellation(text, device="cpu")
    rc, vc, ec = cpu.propagate(times[t_idx], start_time=EPOCH_JD,
                               layout="planes")
    ti = torch.as_tensor(t_idx, device=DEVICE)
    r_s, v_s, e_s = (r_p[:, ti].cpu(), v_p[:, ti].cpu(), e_p[ti].cpu())
    check(torch.equal(e_s, ec), "error codes differ from the CPU plain path")
    esc_cols = cat.deep_idx[esc.idx.cpu().numpy()]
    groups = dict(kinds)
    groups["escape"] = np.isin(np.arange(N_SATS), esc_cols)
    worst = (0.0, 0.0)
    for kind, cols in groups.items():
        c = torch.as_tensor(np.nonzero(cols)[0])
        dr = _max_diff(r_s[:, :, c], rc[:, :, c])
        dv = _max_diff(v_s[:, :, c], vc[:, :, c])
        print(f"# phase 3b: {kind} columns x {len(t_idx)} epochs vs the "
              f"CPU plain path: max|dr| {dr:.3e} km, max|dv| {dv:.3e} km/s")
        worst = (max(worst[0], dr), max(worst[1], dv))
    check(worst[0] <= POS_TOL_KM and worst[1] <= VEL_TOL_KMS,
          f"mixed path differs from the CPU plain path: {worst}")

    d_gold = _golden_deep()
    print(f"# phase 3b: GEO and Molniya golden vectors max|dr| "
          f"{d_gold * 1e3:.2f} m")
    check(d_gold < 0.1, "deep golden vectors off by more than 0.1 km")
    return con, launches


def phase3c_single_sat():
    """The single-satellite time-grid path; returns the launches of its
    run by kernel and the f64 path's largest distance from the
    python-sgp4 trajectory, km."""
    from astroz_tpu_torch import build_catalog
    from astroz_tpu_torch.ops import cuda_sgp4, sgp4_propagate

    cat = build_catalog(GOLDEN_L1 + "\n" + GOLDEN_L2, device=DEVICE)
    els = single_sat_elements(cat)
    golden = dict(GOLDEN)
    gold_f64 = gold_fast = 0.0
    reset_launches()
    n_chunks = 0
    for name, n_points, step_s in SINGLE_SAT_SCENARIOS:
        worst = bad = total = 0
        lo, hi = float("inf"), 0.0
        for t in single_sat_chunks(n_points, step_s):
            n_chunks += 1
            r, v, e = cuda_sgp4.propagate_fast_fused(els, t, cat.grav,
                                                     kepler_iters=5)
            k6 = cuda_sgp4.propagate_fast_grids(els, t, cat.grav,
                                                kepler_iters=5)
            r64, v64, e64 = sgp4_propagate(els, t, cat.grav)
            check(all(x.device.type == DEVICE and torch.isfinite(x).all()
                      for x in (r, v, r64, v64)),
                  f"{name}: non-finite or off-card output")
            check(tuple(r.shape) == tuple(t.shape) + (3,), f"{name}: shape")
            check(all(torch.equal(a, b) for a, b in zip(k6, (r, v, e))),
                  f"{name}: K6 differs from K5")
            check(torch.equal(e, e64), f"{name}: fast and f64 error codes "
                  "differ")
            ok = e == 0
            bad += int((~ok).sum())
            total += e.numel()
            rad = torch.cat([r.norm(dim=-1)[ok], r64.norm(dim=-1)[ok]])
            if rad.numel():
                lo = min(lo, rad.min().item())
                hi = max(hi, rad.max().item())
                worst = max(worst, (r.double() - r64).norm(dim=-1)[ok]
                            .max().item())
            for m, ref in golden.items():
                hit = (t == m) & ok
                if step_s == 60.0 and hit.any():
                    ref = torch.tensor(ref, dtype=torch.float64,
                                       device=DEVICE)
                    gold_f64 = max(gold_f64,
                                   (r64[hit] - ref).norm(dim=-1).max().item())
                    gold_fast = max(gold_fast, (r[hit].double() - ref)
                                    .norm(dim=-1).max().item())
        sync()
        print(f"# phase 3c: {name} ({n_points} points, padded to "
              f"{total}): error codes non-zero on {bad / total:.6f} of the "
              f"points; healthy |r| {lo:.1f} .. {hi:.1f} km; fast vs f64 "
              f"max {worst * 1e3:.3f} m")
        check(LEO_BAND_KM[0] < lo and hi < LEO_BAND_KM[1],
              f"{name}: |r| outside the LEO band")
        if name in SINGLE_SAT_GATE_KM:
            check(bad == 0, f"{name}: error codes set")
            check(worst < SINGLE_SAT_GATE_KM[name],
                  f"{name}: fast is {worst} km from f64")
    n = launches()
    print(f"# phase 3c: {n_chunks} chunks, kernel launches {n}; the "
          f"python-sgp4 trajectory: f64 max|dr| {gold_f64 * 1e3:.3f} m, "
          f"fast {gold_fast * 1e3:.3f} m")
    check(n["sgp4_shallow_dense"] == n["sgp4_shallow_grids"] == n_chunks
          and sum(n.values()) == 2 * n_chunks,
          "each chunk must launch K5 once and K6 once, and nothing else")
    check(gold_f64 < 0.1, "the f64 path is off the python-sgp4 trajectory")
    return n


def phase3d_f64_path(mcon):
    """The f64 main path; returns the milliseconds of its scan_times call
    (host clock around synchronized work) and that call's peak device
    memory in bytes."""
    from astroz_tpu_torch import propagate, propagate_tsince
    from astroz_tpu_torch.ops import sdp4_propagate

    cat = mcon.catalog
    times = np.arange(float(N_TIMES))
    kw = dict(start_time=EPOCH_JD, method="f64")
    reset_launches()
    r_p, v_p, e_p = mcon.propagate(times, layout="planes", **kw)
    r_t, v_t, e_t = mcon.propagate(times, **kw)
    sync()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # Constellation.propagate has no scan_times (nor has the JAX one)
    r_s, v_s, e_s = propagate(cat, EPOCH_JD + times / 1440.0,
                              layout="planes", scan_times=True,
                              method="f64")
    sync()
    scan_ms = (time.perf_counter() - t0) * 1e3
    scan_peak = torch.cuda.max_memory_allocated()
    n = launches()
    print(f"# phase 3d: f64 propagate of {N_SATS} mixed x {N_TIMES}: planes, "
          f"time_major and scan_times=True ({scan_ms:.1f} ms); kernel "
          f"launches {n}")
    check(sum(n.values()) == 0, "the f64 path launched a kernel")
    outs = (r_p, v_p, r_t, v_t, r_s, v_s)
    check(all(x.device.type == DEVICE and x.dtype == torch.float64
              and torch.isfinite(x).all().item() for x in outs),
          "f64 outputs: device, type or finiteness")
    check(tuple(r_p.shape) == (3, N_TIMES, N_SATS)
          and tuple(r_t.shape) == (N_TIMES, N_SATS, 3), "f64 output shapes")
    check(torch.equal(e_p, e_t) and torch.equal(e_p, e_s),
          "f64 error codes differ between calls")
    check(torch.equal(r_t, r_p.permute(1, 2, 0)),
          "f64 time_major differs from planes")
    d_scan = _max_diff(r_s, r_p)
    dv_scan = _max_diff(v_s, v_p)
    print(f"# phase 3d: scan vs dense max|dr| {d_scan:.3e} km, max|dv| "
          f"{dv_scan:.3e} km/s")
    check(d_scan <= 1e-6 and dv_scan <= 1e-9, "scan differs from dense")
    del r_t, v_t, r_s, v_s

    r_f, _, e_f = mcon.propagate(times, start_time=EPOCH_JD,
                                 layout="planes", velocities=False)
    check(torch.equal(e_f, e_p), "fast and f64 error codes differ")
    ok = e_p == 0
    dist = (r_f.double() - r_p).norm(dim=0).masked_fill(~ok, 0.0)
    del r_f
    lane_worst = dist.amax(dim=0).cpu().numpy()
    irez = np.asarray(cat.deep_host.irez)
    escape = np.isin(np.arange(N_SATS),
                     cat.deep_idx[cat.heo_escape.idx.cpu().numpy()])
    regimes = {"LEO": ~cat.is_deep, "GEO": irez == 1,
               "half-day": (irez == 2) & ~escape,
               "other deep": cat.is_deep & (irez == 0), "escape": escape}
    share = ok.float().mean().item()
    print(f"# phase 3d: fast vs f64 on healthy points ({share:.6f} of them), "
          "worst lane by regime: " + ", ".join(
              f"{k} {lane_worst[m].max() * 1e3:.3f} m (lane "
              f"{np.nonzero(m)[0][lane_worst[m].argmax()]}, "
              f"e {cat.host.ecco[m][lane_worst[m].argmax()]:.4f})"
              for k, m in regimes.items()))
    # near-earth lanes at the JAX package's 50 m; deep lanes at the
    # reference's 100 m budget (README.md): its f32 deep tail is ~60 m
    # off on half-day lanes just under the escape's e > 0.7
    check(lane_worst[regimes["LEO"]].max() < 0.05,
          "near-earth lanes over 0.05 km from f64")
    check(lane_worst.max() < 0.1, "fast is over 0.1 km from f64")
    check(lane_worst[escape].max() < 5e-3,
          "escape lanes over 5e-3 km from f64")

    d_gold = _golden_deep("f64")
    print(f"# phase 3d: GEO and Molniya golden vectors through f64 max|dr| "
          f"{d_gold * 1e3:.3f} m")
    check(d_gold < 0.01, "f64 deep golden vectors off by more than 0.01 km")
    t = torch.linspace(0.0, 1440.0, 16, dtype=torch.float64,
                       device=DEVICE)[:, None]
    a = propagate_tsince(cat, t)
    b = sdp4_propagate(cat.els, cat.deep, t, cat.grav)
    check(all(torch.equal(x, y) for x, y in zip(a, b[:3])),
          "propagate_tsince differs from sdp4_propagate")
    print("# phase 3d: propagate_tsince on a (16, 1) grid equals "
          "sdp4_propagate bit for bit")
    return scan_ms, scan_peak


def _cuda_ms(fn, reps, warm=True):
    if warm:
        fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def _in_turns(kernel, plain, reps_kernel, reps_plain):
    """plain, kernel, kernel, plain; returns the two means and the four
    times."""
    p1, k1, k2, p2 = (_cuda_ms(plain, reps_plain),
                      _cuda_ms(kernel, reps_kernel),
                      _cuda_ms(kernel, reps_kernel),
                      _cuda_ms(plain, reps_plain))
    return (k1 + k2) / 2, (p1 + p2) / 2, (p1, k1, k2, p2)


def phase4_timings(con, smi):
    from astroz_tpu_torch.ops import cuda_sgp4

    cat = con.catalog
    st = cat.fast_staging
    t_time = torch.arange(N_TIMES, dtype=torch.float64, device=DEVICE)
    args = (t_time, st.t_sat, st.spine, st.tail, st.flags)
    kw = dict(grav=cat.grav, kepler_iters=cat.kepler_iters)
    k_ms, p_ms, turns = _in_turns(
        lambda: cuda_sgp4.propagate_fast_sep(*args, **kw),
        lambda: cuda_sgp4.propagate_fast_sep_reference(*args, **kw), 20, 3)
    times = np.arange(float(N_TIMES))
    call_planes = _cuda_ms(lambda: con.propagate(
        times, start_time=EPOCH_JD, layout="planes"), 10)
    call_tm = _cuda_ms(lambda: con.propagate(times, start_time=EPOCH_JD), 10)
    props = N_SATS * N_TIMES
    print(f"# phase 4 [{smi}]: kernel K1 {k_ms:.4f} ms "
          f"({turns[1]:.4f}, {turns[2]:.4f}; "
          f"{props / k_ms / 1e6:.3f} G props/s)")
    print(f"# phase 4 [{smi}]: K1 plain torch version {p_ms:.4f} ms "
          f"({turns[0]:.4f}, {turns[3]:.4f})")
    print(f"# phase 4 [{smi}]: near-earth propagate() planes "
          f"{call_planes:.4f} ms, time_major {call_tm:.4f} ms")
    print(f"# phase 4: peak device memory so far "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    ops = count_ops(lambda: cuda_sgp4.propagate_fast_sep_reference(*args,
                                                                   **kw))
    k1_bound = bound(nbytes(*args, *cuda_sgp4.propagate_fast_sep(*args, **kw)),
                     *ops)
    print(f"# phase 4: K1 bound {k1_bound[0]:.4f} ms by {k1_bound[1]} "
          f"({ops[0] / props:.1f} f32 and {ops[1] / props:.1f} f64 "
          f"operations a point in its plain version)")
    return k_ms, p_ms, k1_bound


def phase4b_mixed_timings(con, smi):
    from astroz_tpu_torch.ops import cuda_sgp4, fast
    from astroz_tpu_torch.propagation import _apply_escape, resonance_steps

    cat = con.catalog
    st, ds = cat.fast_staging, cat.fast_staging.deep
    times = np.arange(float(N_TIMES))
    t_time = torch.as_tensor(times, dtype=torch.float64, device=DEVICE)
    steps = resonance_steps(EPOCH_JD + times / 1440.0, cat.deep_epochs_jd)
    tables = cat.resonance_tables(steps)
    dargs = (t_time, ds.t_sat, ds.spine, ds.tail, ds.flags, tables)
    dkw = dict(grav=cat.grav, kepler_iters=cat.deep_kepler_iters)
    k2_ms, k2_plain, k2_turns = _in_turns(
        lambda: cuda_sgp4.propagate_deep_sep(*dargs, **dkw),
        lambda: cuda_sgp4.propagate_deep_sep_reference(*dargs, **dkw),
        50, 3)
    dr, dv, de = cuda_sgp4.propagate_deep_sep(*dargs, **dkw)
    esc_ms = _cuda_ms(lambda: _apply_escape(
        cat.heo_escape, cat.escape_tables(steps), t_time, cat.grav, True,
        dr, dv, de), 10)
    margs = (t_time, st.t_sat, st.spine, st.tail, st.flags, ds.slot, dr, dv,
             de)
    mkw = dict(grav=cat.grav, kepler_iters=cat.kepler_iters)
    k3_ms, k3_plain, k3_turns = _in_turns(
        lambda: cuda_sgp4.propagate_fast_sep_merge(*margs, **mkw),
        lambda: cuda_sgp4.propagate_fast_sep_merge_reference(*margs, **mkw),
        20, 3)
    tables_ms = _cuda_ms(lambda: fast.resonance_tables(
        cat.deep_sub, cat.els_deep, steps), 3)
    call_planes = _cuda_ms(lambda: con.propagate(
        times, start_time=EPOCH_JD, layout="planes"), 10)
    call_tm = _cuda_ms(lambda: con.propagate(times, start_time=EPOCH_JD), 10)
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = con.propagate(times, start_time=EPOCH_JD)
    sync()
    peak = torch.cuda.max_memory_allocated()
    del out
    props = N_SATS * N_TIMES
    print(f"# phase 4b [{smi}]: kernel K2 {k2_ms:.4f} ms "
          f"({k2_turns[1]:.4f}, {k2_turns[2]:.4f}; {cat.n_deep} x "
          f"{N_TIMES}), plain torch version {k2_plain:.4f} ms "
          f"({k2_turns[0]:.4f}, {k2_turns[3]:.4f})")
    print(f"# phase 4b [{smi}]: kernel K3 {k3_ms:.4f} ms "
          f"({k3_turns[1]:.4f}, {k3_turns[2]:.4f}; "
          f"{props / k3_ms / 1e6:.3f} G props/s), plain torch version "
          f"{k3_plain:.4f} ms ({k3_turns[0]:.4f}, {k3_turns[3]:.4f})")
    print(f"# phase 4b [{smi}]: HEO escape ({len(cat.heo_escape.idx)} "
          f"lanes, plain f64 torch) {esc_ms:.4f} ms; resonance tables "
          f"(depth {steps}, once per catalog and depth) {tables_ms:.4f} ms")
    print(f"# phase 4b [{smi}]: mixed propagate() planes {call_planes:.4f} "
          f"ms ({props / call_planes / 1e6:.3f} G props/s), time_major "
          f"{call_tm:.4f} ms")
    print(f"# phase 4b: device memory of a time-major mixed sweep: peak "
          f"{peak / 2**30:.3f} GiB, of which {base / 2**30:.3f} GiB were "
          f"held before the call")
    k2_ops = count_ops(lambda: cuda_sgp4.propagate_deep_sep_reference(
        *dargs, **dkw))
    k2_bound = bound(nbytes(*dargs, dr, dv, de), *k2_ops)
    # K3 runs K1's tail on the near-earth columns only and copies the
    # deep ones
    k1_ops = count_ops(lambda: cuda_sgp4.propagate_fast_sep_reference(
        *margs[:5], **mkw))
    near = (N_SATS - cat.n_deep) / N_SATS
    k3_bound = bound(nbytes(*margs, *cuda_sgp4.propagate_fast_sep_merge(
        *margs, **mkw)), k1_ops[0] * near, k1_ops[1] * near)
    print(f"# phase 4b: K2 bound {k2_bound[0]:.4f} ms by {k2_bound[1]} "
          f"({k2_ops[0] / (cat.n_deep * N_TIMES):.1f} f32 and "
          f"{k2_ops[1] / (cat.n_deep * N_TIMES):.1f} f64 operations a "
          f"point); K3 bound {k3_bound[0]:.4f} ms by {k3_bound[1]}")
    return (k2_ms, k2_plain, k2_bound), (k3_ms, k3_plain, k3_bound)


def _same_or_both_nan(a, b):
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _k4_vs_twin(r, chunks, label):
    """K4's column chunks ``(j0, dmin)`` against its plain version on the
    same columns, bit for bit on every entry (NaN where it is NaN, +inf at
    and below the diagonal); returns the largest difference on the
    entries finite in both."""
    from astroz_tpu_torch.ops import cuda_screen

    worst = 0.0
    for j0, dmin in chunks:
        w = dmin.shape[1]
        ref = cuda_screen.coarse_min_chunk_reference(r, j0, w)
        check(_same_or_both_nan(dmin, ref),
              f"K4 {label} columns {j0}..{j0 + w}: differs from its plain "
              "version")
        fin = torch.isfinite(dmin) & torch.isfinite(ref)
        worst = max(worst, _max_diff(dmin[fin], ref[fin]))
        del ref, fin
    return worst


def _k4_pairs_vs_twin(r, thr2, label, **kw):
    """K4's candidate mode against its plain version (in PLAIN_COLS-column
    chunks), the same (i, j) pairs in order. Returns the plain pairs and
    the largest |kernel - plain| over their i and j indices."""
    from astroz_tpu_torch.ops import cuda_screen

    got = cuda_screen.coarse_candidates(r, thr2, **kw)
    ref = cuda_screen.coarse_candidates_reference(
        r, thr2, max_bytes=4 * r.shape[2] * PLAIN_COLS)
    check(len(got[0]) == len(ref[0]),
          f"K4 candidates {label}: {len(got[0])} pairs, the plain version "
          f"{len(ref[0])}")
    err = ((torch.stack(got) - torch.stack(ref)).abs().max().item()
           if len(ref[0]) else 0)
    check(err == 0, f"K4 candidates {label}: pairs differ from the plain "
          f"version's (largest index difference {err})")
    return ref, float(err)


def _plain_peak_per_entry(r, j0, width):
    """Device bytes the plain matrix version held at its peak beside its
    output, for each entry of the one (rows, width) block it computes
    (``width`` under a column block of PLAIN_WORK_BYTES)."""
    from astroz_tpu_torch.ops import cuda_screen

    n = r.shape[2]
    rows = min(n, j0 + width - 1)
    check(width * rows * cuda_screen.PLAIN_BYTES_PER_ENTRY
          <= cuda_screen.PLAIN_WORK_BYTES["cuda"],
          "the chunk must be one column block")
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = cuda_screen.coarse_min_chunk_reference(r, j0, width)
    sync()
    held = torch.cuda.max_memory_allocated() - base - out.numel() * 4
    return held / (rows * width)


def phase5_coarse_vs_twin(shell_con):
    """K4 against its plain version in both modes. Returns the largest
    matrix difference at the main path's shape and the launches of the
    matrix path, ``coarse_min_all`` of the 13,478 x 240 planes."""
    from astroz_tpu_torch import build_catalog
    from astroz_tpu_torch.ops import cuda_screen
    from astroz_tpu_torch.screening import _positions_planes_f32
    from astroz_tpu_torch.tle import format_lines

    # 1,000 shell lanes and two that have decayed by the shell's epoch
    decayed = [format_lines(satnum=99990 + k, epoch_jd=SCREEN_EPOCH_JD - 2.0,
                            ecco=5e-4, inclo_deg=53.0, nodeo_deg=10.0 * k,
                            argpo_deg=20.0, mo_deg=30.0, no_rev_day=16.0,
                            bstar=0.5) for k in range(2)]
    small = build_catalog(screening_shell_text(1000) + "\n"
                          + "\n".join(ln for pair in decayed for ln in pair),
                          device=DEVICE)
    r = _positions_planes_f32(small, SCREEN_EPOCH_JD
                              + np.arange(100.0) / 1440.0)
    n = r.shape[2]
    parked = int((r[0, 0] >= 0.5e7).sum())
    r[1, 50, 500] = float("nan")
    check(parked == 2, f"{parked} parked lanes, expected the 2 decayed ones")
    single = list(cuda_screen.coarse_min_all(r))
    chunked = list(cuda_screen.coarse_min_all(r, max_bytes=4 * n * 300))
    check(len(single) == 1 and len(chunked) == 4,
          f"{len(single)} and {len(chunked)} column chunks, expected 1 and 4")
    check(bool(torch.isnan(single[0][1]).any()), "the NaN position is lost")
    label = f"{n} sats x 100 times"
    worst = _k4_vs_twin(r, single, label)
    worst = max(worst, _k4_vs_twin(r, chunked, label + ", 4 chunks"))
    check(_same_or_both_nan(torch.cat([d for _, d in chunked], dim=1),
                            single[0][1]),
          "chunked K4 differs from the single shot")
    # candidate mode on the same planes at 200 km, once with room for all
    # pairs and once through the overflow path (cap=1: two launches)
    thr2_small = float(np.float32(200.0 ** 2))
    before = cuda_screen.LAUNCHES["screen_candidates"]
    small_pairs, _ = _k4_pairs_vs_twin(r, thr2_small, label)
    _k4_pairs_vs_twin(r, thr2_small, label + ", cap=1", cap=1)
    sync()
    check(cuda_screen.LAUNCHES["screen_candidates"] == before + 3,
          "candidate mode: the overflow path must launch twice")
    check(len(small_pairs[0]) > 0, "no candidate pairs within 200 km")

    # the main path's shape: matrix mode (coarse_min_all, one chunk of all
    # 13,478 columns) held against the plain version on K4_SAMPLE_BLOCKS,
    # and candidate mode at the screen's 10 km against the plain version
    # on every column
    full = _positions_planes_f32(shell_con.catalog, SCREEN_EPOCH_JD
                                 + np.arange(SCREEN_TIMES) / 1440.0)
    nf = full.shape[2]
    ((j0, dmin),) = cuda_screen.coarse_min_all(full)
    check(j0 == 0 and tuple(dmin.shape) == (nf, nf),
          f"coarse_min_all's K4 chunk is {j0}, {tuple(dmin.shape)}")
    worst_full = _k4_vs_twin(
        full, [(c0, dmin[:, c0:c0 + w]) for c0, w in K4_SAMPLE_BLOCKS],
        f"{N_SATS} sats x {SCREEN_TIMES} times")
    thr2 = float(np.float32((SCREEN_KM * (1.0 + 1.0e-6)) ** 2))
    ci, cj = cuda_screen.coarse_candidates(full, thr2)
    check(torch.equal(torch.stack([ci, cj], 1), torch.nonzero(dmin <= thr2)),
          "candidate mode differs from the thresholded matrix")
    del dmin
    full_pairs, cand_err = _k4_pairs_vs_twin(full, thr2,
                                             f"{N_SATS} x {SCREEN_TIMES}")
    # the plain version's working set, measured on the one-block chunk of
    # the middle sample (its rows above the chunk's last column)
    per_entry = _plain_peak_per_entry(full, *K4_SAMPLE_BLOCKS[1])
    check(per_entry <= cuda_screen.PLAIN_BYTES_PER_ENTRY,
          f"the plain matrix version held {per_entry:.1f} B an entry, over "
          f"its PLAIN_BYTES_PER_ENTRY {cuda_screen.PLAIN_BYTES_PER_ENTRY}")
    print(f"# phase 5: K4 matrix mode vs its plain version, bit-equal on "
          f"every entry checked: {label} ({parked} parked lanes, one NaN) "
          f"single-shot and in 4 chunks, max |d2 diff| {worst:.3e} km^2; "
          f"{N_SATS} x {SCREEN_TIMES} (coarse_min_all's one chunk) on column "
          f"blocks {K4_SAMPLE_BLOCKS}, max |d2 diff| {worst_full:.3e} km^2")
    print(f"# phase 5: K4 candidate mode equals its plain version: {label} "
          f"at 200 km ({len(small_pairs[0])} pairs, also with cap=1), "
          f"{N_SATS} x {SCREEN_TIMES} at {SCREEN_KM} km ({len(full_pairs[0])} "
          f"pairs, largest index difference {cand_err:.0f}, equal to the "
          f"thresholded matrix too)")
    print(f"# phase 5: the plain matrix version held {per_entry:.2f} B of "
          f"device memory an entry beside its output (at most "
          f"{cuda_screen.PLAIN_BYTES_PER_ENTRY}, its column blocks' rule)")
    return worst_full, cand_err, full_pairs


def _check_pairs(res, label):
    ci, cj, d, t = res
    check([x.dtype for x in res] == [np.int64, np.int64, np.float64,
                                     np.int64],
          f"{label}: output types {[x.dtype for x in res]}")
    check(len(ci) > 0, f"{label}: no pairs")
    check(bool((ci < cj).all() and (cj < N_SATS).all() and (d < SCREEN_KM).all()
               and (d >= 0).all() and (t >= 0).all()
               and (t < SCREEN_TIMES).all()), f"{label}: pair bounds")
    check(bool((np.lexsort((cj, ci)) == np.arange(len(ci))).all()),
          f"{label}: pairs not in (i, j) order")


def _plain_screen(cat, jd, plain_pairs=None):
    """The screen with K4 replaced by its plain candidate version on the
    card (column chunks of PLAIN_COLS), or by ``plain_pairs`` where phase
    5 already ran it on these planes, then the same refine."""
    from astroz_tpu_torch.ops import cuda_screen
    from astroz_tpu_torch.screening import (_positions_planes_f32,
                                            _screen_planes)

    r = _positions_planes_f32(cat, jd)

    def coarse(planes, thr2):
        if plain_pairs is not None:
            return plain_pairs
        return cuda_screen.coarse_candidates_reference(
            planes, thr2, max_bytes=4 * planes.shape[2] * PLAIN_COLS)

    return _screen_planes(r, SCREEN_KM, 10_000_000, coarse=coarse)


def _screen_vs_plain(cat, jd, res, label, plain_pairs=None):
    ref = _plain_screen(cat, jd, plain_pairs)
    check(np.array_equal(res[0], ref[0]) and np.array_equal(res[1], ref[1]),
          f"{label}: the pair set differs from the plain coarse version's")
    check(np.array_equal(res[3], ref[3]), f"{label}: epoch indices differ")
    dd = float(np.abs(res[2] - ref[2]).max())
    check(dd <= 1e-6, f"{label}: distances differ by {dd} km")
    return dd


def phase6_screen(con, plain_pairs):
    """The shell screen; ``plain_pairs`` are phase 5's plain candidates of
    the same planes at the same threshold."""
    check(len(con) == N_SATS and not con.catalog.has_deep,
          "the screening shell")
    times = np.arange(float(SCREEN_TIMES))
    reset_launches()
    t0 = time.perf_counter()
    res = con.screen(times, start_time=SCREEN_EPOCH_JD,
                     threshold_km=SCREEN_KM)
    wall = time.perf_counter() - t0
    n = launches()
    print(f"# phase 6: screen of {N_SATS} x {SCREEN_TIMES} at {SCREEN_KM} "
          f"km (first call, {wall:.3f} s): {len(res[0])} pairs, kernel "
          f"launches {n}")
    check(n == {**dict.fromkeys(n, 0), "sgp4_shallow": 1,
                "screen_candidates": 1},
          "the screen must launch K1 once and K4 (candidate mode) once")
    _check_pairs(res, "shell screen")
    dd = _screen_vs_plain(con.catalog, SCREEN_EPOCH_JD + times / 1440.0, res,
                          "shell screen", plain_pairs)
    print(f"# phase 6: the pairs, epochs and distances (max diff {dd:.1e} "
          f"km) of the plain coarse version; closest pair "
          f"{res[2].min():.4f} km")
    return n


def phase6b_mixed_screen(mcon):
    from astroz_tpu_torch import Constellation, screen_all, screen_target
    from astroz_tpu_torch.ops.fastmath import sqrt_rn

    cat = mcon.catalog
    times = np.arange(float(SCREEN_TIMES))
    jd = EPOCH_JD + times / 1440.0
    reset_launches()
    res = screen_all(cat, jd, threshold_km=SCREEN_KM)
    n = launches()
    print(f"# phase 6b: screen of the mixed catalog x {SCREEN_TIMES} at "
          f"{SCREEN_KM} km: {len(res[0])} pairs, kernel launches {n}")
    check(n == {**dict.fromkeys(n, 0), "sgp4_deep": 1,
                "sgp4_shallow_merge": 1, "screen_candidates": 1},
          "the mixed screen must launch K2, K3 and K4 (candidate mode) "
          "once each")
    _check_pairs(res, "mixed screen")
    dd = _screen_vs_plain(cat, jd, res, "mixed screen")

    tgt = GOLDEN_L1 + "\n" + GOLDEN_L2
    min_d, t_idx, mask = screen_target(cat, tgt, jd, threshold_km=1000.0)
    r, _, err = mcon.propagate(times, start_time=EPOCH_JD, layout="planes",
                               velocities=False)
    rt, _, et = Constellation(tgt, device=DEVICE).propagate(
        times, start_time=EPOCH_JD, layout="planes", velocities=False)
    healthy = (err == 0).all(dim=0)
    check(bool((et == 0).all()) and healthy.float().mean().item() > 0.9,
          "target or catalog lanes failed")
    dx, dy, dz = r - rt
    direct_d, direct_t = sqrt_rn(dx * dx + dy * dy + dz * dz).min(dim=0)
    d64 = ((r.double() - rt.double()) ** 2).sum(dim=0).sqrt().amin(dim=0)
    d64_diff = (min_d - d64)[healthy].abs().max().item()
    check(torch.equal(min_d[healthy], direct_d[healthy])
          and torch.equal(t_idx[healthy], direct_t[healthy])
          and torch.equal(mask, min_d < 1000.0),
          "screen_target differs from the direct reduction")
    check(d64_diff <= 0.01, f"screen_target is {d64_diff} km from f64")
    print(f"# phase 6b: the pairs, epochs and distances (max diff {dd:.1e} "
          f"km) of the plain coarse version; screen_target of the ISS "
          f"golden TLE: {int(healthy.sum())} healthy lanes equal the direct "
          f"reduction (min {min_d[healthy].min().item():.3f} km, "
          f"{int(mask.sum())} within 1000 km), {d64_diff:.2e} km from its "
          f"f64 form")


def _max_sm_clock_hz():
    """The card's largest SM clock, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def phase7_screen_timings(con, smi):
    """Times of K4's two modes and their plain versions, the screen's
    pieces and the whole screen; returns the matrix and candidate entries
    ``(ms, plain_ms, (bound_ms, bound_by), library_ms)``."""
    from astroz_tpu_torch import _build, build_catalog, screen_target
    from astroz_tpu_torch.ops import cuda_screen
    from astroz_tpu_torch.screening import _positions_planes_f32, _refine

    cat = con.catalog
    times = np.arange(float(SCREEN_TIMES))
    jd = SCREEN_EPOCH_JD + times / 1440.0
    r = _positions_planes_f32(cat, jd)
    n = r.shape[2]
    thr2 = float(np.float32((SCREEN_KM * (1.0 + 1.0e-6)) ** 2))
    count = torch.zeros(1, dtype=torch.int64, device=DEVICE)

    def candidates_kernel():
        count.zero_()
        cuda_screen._launch_candidates(r, thr2, cuda_screen.CANDIDATE_CAP,
                                       count)

    def plain_matrix():
        return [cuda_screen.coarse_min_chunk_reference(
            r, j0, min(PLAIN_COLS, n - j0)) for j0 in range(0, n, PLAIN_COLS)]

    def plain_candidates():
        return cuda_screen.coarse_candidates_reference(
            r, thr2, max_bytes=4 * n * PLAIN_COLS)

    # in turns: plain, matrix, candidates, candidates, matrix, plain
    turns = [_cuda_ms(plain_candidates, 1, warm=False),
             _cuda_ms(lambda: cuda_screen.coarse_min_chunk(r, 0, n), 10),
             _cuda_ms(candidates_kernel, 10), _cuda_ms(candidates_kernel, 10),
             _cuda_ms(lambda: cuda_screen.coarse_min_chunk(r, 0, n), 10),
             _cuda_ms(plain_matrix, 1, warm=False)]
    mat_ms, cand_ms = (turns[1] + turns[4]) / 2, (turns[2] + turns[3]) / 2
    r_tm = r.permute(1, 2, 0).contiguous()           # (T, N, 3)
    r_cols = r_tm[:, :CDIST_COLS].contiguous()
    cdist_chunk = _cuda_ms(lambda: torch.cdist(
        r_tm, r_cols, compute_mode="donot_use_mm_for_euclid_dist").amin(0), 3)
    library_ms = cdist_chunk * n / CDIST_COLS
    del r_tm, r_cols

    ii, jj = cuda_screen.coarse_candidates(r, thr2)
    prop_ms = _cuda_ms(lambda: _positions_planes_f32(cat, jd), 10)
    wrapper_ms = _cuda_ms(lambda: cuda_screen.coarse_candidates(r, thr2), 10)
    refine_ms = _cuda_ms(lambda: _refine(r, ii, jj), 10)

    def call():
        return con.screen(times, start_time=SCREEN_EPOCH_JD,
                          threshold_km=SCREEN_KM)

    call_ms = _cuda_ms(call, 10)
    walls = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        call()
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    iss = build_catalog(GOLDEN_L1 + "\n" + GOLDEN_L2, device=DEVICE)
    target_ms = _cuda_ms(lambda: screen_target(cat, iss, jd,
                                               threshold_km=SCREEN_KM), 10)
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    call()
    sync()
    peak = torch.cuda.max_memory_allocated()

    # the work this run needs: the strict upper triangle's pair-times
    pair_times = SCREEN_TIMES * n * (n - 1) // 2
    ops = K4_OPS * pair_times
    mat_bound = bound(nbytes(r) + 4 * n * n, ops, 0)
    cand_bound = bound(nbytes(r) + 8 * len(ii), ops, 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = _max_sm_clock_hz()
    floor_ms = (K4_INSTRUCTIONS * pair_times
                / (sms * LANES_PER_SM * clock) * 1e3)
    regs = [(name, rg, st, ld) for name, rg, st, ld in _build.ptxas_report()
            if "screen_coarse" in name]
    check(all(st == ld == 0 for _, _, st, ld in regs), f"K4 spills: {regs}")
    for ms, bd, label in ((mat_ms, mat_bound, "matrix"),
                          (cand_ms, cand_bound, "candidate")):
        print(f"# phase 7 [{smi}]: K4 {label} mode {ms:.4f} ms "
              f"({pair_times:.4g} pair-times, "
              f"{pair_times / ms / 1e9:.2f} T pair-times/s): "
              f"{bd[0] / ms:.1%} of the {bd[0]:.4f} ms bound "
              f"({K4_OPS} f32 operations a pair-time, by {bd[1]}), "
              f"{floor_ms / ms:.1%} of the {floor_ms:.4f} ms FMA floor "
              f"({K4_INSTRUCTIONS} instructions a pair-time, {sms} SMs x "
              f"{LANES_PER_SM} lanes at {clock / 1e9:.3f} GHz)")
    print(f"# phase 7 [{smi}]: K4 in turns (plain candidates, matrix, "
          f"candidates, candidates, matrix, plain matrix): "
          f"{', '.join(f'{t:.4f}' for t in turns)} ms; plain versions in "
          f"{PLAIN_COLS}-column chunks; cdist yardstick {cdist_chunk:.4f} ms "
          f"for {CDIST_COLS} columns, {library_ms:.4f} ms scaled to all {n}")
    print("# phase 7: ptxas for K4: " + "; ".join(
        f"{'candidate' if 'ILb1' in name else 'matrix'} mode {rg} registers, "
        f"spill stores {st} B, spill loads {ld} B"
        for name, rg, st, ld in regs))
    print(f"# phase 7 [{smi}]: screen() pieces: propagate to planes "
          f"{prop_ms:.4f} ms, K4 candidate kernel {cand_ms:.4f} ms, its "
          f"wrapper (count fetch, sort) {wrapper_ms:.4f} ms ({len(ii)} "
          f"candidates), refine {refine_ms:.4f} ms; whole call {call_ms:.4f} "
          f"ms (CUDA events), {', '.join(f'{w:.3f}' for w in walls)} ms "
          f"(wall clock, synchronized)")
    print(f"# phase 7 [{smi}]: screen_target of one TLE vs {n} x "
          f"{SCREEN_TIMES} {target_ms:.4f} ms; device memory of a screen: "
          f"peak {peak / 2**30:.3f} GiB, of which {base / 2**30:.3f} GiB were "
          f"held before the call")
    return ((mat_ms, turns[5], mat_bound, library_ms),
            (cand_ms, turns[0], cand_bound, None))


def _peak(fn):
    """Run ``fn`` once; the peak device memory it took, in GiB, over what
    was held before."""
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    sync()
    return (torch.cuda.max_memory_allocated() - base) / 2**30


def phase4c_dense_timings(mcon, smi, scan_ms, scan_peak):
    from astroz_tpu_torch import build_catalog
    from astroz_tpu_torch.ops import cuda_sgp4, sgp4_propagate
    from astroz_tpu_torch.ops.fast import shallow_staging

    cat = build_catalog(GOLDEN_L1 + "\n" + GOLDEN_L2, device=DEVICE)
    els = single_sat_elements(cat)
    _, n_year, step_year = SINGLE_SAT_SCENARIOS[-1]
    t = next(single_sat_chunks(n_year, step_year))
    staged = shallow_staging(els)
    kw = dict(grav=cat.grav, kepler_iters=5)
    k5_ms, k5_plain, k5_turns = _in_turns(
        lambda: cuda_sgp4.propagate_fast_dense(t, *staged, **kw),
        lambda: cuda_sgp4.propagate_fast_dense_reference(t, *staged, **kw),
        50, 3)
    grids, tail, flags = cuda_sgp4.spine_grids(els, t)
    k6_ms, k6_plain, k6_turns = _in_turns(
        lambda: cuda_sgp4.propagate_fast_spine_grids(grids, tail, flags,
                                                     **kw),
        lambda: cuda_sgp4.propagate_fast_spine_grids_reference(
            grids, tail, flags, **kw), 50, 3)
    spine_ms = _cuda_ms(lambda: cuda_sgp4.spine_grids(els, t), 10)
    props = t.numel()

    def sweep(fn):
        for chunk in single_sat_chunks(n_year, step_year):
            fn(els, chunk, cat.grav)

    def fast(e, chunk, grav):
        return cuda_sgp4.propagate_fast_fused(e, chunk, grav, kepler_iters=5)

    year_fast = _cuda_ms(lambda: sweep(fast), 5)
    year_f64 = _cuda_ms(lambda: sweep(sgp4_propagate), 2)
    peak_fast, peak_f64 = _peak(lambda: sweep(fast)), _peak(
        lambda: sweep(sgp4_propagate))

    times = np.arange(float(N_TIMES))
    f64_kw = dict(start_time=EPOCH_JD, method="f64")
    f64_planes = _cuda_ms(lambda: mcon.propagate(times, layout="planes",
                                                 **f64_kw), 3)
    f64_tm = _cuda_ms(lambda: mcon.propagate(times, **f64_kw), 3)
    peak_planes = _peak(lambda: mcon.propagate(times, layout="planes",
                                               **f64_kw))
    peak_tm = _peak(lambda: mcon.propagate(times, **f64_kw))
    mixed_props = N_SATS * N_TIMES
    print(f"# phase 4c [{smi}]: kernel K5 {k5_ms:.4f} ms ({k5_turns[1]:.4f}, "
          f"{k5_turns[2]:.4f}; {tuple(t.shape)}, {props / k5_ms / 1e6:.3f} G "
          f"props/s), plain torch version {k5_plain:.4f} ms "
          f"({k5_turns[0]:.4f}, {k5_turns[3]:.4f})")
    print(f"# phase 4c [{smi}]: kernel K6 {k6_ms:.4f} ms ({k6_turns[1]:.4f}, "
          f"{k6_turns[2]:.4f}), plain torch version {k6_plain:.4f} ms "
          f"({k6_turns[0]:.4f}, {k6_turns[3]:.4f}); the torch f64 spine "
          f"that feeds it (spine_grids) {spine_ms:.4f} ms")
    print(f"# phase 4c [{smi}]: {SINGLE_SAT_SCENARIOS[-1][0]} sweep ({n_year} "
          f"points): "
          f"propagate_fast_fused (K5) {year_fast:.3f} ms "
          f"({n_year / year_fast / 1e6:.3f} G props/s, peak "
          f"{peak_fast:.3f} GiB); f64 sgp4_propagate {year_f64:.3f} ms "
          f"({n_year / year_f64 / 1e6:.3f} G props/s, peak {peak_f64:.3f} "
          f"GiB)")
    print(f"# phase 4c [{smi}]: f64 propagate of the mixed catalog x "
          f"{N_TIMES}: planes {f64_planes:.3f} ms "
          f"({mixed_props / f64_planes / 1e6:.4f} G props/s, peak "
          f"{peak_planes:.3f} GiB), time_major "
          f"{f64_tm:.3f} ms (peak {peak_tm:.3f} GiB), scan_times=True "
          f"{scan_ms:.1f} ms (host clock, one call; peak "
          f"{scan_peak / 2**30:.3f} GiB)")
    k5_ops = count_ops(lambda: cuda_sgp4.propagate_fast_dense_reference(
        t, *staged, **kw))
    k5_out = cuda_sgp4.propagate_fast_dense(t, *staged, **kw)
    k5_bound = bound(nbytes(t, *staged, *k5_out), *k5_ops)
    k6_ops = count_ops(lambda: cuda_sgp4.propagate_fast_spine_grids_reference(
        grids, tail, flags, **kw))
    k6_bound = bound(nbytes(*grids, tail, flags, *k5_out), *k6_ops)
    print(f"# phase 4c: K5 bound {k5_bound[0]:.4f} ms by {k5_bound[1]} "
          f"({k5_ops[0] / props:.1f} f32 and {k5_ops[1] / props:.1f} f64 "
          f"operations a point); K6 bound {k6_bound[0]:.4f} ms by "
          f"{k6_bound[1]} ({k6_ops[0] / props:.1f} f32 and "
          f"{k6_ops[1] / props:.1f} f64)")
    return (k5_ms, k5_plain, k5_bound), (k6_ms, k6_plain, k6_bound)


def main():
    t_start = time.perf_counter()
    smi = phase0_card()
    phase1_build()
    from astroz_tpu_torch import Constellation, build_catalog

    t0 = time.perf_counter()
    text = near_earth_catalog_text(N_SATS)
    mixed_text = mixed_catalog_text(N_SATS)
    shell_text = screening_shell_text(N_SATS)
    print(f"# synthetic catalog texts: 3 x {N_SATS} TLEs in "
          f"{time.perf_counter() - t0:.2f} s")
    k1_err = phase2_kernel_vs_twin(build_catalog(text, device=DEVICE))
    deep_err = phase2b_deep_and_merge(build_catalog(mixed_text,
                                                    device=DEVICE))
    dense_err = phase2c_dense_vs_twin()
    con, k1_launches = phase3_main_path(text)
    mcon, mixed_launches = phase3b_mixed_path(mixed_text)
    dense_launches = phase3c_single_sat()
    scan_ms, scan_peak = phase3d_f64_path(mcon)
    k1 = phase4_timings(con, smi)
    k2, k3 = phase4b_mixed_timings(mcon, smi)
    scon = Constellation(shell_text, device=DEVICE)
    k4_err, k4c_err, plain_pairs = phase5_coarse_vs_twin(scon)
    screen_launches = phase6_screen(scon, plain_pairs)
    phase6b_mixed_screen(mcon)
    k4, k4c = phase7_screen_timings(scon, smi)
    k5, k6 = phase4c_dense_timings(mcon, smi, scan_ms, scan_peak)
    print(f"# chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(smi)

    def entry(name, source, replaces, n, err, times, library_ms=None):
        ms, plain_ms, (bound_ms, bound_by) = times[:3]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms}

    print(json.dumps({"kernels": [
        entry("sgp4_shallow (K1)", "astroz_tpu_torch/csrc/sgp4_shallow.cu",
              "astroz_tpu/ops/pallas_sgp4.py:286", k1_launches, k1_err[0],
              k1),
        entry("sgp4_deep (K2)", "astroz_tpu_torch/csrc/sgp4_deep.cu",
              "astroz_tpu/ops/pallas_sgp4.py:410",
              mixed_launches["sgp4_deep"], deep_err[0], k2),
        entry("sgp4_shallow_merge (K3)",
              "astroz_tpu_torch/csrc/sgp4_shallow.cu",
              "astroz_tpu/ops/pallas_sgp4.py:657",
              mixed_launches["sgp4_shallow_merge"], deep_err[2], k3),
        # matrix mode is off the screen's path: its count there is 0
        entry("screen_coarse (K4, matrix mode)",
              "astroz_tpu_torch/csrc/screen_coarse.cu",
              "astroz_tpu/ops/pallas_screen.py:57",
              screen_launches["screen_coarse"], k4_err, k4, k4[3]),
        entry("screen_candidates (K4, candidate mode)",
              "astroz_tpu_torch/csrc/screen_coarse.cu",
              "astroz_tpu/ops/pallas_screen.py:57",
              screen_launches["screen_candidates"], k4c_err, k4c, k4c[3]),
        entry("sgp4_shallow_dense (K5)",
              "astroz_tpu_torch/csrc/sgp4_shallow.cu",
              "astroz_tpu/ops/pallas_sgp4.py:202",
              dense_launches["sgp4_shallow_dense"], dense_err[0], k5),
        entry("sgp4_shallow_grids (K6)",
              "astroz_tpu_torch/csrc/sgp4_shallow.cu",
              "astroz_tpu/ops/pallas_sgp4.py:66",
              dense_launches["sgp4_shallow_grids"], dense_err[0], k6)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def cpu_screen_cost(n_sats):
    """``python3 chip_smoke.py --cpu-screen N``: the screen with
    ``device="cpu"`` (K1's and K4's plain versions) of N lanes of the
    screening shell over SCREEN_TIMES epochs at SCREEN_KM; prints its
    wall time and the process's peak resident memory. Needs no card."""
    import resource
    from astroz_tpu_torch import Constellation

    con = Constellation(screening_shell_text(n_sats), device="cpu")
    times = np.arange(float(SCREEN_TIMES))
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    t0 = time.perf_counter()
    res = con.screen(times, start_time=SCREEN_EPOCH_JD, threshold_km=SCREEN_KM)
    wall = time.perf_counter() - t0
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    print(f"# cpu screen: {n_sats} x {SCREEN_TIMES} at {SCREEN_KM} km, "
          f"{len(res[0])} pairs in {wall:.3f} s on {torch.get_num_threads()} "
          f"threads ({torch.__version__}); peak resident memory "
          f"{peak / 2**20:.3f} GiB ({before / 2**20:.3f} GiB before the "
          f"call)")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cpu-screen"]:
        cpu_screen_cost(int(sys.argv[2]))
    else:
        main()
