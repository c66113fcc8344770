"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

(``python3 chip_smoke.py --cpu-screen N`` only times the screen of N
shell lanes with ``device="cpu"``; see :func:`cpu_screen_cost`.
``python3 chip_smoke.py --numerical`` only runs phase 10, which the
whole script runs in such a child process; see :func:`numerical_phase`.)

Phases (any failure exits non-zero; nothing is caught):

0. the card: ``torch.cuda.is_available()``, its name and power limit from
   nvidia-smi; the port imports without JAX;
1. build kernels K1-K6, the spine kernel, the f64 kernel, the
   integrator kernel, the epilogue kernel and TABLES
   (``astroz_tpu_torch/csrc/*.cu``) with nvcc, one process per source,
   and print ptxas' registers and spills;
2. K1 vs its plain torch version on the card, on a small ragged
   near-earth catalog with backward and forward times, over +-1 year
   (41 epochs: the reduction mod 2pi at quotients up to ~2^13) and at
   the full 13,478 x 1,440 shape, with and without velocities, at 3 and
   8 Newton trips: positions, velocities and error codes bit-equal, and
   kernel positions bit-equal with and without velocities;
2b. K2 (deep subset) and K3 (merge) vs their plain versions, bit for
   bit: a small mixed catalog with spread epochs and failing
   deep lanes, backward and forward times, at 6 and 8 trips, with and
   without velocities, and again at the headline mixed catalog's deep
   subset x 1,440; K3's deep columns must equal K2's planes bit for bit;
2c. K5 (dense tsince), the spine kernel (the f64 spine's six grids) and
   K6 (the tail on them) vs their plain versions, bit for bit: a ragged
   1,002-satellite catalog with spread epochs and a decaying lane on a
   dense grid of mixed sign and on a (T, 1) column, and
   bench_single_sat's ISS at one full (4,096, 1,024) chunk, at 3 and 8
   trips, with and without velocities; K5 on ``t_time - t_sat`` must
   equal K1, K6 on the spine kernel's grids must equal K5, and their
   positions must not change without velocities, bit for bit; both
   write the time-major (T, S, 3) rows, and the element-level calls
   (``propagate_fast_fused``, ``propagate_fast_grids``) must equal K5
   bit for bit;
2d. the f64 kernel (``csrc/sgp4_f64.cu``) in its two modes vs their
   plain versions, bit for bit (r, v and codes; positions and codes with
   and without velocities): DENSE in SDP4 mode on a small ragged mixed
   catalog (spread epochs, failing and decaying lanes, Lyddane lanes,
   irez 1 and 2) over a dense grid and a column of times of both signs
   across several 720-minute steps, on the GEO golden TLE folded as the
   API folds time into lanes, and on the headline mixed catalog x 1,440;
   DENSE in SGP4 mode on a near-earth catalog, the ISS fold and one
   1year_1s chunk; ESCAPE on the headline's 14 escape lanes inside a
   real K2 call (the other columns untouched); ``propagate(scan_times=
   True)`` (DENSE on the jd and fr rows) over 240 epochs across epoch
   (+-3 days) sorted forward and backward, on the headline mixed catalog
   and the small one, against the plain ``sdp4_propagate_scan`` and
   ``propagate(scan_times=False)``, bit for bit; DENSE on the headline
   generator's catalog
   with epochs spread over +-7 days x 1,440 (each resonant point steps
   up to ~16 times from epoch); DENSE on the jd and fr rows (each
   point's tsince formed in the kernel, as ``propagate(method="f64")``
   runs it) against the plain functions on torch's grid of the same rows:
   the headline and the spread catalogs x a day of 1,440 epochs, the
   small and the near-earth catalogs x 37 epochs, the small one x 1; one
   launch a call; the row walk's registers and spills beside those it
   had on a tsince grid;
2e. the epilogue kernel (``csrc/finalize.cu``: frames, layouts, mask) vs
   its plain version, bit for bit (bit patterns, NaN where NaN), in every
   output x layout x velocities x mask (every third lane), on the headline
   near-earth and mixed planes (13,478 x 1,440) and on the mixed f64 DENSE
   output, each with a failed lane, two points on the pole axis, two on
   the equator (z = +0.0, -0.0), one under the clamp of p and up to 256
   points that end the latitude iteration in a two-value cycle on the
   card planted: one launch a call, none for TEME in the sweep's own layout
   without a mask; and TABLES (the resonance tables, ``csrc/
   sgp4_deep.cu``) vs its plain version bit for bit at depths 4 and 8 on
   the mixed and the +-7-day catalogs;
3. the near-earth main path: 13,478 synthetic near-earth TLEs as text ->
   ``Constellation(text, device="cuda")`` -> ``propagate`` over 1,440
   one-minute epochs, as planes, as ECEF planes and time-major. Each
   call must launch K1 once, the epilogue kernel once for the ECEF planes
   and the time-major call (never for TEME planes), and nothing else;
   outputs must be finite
   CUDA tensors, |r| in the LEO band on healthy lanes, a 512-column
   sample equal to the plain version run on the CPU within POS_TOL_KM
   and VEL_TOL_KMS (the host's torch), and the python-sgp4 golden
   trajectory within 0.1 km;
3b. the mixed main path: the headline catalog of bench.py (13,478 TLEs,
   667 deep lanes, 14 of them HEO-escape lanes) through the same calls.
   Each call must launch K2, the f64 kernel's ESCAPE mode and K3 once
   each, the epilogue kernel as in phase 3, TABLES at the first call only
   (and K1 never); outputs
   finite CUDA tensors; healthy LEO, GEO and HEO/GPS columns in their
   radius bands; every column at 145 of the epochs equal to the plain
   path run on the CPU within those bounds; the python-sgp4 GEO
   and Molniya golden vectors within 0.1 km;
3c. the single-satellite time-grid path (bench_single_sat.py): the ISS
   golden TLE broadcast to 1,024 lanes, minutes as (rows, 1,024) f64
   chunks of at most 2^22 points, over 1day_1min, 1week_1min and
   1year_1s (31,536,000 points, 8 chunks) through ``propagate_fast_fused``
   (K5, once a chunk), ``propagate_fast_grids`` (the spine kernel and K6,
   once each a chunk, equal to K5 bit for bit) and the f64
   ``sgp4_propagate``: finite CUDA
   outputs, error codes all 0 on the short scenarios and equal between
   fast and f64 on all, |r| in the LEO band on healthy points, the f64
   path within 0.1 km of the python-sgp4 trajectory, fast within the JAX
   package's 30 m / 50 m of f64 on the short scenarios (the year's
   largest distance printed);
3d. the f64 main path: the headline mixed catalog x 1,440 through
   ``Constellation.propagate(method="f64")`` as planes, time-major and
   with ``scan_times=True``, each one launch of the f64 kernel (DENSE on
   the jd and fr rows, the scan too) and of the epilogue kernel for the
   two planes calls:
   error codes equal
   the fast path's, the fast path within 0.05 km of f64 on healthy
   near-earth points, 0.1 km on deep ones (the worst lane of each regime
   printed) and 5e-3 km on the escape lanes, scan within 1e-6 km
   and 1e-9 km/s of dense and bit-equal (r, v, codes) to the plain
   ``sdp4_propagate_scan`` on the same tsince, the GEO and Molniya
   golden vectors within
   0.01 km, and ``propagate_tsince`` on a (16, 1) grid (one DENSE launch)
   equal to ``sdp4_propagate``;
4. timings with CUDA events: K1 alone and its plain version on the card,
   in turns (the kernel launched back to back, host gaps included, and
   replayed from a CUDA graph, its own time), and the whole near-earth
   ``propagate`` call;
4b. the same for K2 and K3, plus K2's wrapper's host time, the HEO
   escape (the f64 kernel's ESCAPE mode in turns with its plain version,
   with its bound), TABLES in turns with its plain version (with its
   bound) and the whole mixed ``propagate`` call,
   and the peak device memory of a mixed sweep; K2's registers and
   spills, its persistent grid (blocks an SM, blocks launched, waves) and
   its issue estimate (the static SASS instructions of its row loop a
   point over the card's issue rate);
4d. the trips of the latitude iteration that the epilogue kernel's
   geodetic takes on the mixed catalog's f32 and f64 ECEF points x 1,440
   (``trips_report``: a histogram, the two-value cycles, the trips a
   point its warps run); the epilogue kernel alone on the mixed planes
   and f64 DENSE output, every output x layout but the identity, in
   turns with its plain version, each with its bound and torch's copies
   of the TEME relayout (``permute(...).contiguous()`` of r and v, and
   for sat_major ``err.t().contiguous()``); then ``propagate()`` of both
   catalogs, fast and f64, in every output x layout, through the kernel
   and through the plain epilogue route (the parent commit's), in turns:
   outputs bit-equal, one epilogue launch a call, none for the identity;
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
4c. timings with CUDA events: K5, the spine kernel and K6 alone at one
   (4,096, 1,024) chunk and their plain versions, in turns as in phase 4
   (K5 through ``propagate_fast_fused`` on elements already staged; K6
   as ``propagate_fast_grids`` runs it; both in their one time-major
   store), the whole ``propagate_fast_grids`` call a chunk, the whole
   1year_1s sweep through K5, through the f64 kernel (DENSE, SGP4) and
   through the plain f64 ``sgp4_propagate``, the f64 ``propagate`` of
   the mixed catalog (planes, time-major, ``scan_times=True``), and the
   peak device memory of each; the f64 kernel alone in turns with its
   plain versions: DENSE on the mixed catalog x 1,440 and the scan
   (DENSE on the jd and fr rows) on its first 240 epochs, with their
   bounds, and DENSE on the +-7-day catalog x 1,440; ``scan_times=True``
   on the mixed catalog x 1,440 against the route it replaced (torch's
   (T, S) tsince grid, then DENSE on it), time and peak memory, bit for
   bit; K5's and K6's registers, spills,
   grid and issue estimate as K2's, and the f64 kernel's row walk's
   (SDP4 on the mixed catalog, SGP4 on the 1year_1s chunk) with its
   f64-pipe estimate; and, under
   ``torch.profiler``, a second ``propagate_fast_fused`` call on the same
   elements must run K5 and no other device work (no staging, no copy),
   and a second ``propagate_fast_grids`` call the spine kernel and K6 and
   nothing else;
8. the python-sgp4 drop-in API (``astroz_tpu_torch.api``): g++ builds
   the native scalar engine; ``Satrec.twoline2rv(..., device="cuda")``
   for every TLE of the mixed and of the near-earth catalog, then a
   ``SatrecArray`` of each (host clock). ``SatrecArray.sgp4`` over the
   1,440 epochs must launch K2, the escape and K3 once and TABLES at its
   first call (mixed) or K1 once (near-earth), and the epilogue kernel
   once (the sat_major relayout), and equal ``propagate(fast, sat_major)`` cast to f64 bit
   for bit; the mixed one is held to phase 3d's fast-vs-f64 gates. Timed:
   the call, ``sgp4_into`` preallocated buffers, and the call's split
   (propagate, relayout, copy to the host, cast on the host). A
   1,000-lane array of half WGS72, half WGS84 satrecs runs one propagate
   a model, each row equal to its single-model array's. ``Satrec.sgp4``
   timed a call (10,000 calls) on the native core, which must be the
   engine in use, the ctypes engine and the Python scalar, beside a
   one-point ``propagate_tsince`` on the card (100 calls);
   ``Satrec.sgp4_array``'s two paths (ISS, GEO) over 1,024 to 524,288
   one-second points: the time-as-lanes f64 path on the card within
   2e-6 km of the native array engine, both timed in turns, and the path
   the API takes at each size the one its threshold gives
   (``lanes_crossover``); ``create_sgp4_propagator`` on the
   card equal to ``propagate_tsince``, under ``torch.func.vmap`` equal to
   the loop, and for the GEO TLE with ``max_steps`` equal to the plain
   call;
9. the native ingest and runtime layer (``astroz_tpu_torch/native``; g++
   builds it in phase 1 beside nvcc), host-bound, so each line carries
   the host CPU's model beside the card: for the mixed and near-earth
   13,478-TLE catalogs and the mixed 50,000 (README.md's debris scale),
   the native and the Python parse in turns (all 12 columns and the
   satellite numbers bit-equal) and the time to first sweep, TLE text ->
   ``build_catalog(device="cuda")`` -> the first ``propagate(fast,
   planes)`` over 1,440 epochs, through each route in turns, with its
   split (parse, init, SDP4 init and device catalog, staging and
   resonance tables, sweep); the native route must call
   ``native.parse_catalog``, each first sweep launch K2, the escape, K3
   and TABLES once (K1 on the near-earth catalog; TEME planes: no
   epilogue launch), and the mixed sweeps pass phase 3b's
   gates; the frame scanner on ~64 MiB CCSDS and VITA-49 streams with
   corrupt bytes between frames, with and without the sync marker, equal
   to the Python walk, both timed; the C ABI through ctypes (ISS and GEO
   golden TLEs x 1,440 minutes): ``sgp4_init``'s element vector equals
   the Python init's, ``sgp4_propagate`` equals ``Satrec.sgp4_tsince`` on
   the native core and ``sgp4_propagate_batch`` the native engine's
   array path, bit for bit; and ``propagate(fast)`` of the ISS x 1,440 and
   of 100 near-earth lanes x 100 epochs on the card against
   ``native.sgp4_grid`` on the same inputs, in turns (the small-grid host
   route the port leaves out);
10. the numerical stack, each device number beside the host's, through
   the integrator kernel (``csrc/integrate_f64.cu``; not a TPU kernel: the
   XLA scan and while loop of the JAX package), each of its modes bit for
   bit (ADAPTIVE within ADAPTIVE_TOL_KM) against its plain version on the
   card and timed in turns with it: (a) 100,000 Monte-Carlo lanes around
   the ISS golden TLE's state (``tle_to_elements`` + ``elements_to_state``;
   1 km, 1 m/s of noise) through RK4 ``propagate_fixed`` of TwoBody + J2 +
   Drag over a 5,400 s orbit at 30 s, a (181, 100000, 6) f64 output: one
   launch of FIXED and no host sync in the call (sync debug mode), CUDA
   events, mean of 3, the peak device memory, FIXED against its plain
   version, its bound the larger of its bytes and its f64 work (the f64
   operations a lane-step of the kernel's RK4 step, counted from its
   source by :func:`fixed_rk4_ops`, each at the card's rate for it, the
   rates of pow, exp, the divide, square root and reciprocal measured by
   :func:`f64_op_seconds`), and DP8(7) fixed steps on 10,000 of the lanes
   over 10 steps,
   the same call on the host once (its first 10,000 lanes where the whole
   would take over 30 s) within 1e-6 km, TwoBody alone on 1,000 lanes
   with a relative energy drift under 1e-5; (b) one adaptive DP8(7)
   trajectory of TwoBody + J2 from the ISS state, rtol 1e-10, 6 h at 60 s
   outer steps: ``Propagator.propagate`` (one TRAJECTORY launch and one
   read a call, one host sync), the same outer steps through
   ``DormandPrince87.step`` (one ADAPTIVE launch and one read each:
   ``dp87_adaptive``'s TRAJECTORY of one outer step), the
   plain loop on the card and the host, in turns: TRAJECTORY bit-equal to
   the ADAPTIVE launches (every state, each outer step's substeps and h,
   ``h_current``, ``n_substeps``), within ADAPTIVE_TOL_KM of its plain
   version (``adaptive_trajectory_reference``) with the same counts, and
   so for 1 h of a model of each other signature (TwoBody; TwoBody + J2 +
   Drag; every kind, through the run-time dispatch); the
   final states within 1e-5 km of the host's; ADAPTIVE against its plain
   version on each outer step (equal substep counts, ``h_current`` within
   ADAPTIVE_H_RTOL), and from each of its states over ADAPTIVE_BIND_S,
   where h binds: one substep of the trajectory's h and one rejected,
   bit-equal with the next h within ADAPTIVE_H_RTOL, and the whole outer
   step with equal counts; a circular 500 km orbit back at its start
   within 1 m after one period; one outer step of ADAPTIVE and the whole
   TRAJECTORY timed in turns with their plain versions;
   (c) ``run_hohmann_monte_carlo`` of 1,000,000 samples: the LEO->GEO
   mean total dv within 0.1 km/s of 3.85, ``n + n_failed`` the sample
   count, the host's mean within 4 standard errors; (d) the ISS as a
   ``Spacecraft`` over 6 h at 30 s with a prograde and a plane-change
   burn (FIXED once a segment, equal to the plain route bit for bit; the
   orbit raised by over 100 km, the plane turned by the commanded 5 deg
   within 0.5, the inclination moved; card within 1e-5 km of the host)
   and 10,000 ``propagate_attitude`` steps (one ATTITUDE launch, card
   within 1e-12 of the host; ATTITUDE bit-equal to its plain version,
   its cycles a step at the card's SM clock); then, under
   ``torch.profiler``, 10 RK4 steps of 10a must run one kernel, a DP8(7)
   outer step of 10b one, and a whole ``Propagator.propagate`` of 10b
   one kernel and one read;
11. the multi-device paths (``astroz_tpu_torch.parallel``, run after
   phase 9) on a mesh of every visible card, or of one card repeated
   MESH_SHARDS times (printed): (a) ``propagate_sharded_fast`` of the
   mixed 13,478 x 1,440 catalog over ``sat`` 4 and over ``time 2 x sat
   2`` bit-equal to ``propagate(method="fast")`` (r, v and codes, escape
   lanes included) as time-major, sat-major, planes, without velocities
   and in ECEF, each shard launching K2 and K3 once (K1 on a shard
   without deep lanes); (b) ``propagate_sharded`` (f64) at 13,478 x 240
   bit-equal to the f64 ``propagate``; (c) ``screen_all(mesh=)`` and (d)
   ``screen_all_ring`` equal to ``screen_all`` (pairs, distances,
   epochs) on phase 6's shell and phase 6b's mixed catalog, the ring
   also on 2,000 shell lanes with two failed lanes at local column 0 of
   two shards (no pair with them); (e) K4's rectangle mode pair for pair
   against its plain version on ragged 1,003 x 777 blocks with a NaN,
   once through its overflow path, and on one ring tile of the shell;
   (f) times with CUDA events, in turns: the staged sharded sweep
   against the single-device sweep, both mesh screens against
   ``screen_all``, and the rectangle mode against its plain version,
   with its bound.

The last three lines of output are the card line from nvidia-smi, a
JSON line describing the kernels (K1-K6, the spine kernel, the f64
kernel's two modes and the scan on DENSE, the epilogue kernel in f32 and
f64, TABLES and the
integrator kernel's four, with each one's bound: the larger of
its bytes over the card's memory rate and its operations over the peak
rate for their type; ``ms`` is the kernel launched back to back through
its wrapper, ``device_ms`` the same calls replayed from a CUDA graph,
null for K4, whose candidate and rectangle modes fetch a count), and
``{"ok": true,
"device": ...}``.
"""

import functools
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

DEVICE = "cuda"
N_SATS = 13478
N_TIMES = 1440
EPOCH_JD = 2460310.5
#: the card's outputs against the plain versions run on the host's CPU
#: (phases 3, 3b), whose torch may round a few operations otherwise; on
#: the card (phases 2-2c) the kernels equal their plain versions bit for
#: bit
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
#: K4's modes by the template argument of its mangled kernel name
K4_MODES = {"0": "matrix", "1": "candidate", "2": "rectangle"}
#: the mangled names of K5, K6 and K2 with velocities at a number of
#: Newton trips, as ptxas and cuobjdump show them
DENSE_KERNEL = "sgp4_dense_kernelILb1ELi{}ELi0E"
GRIDS_KERNEL = "sgp4_dense_kernelILb1ELi{}ELi1E"
DEEP_KERNEL = "sgp4_deep_kernelILb1ELi{}E"
#: the f64 kernel's row walk with velocities in SGP4 (0) or SDP4 (1) mode
F64_KERNEL = "sgp4_f64_walk_kernelILi{}ELb1EE"
#: the SASS opcodes that issue to the f64 pipe, which has 64 lanes an SM
#: on an H100 (half the f32 lanes)
F64_OPCODES = ("DADD", "DFMA", "DMUL", "DSETP", "DMNMX", "DSET")
F64_LANES_PER_SM = 64
#: the headline generator's epochs spread over +-this many days: a
#: resonant point of DENSE steps up to ~16 times from its epoch
SPREAD_DAYS = 7.0

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
    from astroz_tpu_torch.ops import (cuda_finalize, cuda_integrate,
                                      cuda_screen, cuda_sgp4)

    for counts in (cuda_sgp4.LAUNCHES, cuda_screen.LAUNCHES,
                   cuda_integrate.LAUNCHES, cuda_finalize.LAUNCHES):
        for name in counts:
            counts[name] = 0


def launches():
    """Every kernel's launch count, by kernel."""
    from astroz_tpu_torch.ops import (cuda_finalize, cuda_integrate,
                                      cuda_screen, cuda_sgp4)

    return {**cuda_sgp4.LAUNCHES, **cuda_screen.LAUNCHES,
            **cuda_integrate.LAUNCHES, **cuda_finalize.LAUNCHES}


#: aten ops that write floats without arithmetic: they make, move,
#: reshape, cast or select data
_NOT_ARITHMETIC = frozenset((
    "_to_copy", "_unsafe_view", "alias", "as_strided", "cat", "clone",
    "copy_", "detach", "empty", "empty_like", "expand", "fill_", "full",
    "full_like", "gather", "index", "index_select", "lift_fresh",
    "masked_fill", "masked_fill_", "new_empty", "ones", "ones_like",
    "permute", "scalar_tensor", "select", "slice", "stack", "unbind",
    "unsqueeze", "view", "where", "zeros", "zeros_like"))


def _kepler_frozen_trips(u, axnl, aynl, iters):
    """The point-trips of ``ops.sgp4.solve_kepler``'s loop that come after
    the trip that froze their point: its steps in the same order, each
    point frozen once its step is under 1e-12."""
    eo1 = u
    done = torch.zeros(torch.broadcast_shapes(u.shape, axnl.shape,
                                              aynl.shape),
                       dtype=torch.bool, device=u.device)
    sineo1, coseo1 = torch.sin(eo1), torch.cos(eo1)
    frozen = 0
    for _ in range(iters):
        frozen += int(done.sum())
        denom = 1.0 - coseo1 * axnl - sineo1 * aynl
        tem5 = torch.clamp((u - aynl * coseo1 + axnl * sineo1 - eo1) / denom,
                           -0.95, 0.95)
        eo1 = torch.where(done, eo1, eo1 + tem5)
        done = done | (torch.abs(tem5) < 1.0e-12)
        sineo1, coseo1 = torch.sin(eo1), torch.cos(eo1)
    return frozen, done.numel()


def count_ops(fn, by_op=None):
    """Run ``fn``, a kernel's plain version, and count its floating-point
    arithmetic: the elements written by every aten op whose result is f32
    or f64, outside :data:`_NOT_ARITHMETIC`, by the result's type. Casts,
    selects and data movement are not counted, nor are comparisons and
    integer or boolean ops (their results are not floats). A divide, a
    square root or an ``fmod`` counts as one operation.

    The f64 Kepler solve (``ops.sgp4.solve_kepler``) runs its 10 trips at
    every point; the f64 kernel leaves a point's loop at the trip that
    freezes it, so a point's trips after that one are not counted.
    Returns ``(f32_ops, f64_ops)``; with ``by_op`` (a dict), also adds
    each op's f64 elements under ``(name, scalar exponent or None)``
    (outside the Kepler solve)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    from astroz_tpu_torch.ops import sgp4 as sgp4_ops

    counts = {torch.float32: 0, torch.float64: 0}
    counting = [True]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            outs = [x for x in tree_flatten(out)[0]
                    if isinstance(x, torch.Tensor)]
            name = func.overloadpacket.__name__
            if (counting[0] and outs and outs[0].dtype in counts
                    and name not in _NOT_ARITHMETIC):
                counts[outs[0].dtype] += outs[0].numel()
                if by_op is not None and outs[0].dtype == torch.float64:
                    key = (name, args[1] if name == "pow" and isinstance(
                        args[1], (int, float)) else None)
                    by_op[key] = by_op.get(key, 0) + outs[0].numel()
            return out

    solve = sgp4_ops.solve_kepler

    def solve_needed(u, axnl, aynl, iters=10):
        start = dict(counts)
        solve(u, axnl, aynl, 0)  # the loop's head alone
        head = {k: counts[k] - start[k] for k in counts}
        mid = dict(counts)
        out = solve(u, axnl, aynl, iters)
        counting[0] = False
        try:
            frozen, points = _kepler_frozen_trips(u, axnl, aynl, iters)
        finally:
            counting[0] = True
        for k in counts:
            trips = counts[k] - mid[k] - head[k]
            counts[k] = (start[k] + head[k]
                         + trips * (1.0 - frozen / (iters * points)))
        return out

    sgp4_ops.solve_kepler = solve_needed
    try:
        with Count():
            fn()
    finally:
        sgp4_ops.solve_kepler = solve
    return counts[torch.float32], counts[torch.float64]


def f64_ops(plain_deep, tsince, fields, flags, grav):
    """``count_ops`` of the f64 kernel's work on a mixed catalog: the
    plain SGP4 path on its near-earth lanes and ``plain_deep(tsince,
    fields, flags, grav=)`` (the SDP4 DENSE version or the scan) on its
    deep lanes. The plain SDP4 functions run the deep-space terms on every
    lane and blend; the kernel runs them on the deep lanes alone. What is left
    over-counted (both resonance branches, derivatives at non-resonant
    deep lanes) matters only where the operations outweigh the bytes."""
    from astroz_tpu_torch.ops import cuda_sgp4

    deep = flags[1] != 0
    near = ~deep
    n_sgp4 = len(cuda_sgp4.SGP4_F64_FIELD_NAMES)
    ops = [0, 0]
    if near.any():
        a = count_ops(lambda: cuda_sgp4.sgp4_f64_dense_reference(
            tsince[:, near], fields[:n_sgp4, near].contiguous(),
            flags[:, near].contiguous(), grav=grav, sdp4=False))
        ops = [x + y for x, y in zip(ops, a)]
    if deep.any():
        b = count_ops(lambda: plain_deep(
            tsince[:, deep], fields[:, deep].contiguous(),
            flags[:, deep].contiguous(), grav=grav))
        ops = [x + y for x, y in zip(ops, b)]
    return tuple(ops)


def _plain_scan(tsince, fields, flags, *, grav):
    """``sdp4_propagate_scan`` of staged elements on a tsince grid, as
    :func:`f64_ops` counts it."""
    from astroz_tpu_torch.ops import cuda_sgp4, sdp4_propagate_scan

    els, deep = cuda_sgp4.f64_unstage(fields, flags)
    return sdp4_propagate_scan(els, deep, tsince, grav)


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


def card_line():
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def phase0_card():
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = card_line()
    print(smi)
    import astroz_tpu_torch  # noqa: F401
    check("jax" not in sys.modules, "importing the port loaded jax")
    print(f"# phase 0: torch {torch.__version__} cuda {torch.version.cuda} "
          f"on {torch.cuda.get_device_name(0)} ({smi})")
    return smi


def phase1_build():
    from concurrent.futures import ThreadPoolExecutor

    from astroz_tpu_torch import _build, native

    def build_native():
        t = time.perf_counter()
        native.get_lib()
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        gxx = pool.submit(build_native)  # g++ beside the nvcc processes
        path = _build.build()
        _build.library()
        print(f"# phase 1: nvcc built {path.name} in "
              f"{time.perf_counter() - t0:.1f} s")
        for src in _build._sources()[0]:
            print(f"# phase 1: flags of {src.name}: "
                  f"{' '.join(_build._flags(src))}")
        print(f"# phase 1: g++ built {native.library_path().name} (TLE "
              f"parser, frame scanner, scalar engine, C ABI) in "
              f"{gxx.result():.1f} s")
    for name, regs, spill_st, spill_ld in _build.ptxas_report():
        print(f"# phase 1: ptxas {name}: {regs} registers, spill stores "
              f"{spill_st} B, spill loads {spill_ld} B")


def _kernel_vs_twin(st, t_time, grav, label, codes=None):
    """K1 vs its plain version at one shape, both Newton rungs, with and
    without velocities, bit for bit; returns the largest position and
    velocity differences. ``codes``: the error codes the points must
    show."""
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
        check(torch.equal(r, rr) and torch.equal(v, vr),
              f"{label}: not bit-equal to the plain version (|dr| {dr} km, "
              f"|dv| {dv} km/s)")
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
    t_year = torch.linspace(-525600.0, 525600.0, 41, dtype=torch.float64,
                            device=DEVICE)
    year = _kernel_vs_twin(small.fast_staging, t_year, small.grav,
                           "334 sats x 41 times (-1 .. +1 year)")
    worst = (max(worst[0], year[0]), max(worst[1], year[1]))
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
    velocities, bit for bit; K3 once with the catalog's column maps and
    once deriving them from ``deep_slot``. Returns the worst (K2 dr, K2
    dv, K3 dr, K3 dv)."""
    from astroz_tpu_torch.ops import cuda_sgp4
    from astroz_tpu_torch.propagation import resonance_steps

    st, ds = cat.fast_staging, cat.fast_staging.deep
    jd_sum = cat.epoch_min_jd + t_time.cpu().numpy() / 1440.0
    steps = resonance_steps(jd_sum, cat.deep_epochs_jd)
    dargs = (t_time, ds.t_sat, ds.spine, ds.tail, ds.flags,
             cat.resonance_tables(steps))
    margs = (t_time, st.t_sat, st.spine, st.tail, st.flags, ds.slot)
    mkw = dict(grav=cat.grav, kepler_iters=cat.kepler_iters)
    maps = dict(maps=ds.maps)
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
        check(torch.equal(r, rr) and torch.equal(v, vr),
              f"K2 {label} iters={iters}: not bit-equal to the plain "
              f"version (|dr| {dr} km, |dv| {dv} km/s)")
        check(torch.equal(r, r0), f"K2 {label}: positions differ with and "
              "without velocities")
        check(k2_codes is None or set(k2_codes) <= set(codes),
              f"K2 {label}: error codes {codes} lack {k2_codes}")
        worst[0], worst[1] = max(worst[0], dr), max(worst[1], dv)

        m = cuda_sgp4.propagate_fast_sep_merge(*margs, r, v, e, **mkw,
                                               **maps)
        m0 = cuda_sgp4.propagate_fast_sep_merge(*margs, r0, None, e0, **mkw,
                                                want_vel=False)
        derived = cuda_sgp4.propagate_fast_sep_merge(*margs, r, v, e, **mkw)
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
        check(torch.equal(m[0], mr[0]) and torch.equal(m[1], mr[1]),
              f"K3 {label}: not bit-equal to the plain version (|dr| {dr} "
              f"km, |dv| {dv} km/s)")
        check(torch.equal(m[0], m0[0]), f"K3 {label}: positions differ "
              "with and without velocities")
        check(all(torch.equal(a, b) for a, b in zip(m, derived)),
              f"K3 {label}: maps derived from deep_slot give other planes")
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
    """K5, the spine kernel and K6 vs their plain versions at one shape,
    both Newton rungs, with and without velocities, bit for bit, in the
    time-major store both write; K6 on the spine kernel's grids must
    equal K5 bit for bit, and the element-level calls
    (``propagate_fast_fused``, ``propagate_fast_grids``) the staged ones.
    Returns the largest K5 and K6 position and velocity differences and
    the spine kernel's largest difference."""
    from astroz_tpu_torch.ops import cuda_sgp4
    from astroz_tpu_torch.ops.fast import shallow_staging

    staged = shallow_staging(els)
    before = launches()["sgp4_spine_grids"]
    grids, tail, flags = cuda_sgp4.spine_grids(els, tsince)
    plain_grids = cuda_sgp4.spine_f64_grids_reference(tsince, staged[0])
    sync()
    spine_err = max(_max_diff(a, b) for a, b in zip(grids, plain_grids))
    print(f"# phase 2c: {label}: spine kernel max diff {spine_err:.3e} "
          f"from the plain spine")
    check(launches()["sgp4_spine_grids"] == before + 1,
          f"spine kernel {label}: not launched once")
    check(all(torch.equal(a, b) for a, b in zip(grids, plain_grids)),
          f"spine kernel {label}: not bit-equal to the plain spine")
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
        # the element-level calls, K5's and K6's staged elements
        tm = cuda_sgp4.propagate_fast_fused(els, tsince, grav,
                                            kepler_iters=iters)
        path = cuda_sgp4.propagate_fast_grids(els, tsince, grav,
                                              kepler_iters=iters)
        sync()
        check(all(torch.equal(a, b) for a, b in zip(tm, (r, v, e)))
              and r.is_contiguous() and v.is_contiguous()
              and r.shape == e.shape + (3,),
              f"K5 {label} iters={iters}: propagate_fast_fused differs "
              "from propagate_fast_dense, or its rows are not a contiguous "
              "(T, S, 3)")
        check(all(torch.equal(a, b) for a, b in zip(path, tm)),
              f"{label} iters={iters}: propagate_fast_grids differs from "
              "propagate_fast_fused")
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
              f"K6 {torch.equal(g[0], g0[0])}; propagate_fast_fused "
              "bit-equal to K5, propagate_fast_grids to propagate_fast_fused: "
              "True")
        check(torch.equal(r, rr) and torch.equal(v, vr),
              f"K5 {label}: not bit-equal to the plain version (|dr| {dr} "
              f"km, |dv| {dv} km/s)")
        check(all(torch.equal(a, b) for a, b in zip(g, gr)),
              f"K6 {label}: not bit-equal to the plain version (|dr| {gdr} "
              f"km, |dv| {gdv} km/s, or error codes)")
        check(same, f"{label}: K6 on the spine kernel's grids differs "
              "from K5")
        check(torch.equal(r, r0) and torch.equal(g[0], g0[0])
              and torch.equal(g0[2], e),
              f"{label}: positions differ with and without velocities")
        check(codes is None or set(codes) <= set(codes_seen),
              f"{label}: error codes {codes_seen} lack {codes}")
        worst_r, worst_v = max(worst_r, dr, gdr), max(worst_v, dv, gdv)
    return worst_r, worst_v, spine_err


def phase2c_dense_vs_twin():
    """K5, the spine kernel and K6 against their plain versions; returns
    the largest position and velocity differences and the spine
    kernel's largest difference."""
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
    same = (torch.equal(k5[0], k1[0].permute(1, 2, 0))
            and torch.equal(k5[1], k1[1].permute(1, 2, 0))
            and torch.equal(k5[2], k1[2]))
    print(f"# phase 2c: K5 on t_time - t_sat bit-equal to K1 ({n} sats x "
          f"37 times, {small.kepler_iters} trips): {same}")
    check(same, "K5 on a separable grid differs from K1")
    return tuple(max(w[k] for w in worst) for k in range(3))


def _f64_vs_plain(label, kernel, plain, codes=None):
    """One f64 kernel mode against its plain version: ``kernel(want_vel)``
    and ``plain()`` return ``(r, v, err)``. Positions, velocities and
    codes bit-equal (NaN where NaN), and the kernel's positions and codes
    without velocities bit-equal to those with. Returns the largest
    position and velocity differences."""
    r, v, e = kernel(True)
    r0, v0, e0 = kernel(False)
    rr, vr, er = plain()
    sync()
    dr, dv = _max_diff(r, rr), _max_diff(v, vr)
    found = sorted(set(torch.unique(e).tolist()))
    print(f"# phase 2d: {label}: max|dr| {dr:.3e} km, max|dv| {dv:.3e} "
          f"km/s, error codes {found}, r bit-equal without v: "
          f"{torch.equal(r, r0)}")
    check(v0 is None, f"{label}: want_vel=False returned velocities")
    check(torch.equal(e, er) and torch.equal(e0, er),
          f"{label}: error codes differ from the plain version")
    check(_same_or_both_nan(r, rr) and _same_or_both_nan(v, vr),
          f"{label}: not bit-equal to the plain version (|dr| {dr} km, "
          f"|dv| {dv} km/s)")
    check(_same_or_both_nan(r, r0), f"{label}: positions differ with and "
          "without velocities")
    check(codes is None or set(codes) <= set(found),
          f"{label}: error codes {found} lack {codes}")
    return dr, dv


def _escape_vs_plain(cat, t_time, label):
    """The f64 kernel's ESCAPE mode inside a real K2 call: K2's planes
    over ``t_time``, then the escape lanes written by the kernel and by
    its plain version into copies, with and without velocities, bit for
    bit; the other columns stay K2's. Returns the largest position and
    velocity differences."""
    from astroz_tpu_torch.ops import cuda_sgp4
    from astroz_tpu_torch.propagation import resonance_steps

    ds, esc = cat.fast_staging.deep, cat.heo_escape
    jd_sum = cat.epoch_min_jd + t_time.cpu().numpy() / 1440.0
    tables = cat.resonance_tables(resonance_steps(jd_sum,
                                                  cat.deep_epochs_jd))
    args = (t_time, esc.t_sat, *esc.staged, esc.idx, tables)
    keep = torch.ones(cat.n_deep, dtype=torch.bool, device=DEVICE)
    keep[esc.idx] = False

    def run(want_vel, fn):
        planes = cuda_sgp4.propagate_deep_sep(
            t_time, ds.t_sat, ds.spine, ds.tail, ds.flags, tables,
            grav=cat.grav, kepler_iters=cat.deep_kepler_iters,
            want_vel=want_vel)
        k2 = planes[0].clone()
        fn(*args, *planes, grav=cat.grav, want_vel=want_vel)
        check(torch.equal(planes[0][:, :, keep], k2[:, :, keep]),
              f"{label}: the escape wrote outside its columns")
        return planes

    kernel_calls = launches()["sgp4_f64_escape"]
    worst = _f64_vs_plain(
        f"ESCAPE, {label}",
        lambda want_vel: run(want_vel, cuda_sgp4.sgp4_f64_escape),
        lambda: run(True, cuda_sgp4.sgp4_f64_escape_reference))
    check(launches()["sgp4_f64_escape"] == kernel_calls + 2,
          f"{label}: the escape did not launch once a call")
    return worst


def _headline_tsince(cat):
    """The main path's minutes since each epoch: N_TIMES one-minute epochs
    from EPOCH_JD, as ``_propagate_f64`` forms them, (T, S) f64."""
    jd = torch.as_tensor(EPOCH_JD + np.arange(float(N_TIMES)) / 1440.0,
                         device=DEVICE)
    return (jd[:, None] - cat.els.epoch_jd[None, :]) * 1440.0


#: the f64 row walk's ptxas report before DENSE formed tsince from the jd
#: and fr rows (parent build of csrc/sgp4_f64.cu on an H100, CUDA 12.8):
#: (registers, spill store bytes) by (SDP4 mode, velocities)
F64_WALK_PTXAS_GRID = {(1, 1): (96, 456), (1, 0): (96, 436),
                       (0, 1): (80, 32), (0, 0): (80, 16)}


def f64_walk_ptxas():
    """Print the f64 row walk's registers and spills of each instantiation
    (ptxas) beside :data:`F64_WALK_PTXAS_GRID`."""
    from astroz_tpu_torch import _build

    for name, regs, st, ld in _build.ptxas_report():
        m = re.search(r"sgp4_f64_walk_kernelILi(\d)ELb(\d)E", name)
        if m:
            key = (int(m.group(1)), int(m.group(2)))
            was = F64_WALK_PTXAS_GRID.get(key)
            print(f"# phase 2d: ptxas row walk "
                  f"({'SDP4' if key[0] else 'SGP4'} mode, velocities "
                  f"{bool(key[1])}): {regs} registers, spill stores {st} B, "
                  f"spill loads {ld} B (on a tsince grid before: "
                  f"{'not measured' if was is None else was[0]} registers, "
                  f"{'' if was is None else was[1]} B of spill stores)")


def phase2d_f64_vs_plain(headline_cat, spread_cat):
    """The f64 kernel's two modes against their plain versions on the
    card, bit for bit (r, v and codes; positions and codes with and
    without velocities): DENSE in SDP4 mode on a small ragged mixed
    catalog (spread epochs, failing and decaying lanes, Lyddane lanes,
    irez 1 and 2) over a dense grid and a column of times of both signs
    across several 720-minute steps, on the GEO golden TLE folded as the
    API folds time into lanes, on the headline catalog and on the
    headline generator's catalog with epochs spread over +-SPREAD_DAYS
    (``spread_cat``); DENSE in SGP4 mode on a near-earth catalog, on the
    ISS fold and on one 1year_1s chunk; ESCAPE on the headline catalog's
    escape lanes inside a real K2 call; ``propagate(scan_times=True)``
    over 240 epochs across epoch (+-3 days) sorted forward and backward,
    on the headline mixed catalog and the small one, against the plain
    scan and ``propagate(scan_times=False)``, bit for bit, one launch of
    DENSE on the rows a call; DENSE on the jd and fr rows against the
    plain functions on torch's grid of the rows, on the headline and spread
    catalogs x a day, the small and near-earth ones x 37 epochs and x 1.
    Prints the row walk's ptxas report first. Returns the largest
    position difference of each mode."""
    from astroz_tpu_torch import build_catalog, propagate
    from astroz_tpu_torch.ops import cuda_sgp4
    from astroz_tpu_torch.ops.cuda_sgp4 import f64_staging
    from astroz_tpu_torch.tle import format_lines

    f64_walk_ptxas()
    decaying = format_lines(satnum=99999, epoch_jd=EPOCH_JD - 2.0,
                            ecco=5e-4, inclo_deg=51.6, nodeo_deg=10.0,
                            argpo_deg=20.0, mo_deg=30.0, no_rev_day=16.0,
                            bstar=0.5)
    failing = [format_lines(satnum=99990 + k, epoch_jd=EPOCH_JD - 1.5,
                            ecco=ecc, inclo_deg=30.0, nodeo_deg=40.0,
                            argpo_deg=50.0, mo_deg=60.0, no_rev_day=rev,
                            bstar=bstar)
               for k, (rev, ecc, bstar) in enumerate(((6.3, 0.75, 0.01),
                                                      (6.0, 0.5, 5.0)))]
    small = build_catalog(
        mixed_catalog_text(1000, seed=7, epoch_spread_days=2.0) + "\n"
        + "\n".join(line for pair in failing + [decaying] for line in pair),
        device=DEVICE)
    irez = np.asarray(small.deep_host.irez)
    print(f"# phase 2d: small mixed catalog: {len(small)} sats, "
          f"{small.n_deep} deep (irez 0/1/2: "
          f"{[int((irez[small.is_deep] == k).sum()) for k in range(3)]}, "
          f"Lyddane {int((small.host.inclo[small.is_deep] < 0.2).sum())})")
    n = len(small)
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    col = torch.linspace(-4320.0, 4320.0, 37, dtype=torch.float64,
                         device=DEVICE)[:, None]
    dense = col + (torch.rand((37, n), generator=gen, dtype=torch.float64,
                              device=DEVICE) - 0.5) * 1800.0
    worst = {"dense": 0.0, "escape": 0.0, "scan": 0.0}

    def dense_case(cat, t, label, codes=None, staging=None):
        st = staging or cat.f64_staging
        kw = dict(grav=cat.grav, sdp4=st.fields.shape[0] == 83)
        before = launches()["sgp4_f64_dense"]
        dr, _ = _f64_vs_plain(
            f"DENSE ({'SDP4' if kw['sdp4'] else 'SGP4'}), {label}",
            lambda want_vel: cuda_sgp4.sgp4_f64_dense(
                t, *st, **kw, want_vel=want_vel),
            lambda: cuda_sgp4.sgp4_f64_dense_reference(t, *st, **kw),
            codes)
        check(launches()["sgp4_f64_dense"] == before + 2,
              f"DENSE {label}: not one launch a call")
        worst["dense"] = max(worst["dense"], dr)

    dense_case(small, dense, f"{n} sats x 37 times (dense, +-3 days)",
               codes={0, 1, 6})
    dense_case(small, col.contiguous(), f"{n} sats x 37 times (column)")
    deep_lines = GOLDEN_DEEP_TLES.splitlines()
    geo = build_catalog("\n".join(deep_lines[:2]), device=DEVICE)
    fold = (torch.arange(64 * 512, dtype=torch.float64, device=DEVICE)
            .reshape(64, 512) * 60.0 - 10 * 1440.0)
    dense_case(geo, fold, "GEO golden TLE folded to (64, 512), -10 .. +12 "
               "days", codes={0})
    near = build_catalog(near_earth_catalog_text(333, seed=7,
                                                 epoch_spread_days=2.0)
                         + "\n" + "\n".join(decaying), device=DEVICE)
    dense_case(near, dense[:, :len(near)].contiguous(),
               f"{len(near)} near-earth sats x 37 times", codes={0, 1})
    iss = build_catalog(GOLDEN_L1 + "\n" + GOLDEN_L2, device=DEVICE)
    dense_case(iss, fold, "ISS folded to (64, 512)", codes={0})
    chunk = next(single_sat_chunks(*SINGLE_SAT_SCENARIOS[-1][1:]))
    dense_case(iss, chunk, f"ISS x {tuple(chunk.shape)} (one 1year_1s "
               "chunk)", codes={0},
               staging=f64_staging(single_sat_elements(iss)))

    # the headline mixed catalog x N_TIMES minutes since each epoch; and
    # the same with the epochs spread, where the carried resonance saves
    # the most steps
    t_head = torch.arange(N_TIMES, dtype=torch.float64, device=DEVICE)
    dense_case(headline_cat, _headline_tsince(headline_cat),
               f"the headline {N_SATS} sats x {N_TIMES} times")
    dense_case(spread_cat, _headline_tsince(spread_cat),
               f"the headline generator's {N_SATS} sats, epochs spread over "
               f"+-{SPREAD_DAYS:g} days, x {N_TIMES} times")

    def epochs_case(cat, jd, fr, label):
        # DENSE as _propagate_f64 runs it: the tsince of each point formed
        # in the kernel from the jd and fr rows, against the plain
        # function on the grid torch forms from the same rows
        st = cat.f64_staging
        kw = dict(grav=cat.grav, sdp4=cat.deep is not None)
        before = launches()
        dr, _ = _f64_vs_plain(
            f"DENSE from the jd and fr rows "
            f"({'SDP4' if kw['sdp4'] else 'SGP4'}), {label}",
            lambda want_vel: cuda_sgp4.sgp4_f64_dense_epochs(
                jd, fr, *st, **kw, want_vel=want_vel),
            lambda: cuda_sgp4.sgp4_f64_dense_reference(
                cuda_sgp4.epoch_tsince(jd, fr, cat.els.epoch_jd), *st, **kw))
        after = launches()
        check(all(after[k] == before[k] + 2 for k in (
            "sgp4_f64_dense", "sgp4_f64_dense_epochs")),
              f"DENSE from the rows, {label}: not one launch a call")
        worst["dense"] = max(worst["dense"], dr)

    # the main path's shape: a day of N_TIMES one-minute epochs as the
    # benchmark's sweeps send them (the day in jd, the minutes in fr)
    day_fr = t_head / 1440.0
    for cat, name in ((headline_cat, f"the headline {N_SATS} sats"),
                      (spread_cat, f"the headline generator's {N_SATS} "
                       f"sats, epochs spread over +-{SPREAD_DAYS:g} days")):
        epochs_case(cat, torch.full_like(day_fr, EPOCH_JD + 1.0), day_fr,
                    f"{name} x {N_TIMES} epochs")
    days = col[:, 0] / 1440.0
    jd, fr = EPOCH_JD + days.floor(), days - days.floor()
    epochs_case(small, jd, fr, f"{n} sats x 37 epochs (+-3 days)")
    epochs_case(near, jd, fr, f"{len(near)} near-earth sats x 37 epochs")
    epochs_case(small, jd[:1], fr[:1], f"{n} sats x 1 epoch")
    worst["escape"] = _escape_vs_plain(
        headline_cat, t_head, f"the headline's {len(headline_cat.heo_escape.idx)}"
        f" escape lanes x {N_TIMES}")[0]
    if small.heo_escape is not None:
        worst["escape"] = max(worst["escape"], _escape_vs_plain(
            small, col[:, 0] + 2880.0,
            f"the small catalog's {len(small.heo_escape.idx)} escape lanes "
            "x 37")[0])

    # propagate(scan_times=True): DENSE on the jd and fr rows, one launch
    # a call, against the plain scan on torch's grid of the same rows and
    # against propagate(scan_times=False)
    days = np.linspace(-3.0, 3.0, SCREEN_TIMES)
    for cat, name in ((headline_cat, f"{N_SATS} headline sats"),
                      (small, f"{n} small-catalog sats")):
        for order in ("forward", "backward"):
            d = days if order == "forward" else days[::-1].copy()
            jd_h, fr_h = EPOCH_JD + np.floor(d), d - np.floor(d)
            jd, fr = (torch.as_tensor(a, device=DEVICE) for a in (jd_h, fr_h))
            before = launches()
            dr, _ = _f64_vs_plain(
                f"propagate(scan_times=True), {name} x {SCREEN_TIMES} epochs "
                f"{order}",
                lambda want_vel: propagate(cat, jd_h, fr_h, method="f64",
                                           scan_times=True,
                                           velocities=want_vel),
                lambda: cuda_sgp4.sgp4_f64_scan_reference(
                    jd, fr, *cat.f64_staging, grav=cat.grav))
            after = launches()
            check(all(after[k] == before[k] + 2 for k in (
                "sgp4_f64_dense", "sgp4_f64_dense_epochs")),
                  f"scan_times=True, {name}: not one launch of DENSE on the "
                  "rows a call")
            worst["scan"] = max(worst["scan"], dr)
            scan = propagate(cat, jd_h, fr_h, method="f64", scan_times=True)
            dense = propagate(cat, jd_h, fr_h, method="f64")
            same = all(_same_or_both_nan(a, b)
                       for a, b in zip(scan[:2], dense[:2]))
            print(f"# phase 2d: scan_times=True equals scan_times=False "
                  f"({name} x {SCREEN_TIMES} epochs {order}): {same}")
            check(same and torch.equal(scan[2], dense[2]),
                  f"scan_times=True differs from DENSE on {name} {order}")
    return worst


def geodetic_trips(x, y, z, trips=10):
    """The latitude iteration of ``frames.ecef_to_geodetic_xyz`` as the
    epilogue kernel ends it (``csrc/finalize.cu`` ``geodetic``: where lat
    repeats its bit pattern), in plain torch on the points' device:
    ``(stop, cycle)``, the trips (next lats) each point takes, at most
    ``trips``, and where a two-value cycle ends it. Each trip runs the
    plain version's ops on the whole tensors, so on the card its lats are
    the plain version's bits, and the kernel's."""
    from astroz_tpu_torch.constants import WGS84, WGS84_ECC_SQ

    a = torch.tensor(WGS84.radius_earth_km, dtype=x.dtype, device=x.device)
    e2 = WGS84_ECC_SQ
    ity = torch.int32 if x.dtype == torch.float32 else torch.int64
    p = torch.sqrt(x * x + y * y)
    p_safe = torch.where(p > 1e-12, p, torch.full_like(p, 1e-12))
    lat = torch.atan2(z, p_safe * (1.0 - e2))
    prev = lat
    stop = torch.full(lat.shape, trips, dtype=torch.int64, device=x.device)
    live = torch.ones(lat.shape, dtype=torch.bool, device=x.device)
    cycle = torch.zeros_like(live)
    for i in range(trips):
        sin_lat = torch.sin(lat)
        n = a / torch.sqrt(1.0 - e2 * sin_lat * sin_lat)
        alt = p_safe / torch.cos(lat) - n
        nxt = torch.atan2(z, p_safe * (1.0 - e2 * n / (n + alt)))
        fixed = live & (nxt.view(ity) == lat.view(ity))
        two = live & ~fixed & (nxt.view(ity) == prev.view(ity))
        stop = torch.where(fixed | two, i + 1, stop)
        cycle |= two
        live &= ~(fixed | two)
        prev, lat = lat, nxt
    return stop, cycle


def trips_report(ecef, label, smi=None):
    """Prints the trips of the latitude iteration (:func:`geodetic_trips`)
    over the (3, T, S) ECEF planes ``ecef``: a histogram of the points, the
    two-value cycles, and the trips a point that the kernel's warps run:
    the flat walk's (a thread VEC neighbouring points one after another,
    each point of a warp's 32 threads as long as the longest) and the tile
    walk's (a thread VEC times of a lane, 32 neighbouring lanes a warp).
    Returns them as a dict."""
    stop, cycle = geodetic_trips(*ecef)
    n_times, n_sats = stop.shape
    vec = 16 // ecef.element_size()
    flat = stop.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, -flat.numel() % (32 * vec)))
    flat_warp = flat.view(-1, 32, vec).amax(1).double().sum().item()
    tile = torch.nn.functional.pad(stop, (0, -n_sats % 32))
    tile_warp = tile.view(n_times, -1, 32).amax(-1).double().sum().item()
    hist = torch.bincount(stop.reshape(-1), minlength=11).tolist()
    out = {"histogram": hist, "cycles": int(cycle.sum().item()),
           "mean": stop.double().mean().item(),
           "flat_warp": 32 * flat_warp / stop.numel(),
           "tile_warp": 32 * tile_warp / stop.numel()}
    where = f" [{smi}]" if smi else ""
    print(f"# trips{where}: {label}: trips of the latitude iteration a "
          f"point (1-10: {hist[1:]}), mean {out['mean']:.3f}; "
          f"{out['cycles']} two-value cycles; the warps run "
          f"{out['flat_warp']:.3f} trips a point in the flat walk, "
          f"{out['tile_warp']:.3f} in the tile walk (10 before)")
    return out


def _same_bits(a, b):
    """Equal bit for bit (a signed zero too), NaN where NaN."""
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a)
    if a.dtype != b.dtype or not torch.equal(nan, torch.isnan(b)):
        return False
    ity = torch.int32 if a.dtype == torch.float32 else torch.int64
    return torch.equal(a.view(ity)[~nan], b.view(ity)[~nan])


def cycle_points(source, dtype, jd, n=1 << 20, seed=5):
    """TEME points (k, 3) whose ECEF images at Julian date ``jd``, as the
    plain epilogue rotates them on the card, end the latitude iteration in
    a two-value cycle there: found among ``n`` seeded points at
    6,600-42,300 km."""
    from astroz_tpu_torch.ops import cuda_finalize as cf

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    u = torch.randn((3, 1, n), generator=gen, device=DEVICE,
                    dtype=torch.float64)
    u = u / u.norm(dim=0)
    r = (u * (6600.0 + 35700.0 * torch.rand(
        (1, 1, n), generator=gen, device=DEVICE,
        dtype=torch.float64))).to(dtype)
    src = r if source == "planes" else r.permute(1, 2, 0).contiguous()
    err = torch.zeros((1, n), dtype=torch.int32, device=DEVICE)
    jd_sum = torch.tensor([[jd]], dtype=torch.float64, device=DEVICE)
    ecef = cf.finalize_reference(src, None, err, jd_sum, source=source,
                                 output="ecef", layout="planes",
                                 velocities=False)[0]
    cycle = geodetic_trips(*ecef)[1].reshape(-1)
    return r[:, 0, cycle].T


def _with_planted_points(r, v, err, jd_sum, source):
    """Copies of a sweep's outputs with a lane failing from the middle row
    on (zero-filled, code 6, as the kernels write it), two points on the
    pole axis (x = y = 0), two on the equator (z = +0.0 and -0.0), one
    under the 1e-12 clamp of p, and up to 256 points of row 13 that end
    the latitude iteration in a two-value cycle on the card
    (:func:`cycle_points`); returns them and the cycles planted."""
    r, v, err = r.clone(), v.clone(), err.clone()
    n_times, n_sats = err.shape
    lane, pole = n_sats // 3, n_sats // 2
    cycles = cycle_points(source, r.dtype, jd_sum[13, 0].item())[:256]
    k = len(cycles)
    rows = r if source == "planes" else r.permute(2, 0, 1)
    if source == "planes":
        r[:, n_times // 2:, lane] = v[:, n_times // 2:, lane] = 0.0
    else:
        r[n_times // 2:, lane] = v[n_times // 2:, lane] = 0.0
    rows[:2, 7, pole] = rows[:2, 11, pole + 1] = 0.0
    rows[2, 12, pole] = 0.0
    rows[2, 12, pole + 1] = -0.0
    rows[:2, 12, pole + 2] = 1e-13
    rows[:, 13, pole:pole + k] = cycles.T
    err[n_times // 2:, lane] = 6
    return r, v, err, k


def _epilogue_vs_plain(r, v, err, jd_sum, source, label):
    """The epilogue kernel against its plain version in every output x
    layout x velocities x mask (every third lane masked), bit for bit
    (NaN where NaN), one launch a call and none in the identity cases;
    returns the largest difference (0 where both are NaN)."""
    from astroz_tpu_torch.ops import cuda_finalize as cf

    name = "finalize_f32" if r.dtype == torch.float32 else "finalize_f64"
    r, v, err, n_cycles = _with_planted_points(r, v, err, jd_sum, source)
    check(n_cycles > 0, f"phase 2e: no two-value-cycle point found for "
          f"{name}")
    mask = torch.arange(err.shape[1], device=DEVICE) % 3 != 0
    worst, forms = 0.0, 0
    for output in cf.OUTPUT_MODES:
        for layout in cf.LAYOUTS:
            for velocities in (True, False):
                for m in (None, mask):
                    kw = dict(source=source, output=output, layout=layout,
                              velocities=velocities, mask=m)
                    what = (f"phase 2e: {name} on {label}, {output} "
                            f"{layout} velocities={velocities} "
                            f"mask={m is not None}")
                    before = cf.LAUNCHES[name]
                    got = cf.finalize(r, v, err, jd_sum, **kw)
                    sync()
                    identity = cf.is_identity(source, output, layout, m)
                    check(cf.LAUNCHES[name] == before + (not identity),
                          f"{what}: launches")
                    want = cf.finalize_reference(r, v, err, jd_sum, **kw)
                    for a, b in zip(got, want):
                        check((a is None) == (b is None), f"{what}: v")
                        if b is None:
                            continue
                        check(a.shape == b.shape and a.dtype == b.dtype
                              and _same_bits(a, b),
                              f"{what}: differs from the plain version")
                        both = ~(torch.isnan(a) | torch.isnan(b)) \
                            if a.is_floating_point() else None
                        d = (a - b) if both is None else (a - b)[both]
                        worst = max(worst, float(d.abs().max().item())
                                    if d.numel() else 0.0)
                    forms += 1
                    del got, want
    print(f"# phase 2e: the epilogue kernel ({name}) on {label}: {forms} "
          f"forms (4 frames x 3 layouts x velocities x mask), a failed "
          f"lane, pole-axis, signed-zero-equator and clamped points and "
          f"{n_cycles} points of two-value cycles planted, bit-equal to "
          f"the plain version (bit patterns, NaN where NaN; max diff "
          f"{worst:.1e}); one launch a call, none for TEME in the sweep's "
          f"own layout without a mask")
    return worst


def phase2e_epilogue_and_tables(near_cat, mixed_cat, spread_cat):
    """The epilogue kernel (csrc/finalize.cu) on the headline near-earth
    and mixed planes (K1; K2, the escape and K3) and on the f64 DENSE
    output of the mixed catalog, and TABLES (csrc/sgp4_deep.cu) at depths
    4 and 8 on the mixed and the +-7-day catalogs, bit for bit against
    their plain versions. Returns the largest differences."""
    from astroz_tpu_torch.ops import cuda_sgp4, fast
    from astroz_tpu_torch.propagation import _fast_planes, resonance_steps

    times = np.arange(float(N_TIMES))
    t_time = torch.as_tensor(times, dtype=torch.float64, device=DEVICE)
    jd_sum = torch.as_tensor((EPOCH_JD + times / 1440.0)[:, None],
                             dtype=torch.float64, device=DEVICE)
    err = {"f32": 0.0}
    for cat, label in ((near_cat, "the near-earth planes"),
                       (mixed_cat, "the mixed planes")):
        steps = (resonance_steps(EPOCH_JD + times / 1440.0,
                                 cat.deep_epochs_jd) if cat.has_deep else 0)
        planes = _fast_planes(cat, t_time, steps, True)
        err["f32"] = max(err["f32"], _epilogue_vs_plain(
            *planes, jd_sum, "planes", f"{label} ({N_SATS} x {N_TIMES})"))
        del planes
    dense = cuda_sgp4.sgp4_f64_dense(
        _headline_tsince(mixed_cat), *mixed_cat.f64_staging,
        grav=mixed_cat.grav, sdp4=True, want_vel=True)
    err["f64"] = _epilogue_vs_plain(
        *dense, jd_sum, "time_major",
        f"the mixed f64 DENSE output ({N_TIMES} x {N_SATS} x 3)")
    del dense
    err["tables"] = 0.0
    for cat, label in ((mixed_cat, "mixed"), (spread_cat, "+-7-day")):
        for steps in (4, 8):
            before = cuda_sgp4.LAUNCHES["resonance_tables"]
            got = cuda_sgp4.resonance_tables(cat.deep_sub, cat.els_deep,
                                             steps)
            sync()
            check(cuda_sgp4.LAUNCHES["resonance_tables"] == before + 1,
                  f"phase 2e: TABLES {label} depth {steps}: launches")
            want = fast.resonance_tables_reference(cat.deep_sub,
                                                   cat.els_deep, steps)
            check(torch.equal(got, want), f"phase 2e: TABLES on the "
                  f"{label} catalog at depth {steps} differs from its "
                  f"plain version by {_max_diff(got, want)}")
            err["tables"] = max(err["tables"], _max_diff(got, want))
    print(f"# phase 2e: TABLES bit-equal to its plain version on the "
          f"mixed and the +-7-day catalogs' {mixed_cat.n_deep} deep lanes "
          f"at depths 4 and 8, one launch a call")
    return err


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
    n1 = {k: n for k, n in launches().items() if n}
    r_e, v_e, e_e = con.propagate(times, start_time=EPOCH_JD,
                                  layout="planes", output="ecef")
    n2 = {k: n for k, n in launches().items() if n}
    r_t, v_t, e_t = con.propagate(times, start_time=EPOCH_JD)
    sync()
    n3 = {k: n for k, n in launches().items() if n}
    print(f"# phase 3: kernel launches after each call {[n1, n2, n3]}")
    check([n1, n2, n3] == [
        {"sgp4_shallow": 1}, {"sgp4_shallow": 2, "finalize_f32": 1},
        {"sgp4_shallow": 3, "finalize_f32": 2}],
        "each propagate call must launch K1 exactly once, and the epilogue "
        "kernel once for ECEF and time-major (never for TEME planes); "
        "nothing else")

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
    return con, n3


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


def _regime_gates(cat, r_p, e_p, tag):
    """A mixed sweep's sanity gates: more than 90% healthy points, and
    the healthy |r| of each regime (LEO, GEO, GPS/HEO) in its band;
    prints the error codes and each regime's range. Returns the regimes'
    column masks."""
    irez = np.zeros(len(cat), np.int64)
    irez[cat.deep_idx] = np.asarray(cat.deep_host.irez)[cat.deep_idx]
    kinds = {"LEO": ~cat.is_deep, "GEO": cat.is_deep & (irez == 1),
             "GPS/HEO": cat.is_deep & (irez != 1)}
    bands = {"LEO": LEO_BAND_KM,
             "GEO": (GEO_RADIUS_KM - GEO_BAND_KM,
                     GEO_RADIUS_KM + GEO_BAND_KM),
             "GPS/HEO": HEO_BAND_KM}
    radius = r_p.norm(dim=0)
    share = (e_p == 0).float().mean().item()
    print(f"# {tag}: healthy points {share:.6f}, error codes "
          f"{sorted(set(torch.unique(e_p).tolist()))}")
    check(share > 0.9, f"only {share} of the points are healthy")
    for kind, cols in kinds.items():
        idx = torch.as_tensor(np.nonzero(cols)[0], device=DEVICE)
        rad = radius[:, idx][e_p[:, idx] == 0]
        lo, hi = rad.min().item(), rad.max().item()
        print(f"# {tag}: {kind}: {len(idx)} columns, healthy |r| "
              f"{lo:.1f} .. {hi:.1f} km (band {bands[kind]})")
        check(bands[kind][0] < lo and hi < bands[kind][1],
              f"{kind} |r| outside its band")
    return kinds


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
    calls.append(launches())
    r_e, v_e, e_e = con.propagate(times, start_time=EPOCH_JD,
                                  layout="planes", output="ecef")
    calls.append(launches())
    r_t, v_t, e_t = con.propagate(times, start_time=EPOCH_JD)
    sync()
    calls.append(launches())
    calls = [{k: n for k, n in c.items() if n} for c in calls]
    print(f"# phase 3b: kernel launches after each call {calls}")
    check([(n["sgp4_deep"], n["sgp4_f64_escape"], n["sgp4_shallow_merge"],
            n["resonance_tables"], n.get("finalize_f32", 0))
           for n in calls] == [(1, 1, 1, 1, 0), (2, 2, 2, 1, 1),
                               (3, 3, 3, 1, 2)],
          "each mixed propagate call must launch K2, the f64 kernel's "
          "escape and K3 exactly once, the epilogue kernel once for ECEF "
          "and time-major (never for TEME planes), TABLES at the catalog's "
          "first sweep only")
    check("sgp4_shallow" not in calls[-1], "the mixed path launched K1")

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

    kinds = _regime_gates(cat, r_p, e_p, "phase 3b")

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
    return con, calls[-1]


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
    check(n["sgp4_shallow_dense"] == n["sgp4_shallow_grids"]
          == n["sgp4_spine_grids"] == n_chunks
          and sum(n.values()) == 3 * n_chunks,
          "each chunk must launch K5 once, the spine kernel once and K6 "
          "once, and nothing else")
    check(gold_f64 < 0.1, "the f64 path is off the python-sgp4 trajectory")
    return n


def _fast_vs_f64_gates(cat, lane_worst, label, share):
    """Print the worst lane of each regime of the mixed catalog ``cat``
    (fast vs f64 distance a lane, km, healthy points only) and hold them
    to the gates: 50 m near earth, 100 m anywhere, 5 m on escape lanes."""
    irez = np.asarray(cat.deep_host.irez)
    escape = np.isin(np.arange(len(cat)),
                     cat.deep_idx[cat.heo_escape.idx.cpu().numpy()])
    regimes = {"LEO": ~cat.is_deep, "GEO": irez == 1,
               "half-day": (irez == 2) & ~escape,
               "other deep": cat.is_deep & (irez == 0), "escape": escape}
    print(f"# {label}: fast vs f64 on healthy points ({share:.6f} of them), "
          "worst lane by regime: " + ", ".join(
              f"{k} {lane_worst[m].max() * 1e3:.3f} m (lane "
              f"{np.nonzero(m)[0][lane_worst[m].argmax()]}, "
              f"e {cat.host.ecco[m][lane_worst[m].argmax()]:.4f})"
              for k, m in regimes.items()))
    # near-earth lanes at the JAX package's 50 m; deep lanes at the
    # reference's 100 m budget (README.md): its f32 deep tail is ~60 m
    # off on half-day lanes just under the escape's e > 0.7
    check(lane_worst[regimes["LEO"]].max() < 0.05,
          f"{label}: near-earth lanes over 0.05 km from f64")
    check(lane_worst.max() < 0.1, f"{label}: fast is over 0.1 km from f64")
    check(lane_worst[escape].max() < 5e-3,
          f"{label}: escape lanes over 5e-3 km from f64")


def phase3d_f64_path(mcon):
    """The f64 main path; returns the milliseconds of its scan_times call
    (host clock around synchronized work), that call's peak device memory
    in bytes, its launches of the f64 kernel and the launches of the
    three propagate calls by kernel."""
    from astroz_tpu_torch import propagate, propagate_tsince
    from astroz_tpu_torch.ops import cuda_sgp4, sdp4_propagate

    cat = mcon.catalog
    times = np.arange(float(N_TIMES))
    kw = dict(start_time=EPOCH_JD, method="f64")
    reset_launches()
    calls = []
    r_p, v_p, e_p = mcon.propagate(times, layout="planes", **kw)
    calls.append({k: v for k, v in launches().items() if v})
    r_t, v_t, e_t = mcon.propagate(times, **kw)
    calls.append({k: v for k, v in launches().items() if v})
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
    calls.append({k: v for k, v in launches().items() if v})
    n = launches()
    print(f"# phase 3d: f64 propagate of {N_SATS} mixed x {N_TIMES}: planes, "
          f"time_major and scan_times=True ({scan_ms:.1f} ms); kernel "
          f"launches after each call {calls}")
    check(calls == [{"sgp4_f64_dense": 1, "sgp4_f64_dense_epochs": 1,
                     "finalize_f64": 1},
                    {"sgp4_f64_dense": 2, "sgp4_f64_dense_epochs": 2,
                     "finalize_f64": 1},
                    {"sgp4_f64_dense": 3, "sgp4_f64_dense_epochs": 3,
                     "finalize_f64": 2}],
          "each f64 propagate call must launch the f64 kernel once (DENSE "
          "on the jd and fr rows, with scan_times=True too), the epilogue "
          "kernel once for planes (never for TEME time-major) and nothing "
          "else")
    scan_launches = calls[2]["sgp4_f64_dense"] - calls[1]["sgp4_f64_dense"]
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
    check(_same_or_both_nan(r_s, r_p) and _same_or_both_nan(v_s, v_p),
          "scan differs from dense")
    # the scan call's output against the plain scan on the tsince grid
    # of the same jd (fr 0), bit for bit
    jd = torch.as_tensor(EPOCH_JD + times / 1440.0, device=DEVICE)
    t0 = time.perf_counter()
    r_q, v_q, e_q = cuda_sgp4.sgp4_f64_scan_reference(
        jd, torch.zeros_like(jd), *cat.f64_staging, grav=cat.grav)
    sync()
    plain_s = time.perf_counter() - t0
    r_q, v_q = r_q.permute(2, 0, 1), v_q.permute(2, 0, 1)
    print(f"# phase 3d: scan_times=True vs the plain scan "
          f"(sdp4_propagate_scan, {plain_s:.1f} s) on the same "
          f"{N_TIMES} x {N_SATS} tsince: max|dr| "
          f"{_max_diff(r_s, r_q):.3e} km, max|dv| {_max_diff(v_s, v_q):.3e} "
          f"km/s, codes equal {torch.equal(e_s, e_q)}")
    check(torch.equal(e_s, e_q) and _same_or_both_nan(r_s, r_q)
          and _same_or_both_nan(v_s, v_q),
          "scan_times=True differs from the plain scan at the main path's "
          "shape")
    del r_t, v_t, r_s, v_s, r_q, v_q, e_q

    r_f, _, e_f = mcon.propagate(times, start_time=EPOCH_JD,
                                 layout="planes", velocities=False)
    check(torch.equal(e_f, e_p), "fast and f64 error codes differ")
    ok = e_p == 0
    dist = (r_f.double() - r_p).norm(dim=0).masked_fill(~ok, 0.0)
    del r_f
    lane_worst = dist.amax(dim=0).cpu().numpy()
    share = ok.float().mean().item()
    _fast_vs_f64_gates(cat, lane_worst, "phase 3d", share)

    d_gold = _golden_deep("f64")
    print(f"# phase 3d: GEO and Molniya golden vectors through f64 max|dr| "
          f"{d_gold * 1e3:.3f} m")
    check(d_gold < 0.01, "f64 deep golden vectors off by more than 0.01 km")
    t = torch.linspace(0.0, 1440.0, 16, dtype=torch.float64,
                       device=DEVICE)[:, None]
    before = launches()["sgp4_f64_dense"]
    a = propagate_tsince(cat, t)
    check(launches()["sgp4_f64_dense"] == before + 1,
          "propagate_tsince must launch the f64 kernel once")
    b = sdp4_propagate(cat.els, cat.deep, t, cat.grav)
    check(all(torch.equal(x, y) for x, y in zip(a, b[:3])),
          "propagate_tsince differs from sdp4_propagate")
    print("# phase 3d: propagate_tsince on a (16, 1) grid (one launch of the "
          "f64 kernel) equals sdp4_propagate bit for bit")
    return scan_ms, scan_peak, scan_launches, n


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


def _graph_ms(fn, reps, per_graph=10):
    """The mean time of a call of ``fn`` (a kernel's wrapper, which syncs
    nothing) replayed from a CUDA graph: ``per_graph`` calls are captured
    once and the graph replayed until ``reps`` calls ran, between CUDA
    events. The card never waits for the host, so a kernel shorter than
    its wrapper's host time is timed at its own length."""
    fn()
    sync()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    replays = max(1, reps // per_graph)
    graph.replay()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    sync()
    ms = start.elapsed_time(end) / (replays * per_graph)
    del graph
    return ms


def _host_us(fn, reps):
    """The host's microseconds a call of ``fn`` takes to return, the card
    not waited for."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e6
    sync()
    return host


class Turns(NamedTuple):
    """A kernel and its plain version timed in turns: plain, kernel
    launched back to back (:func:`_cuda_ms`, host gaps included), kernel
    replayed from a CUDA graph (:func:`_graph_ms`, its own time) twice,
    kernel back to back, plain."""
    times: tuple

    @property
    def ms(self):
        return (self.times[1] + self.times[4]) / 2

    @property
    def device_ms(self):
        return (self.times[2] + self.times[3]) / 2

    @property
    def plain_ms(self):
        return (self.times[0] + self.times[5]) / 2

    def text(self, name):
        t = self.times
        return (f"kernel {name} {self.ms:.4f} ms launched back to back "
                f"({t[1]:.4f}, {t[4]:.4f}), {self.device_ms:.4f} ms replayed "
                f"from a CUDA graph ({t[2]:.4f}, {t[3]:.4f}); plain torch "
                f"version {self.plain_ms:.4f} ms ({t[0]:.4f}, {t[5]:.4f})")


def _in_turns(kernel, plain, reps_kernel, reps_plain):
    """:class:`Turns` of ``kernel`` and ``plain``."""
    return Turns((_cuda_ms(plain, reps_plain), _cuda_ms(kernel, reps_kernel),
                  _graph_ms(kernel, reps_kernel),
                  _graph_ms(kernel, reps_kernel),
                  _cuda_ms(kernel, reps_kernel), _cuda_ms(plain, reps_plain)))


def phase4_timings(con, smi):
    from astroz_tpu_torch.ops import cuda_sgp4

    cat = con.catalog
    st = cat.fast_staging
    t_time = torch.arange(N_TIMES, dtype=torch.float64, device=DEVICE)
    args = (t_time, st.t_sat, st.spine, st.tail, st.flags)
    kw = dict(grav=cat.grav, kepler_iters=cat.kepler_iters)
    k1 = _in_turns(
        lambda: cuda_sgp4.propagate_fast_sep(*args, **kw),
        lambda: cuda_sgp4.propagate_fast_sep_reference(*args, **kw), 20, 3)
    times = np.arange(float(N_TIMES))
    call_planes = _cuda_ms(lambda: con.propagate(
        times, start_time=EPOCH_JD, layout="planes"), 10)
    call_tm = _cuda_ms(lambda: con.propagate(times, start_time=EPOCH_JD), 10)
    props = N_SATS * N_TIMES
    print(f"# phase 4 [{smi}]: {k1.text('K1')} "
          f"({props / k1.ms / 1e6:.3f} G props/s)")
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
    return k1, k1_bound


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
    k2 = _in_turns(
        lambda: cuda_sgp4.propagate_deep_sep(*dargs, **dkw),
        lambda: cuda_sgp4.propagate_deep_sep_reference(*dargs, **dkw),
        50, 3)
    k2_host = _host_us(lambda: cuda_sgp4.propagate_deep_sep(*dargs, **dkw),
                       50)
    dr, dv, de = cuda_sgp4.propagate_deep_sep(*dargs, **dkw)
    # the escape writes its columns of K2's planes in place, the same
    # values every call
    esc = cat.heo_escape
    eargs = (t_time, esc.t_sat, *esc.staged, esc.idx, tables, dr, dv, de)
    ekw = dict(grav=cat.grav)
    escape = _in_turns(
        lambda: cuda_sgp4.sgp4_f64_escape(*eargs, **ekw),
        lambda: cuda_sgp4.sgp4_f64_escape_reference(*eargs, **ekw), 50, 3)
    apply_ms = _cuda_ms(lambda: _apply_escape(
        esc, tables, t_time, cat.grav, True, dr, dv, de), 50)
    margs = (t_time, st.t_sat, st.spine, st.tail, st.flags, ds.slot, dr, dv,
             de)
    mkw = dict(grav=cat.grav, kepler_iters=cat.kepler_iters)
    maps = dict(maps=ds.maps)
    k3 = _in_turns(
        lambda: cuda_sgp4.propagate_fast_sep_merge(*margs, **mkw, **maps),
        lambda: cuda_sgp4.propagate_fast_sep_merge_reference(*margs, **mkw),
        20, 3)
    tab_turns = _in_turns(
        lambda: cuda_sgp4.resonance_tables(cat.deep_sub, cat.els_deep, steps),
        lambda: fast.resonance_tables_reference(cat.deep_sub, cat.els_deep,
                                                steps), 50, 3)
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
    print(f"# phase 4b [{smi}]: {k2.text('K2')} ({cat.n_deep} x "
          f"{N_TIMES}); its wrapper's host time {k2_host:.1f} us a call")
    print(f"# phase 4b [{smi}]: {k3.text('K3')} "
          f"({props / k3.ms / 1e6:.3f} G props/s)")
    n_esc = len(esc.idx)
    print(f"# phase 4b [{smi}]: HEO escape ({n_esc} lanes x {N_TIMES}): "
          f"{escape.text('f64 ESCAPE')}; _apply_escape {apply_ms:.4f} ms")
    print(f"# phase 4b [{smi}]: resonance tables (depth {steps}, once per "
          f"catalog and depth): {tab_turns.text('TABLES')}")
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
        *margs, **mkw, **maps)), k1_ops[0] * near, k1_ops[1] * near)
    esc_ops = count_ops(lambda: cuda_sgp4.sgp4_f64_escape_reference(
        *eargs, **ekw))
    # the escape reads its lanes' fields and table columns and writes its
    # columns of the planes (r, v f32 and the code)
    esc_bytes = (nbytes(t_time, esc.t_sat, *esc.staged, esc.idx)
                 + tables.shape[0] * tables.shape[1] * n_esc * 8
                 + 28 * n_esc * N_TIMES)
    esc_bound = bound(esc_bytes, *esc_ops)
    # TABLES reads its field matrix and writes the tables
    tab_ops = count_ops(lambda: fast.resonance_tables_reference(
        cat.deep_sub, cat.els_deep, steps))
    tab_bound = bound(
        nbytes(cuda_sgp4._resonance_fields(cat.deep_sub, cat.els_deep),
               cuda_sgp4.resonance_tables(cat.deep_sub, cat.els_deep,
                                          steps)), *tab_ops)
    print(f"# phase 4b: K2 bound {k2_bound[0]:.4f} ms by {k2_bound[1]} "
          f"({k2_ops[0] / (cat.n_deep * N_TIMES):.1f} f32 and "
          f"{k2_ops[1] / (cat.n_deep * N_TIMES):.1f} f64 operations a "
          f"point); K3 bound {k3_bound[0]:.4f} ms by {k3_bound[1]}; f64 "
          f"ESCAPE bound {esc_bound[0]:.5f} ms by {esc_bound[1]} "
          f"({esc_ops[1] / (n_esc * N_TIMES):.1f} f64 operations a point, "
          f"{escape.device_ms / esc_bound[0]:.1f}x its bound replayed); "
          f"TABLES bound {tab_bound[0]:.5f} ms by {tab_bound[1]} "
          f"({tab_ops[0]:.0f} f32 and {tab_ops[1]:.0f} f64 operations in "
          f"its plain version; {tab_turns.device_ms / tab_bound[0]:.1f}x its "
          f"bound replayed)")
    kernel_report(
        f"phase 4b: K2 ({cat.n_deep} x {N_TIMES}, "
        f"{cat.deep_kepler_iters} trips)",
        DEEP_KERNEL.format(cat.deep_kepler_iters),
        cuda_sgp4.launch_grid("sgp4_deep", N_TIMES, cat.n_deep,
                              kepler_iters=cat.deep_kepler_iters),
        cat.n_deep * N_TIMES, k2.device_ms, smi)
    return ((k2, k2_bound), (k3, k3_bound), (escape, esc_bound),
            (tab_turns, tab_bound))


#: phase 4d: calls of the epilogue kernel and of its plain version a turn,
#: and of propagate() a turn through each epilogue route
EPILOGUE_REPS = (20, 3)
PROPAGATE_REPS = 5
#: the one PyTorch call that computes the TEME relayout, by (the sweep's
#: layout, the caller's): permute(...).contiguous()
RELAYOUT = {("planes", "time_major"): (1, 2, 0),
            ("planes", "sat_major"): (2, 1, 0),
            ("time_major", "sat_major"): (1, 0, 2),
            ("time_major", "planes"): (2, 0, 1)}


def _relayout(r, v, err, perm, layout):
    """torch's copies of a relayout, like for like with the kernel's TEME
    form: r and v permuted, and the codes transposed for sat_major."""
    out = (r.permute(*perm).contiguous(), v.permute(*perm).contiguous())
    return out + (err.t().contiguous(),) if layout == "sat_major" else out


def _epilogue_turns(r, v, err, jd_sum, source, label, smi):
    """The epilogue kernel in every form but the identity (velocities, no
    mask) in turns with its plain version, each with its bound (bytes
    read and written once, or the plain version's operations) and the
    time of torch's copies of the relayout where the layout changes
    (:func:`_relayout`). Returns ``{(output, layout): (Turns, bound,
    library_ms)}``."""
    from astroz_tpu_torch.ops import cuda_finalize as cf

    out = {}
    for output in cf.OUTPUT_MODES:
        for layout in cf.LAYOUTS:
            if cf.is_identity(source, output, layout, None):
                continue
            kw = dict(source=source, output=output, layout=layout,
                      velocities=True)
            turns = _in_turns(
                lambda: cf.finalize(r, v, err, jd_sum, **kw),
                lambda: cf.finalize_reference(r, v, err, jd_sum, **kw),
                *EPILOGUE_REPS)
            got = cf.finalize(r, v, err, jd_sum, **kw)
            moved = nbytes(r, v, got[0], got[1])
            if got[2] is not err:
                moved += nbytes(err, got[2])
            del got
            ops = count_ops(lambda: cf.finalize_reference(r, v, err, jd_sum,
                                                          **kw))
            b = bound(moved, *ops)
            perm = RELAYOUT.get((source, layout))
            lib_ms = None
            if perm is not None:
                lib_ms = _cuda_ms(lambda: _relayout(r, v, err, perm, layout),
                                  EPILOGUE_REPS[0])
            codes = " and err.t().contiguous()" * (layout == "sat_major")
            lib_text = ("no relayout" if lib_ms is None else
                        f"permute{perm}.contiguous() of r and v{codes} "
                        f"{lib_ms:.4f} ms")
            print(f"# phase 4d [{smi}]: {label} -> {output} {layout}: "
                  f"{turns.text('finalize')}; bound {b[0]:.4f} ms by "
                  f"{b[1]} ({ops[0] / err.numel():.1f} f32 and "
                  f"{ops[1] / err.numel():.1f} f64 operations a point in "
                  f"the plain version, {turns.device_ms / b[0]:.2f}x the "
                  f"bound replayed); {lib_text}")
            out[(output, layout)] = (turns, b, lib_ms)
    return out


def _propagate_routes(cat, jd, label, smi):
    """propagate() of ``cat`` in every output x layout, fast and f64,
    through the epilogue kernel and through the plain epilogue route (the
    parent commit's: ``finalize_reference`` in place of ``finalize``), in
    turns (plain, kernel, kernel, plain; CUDA events, PROPAGATE_REPS calls
    each): the two routes' outputs bit-equal, the epilogue launched once
    a call (never in the identity forms). Returns ``{(method, output,
    layout): (kernel_ms, plain_ms)}``."""
    from astroz_tpu_torch import propagate, propagation
    from astroz_tpu_torch.ops import cuda_finalize as cf

    def plain_route(call):
        def run():
            propagation.finalize = cf.finalize_reference
            try:
                return call()
            finally:
                propagation.finalize = cf.finalize
        return run

    out = {}
    for method, source in (("fast", "planes"), ("f64", "time_major")):
        name = "finalize_f32" if method == "fast" else "finalize_f64"
        line = []
        for output in cf.OUTPUT_MODES:
            for layout in cf.LAYOUTS:
                def call():
                    return propagate(cat, jd, method=method, output=output,
                                     layout=layout)
                what = f"phase 4d: {label} {method} {output} {layout}"
                before = cf.LAUNCHES[name]
                got = call()
                sync()
                n = cf.LAUNCHES[name] - before
                check(n == (0 if cf.is_identity(source, output, layout, None)
                            else 1), f"{what}: {n} epilogue launches")
                want = plain_route(call)()
                check(all(_same_or_both_nan(a, b) for a, b in zip(got, want)),
                      f"{what}: the kernel route differs from the plain "
                      f"epilogue route")
                del got, want
                t = [_cuda_ms(f, PROPAGATE_REPS) for f in
                     (plain_route(call), call, call, plain_route(call))]
                out[(method, output, layout)] = ((t[1] + t[2]) / 2,
                                                 (t[0] + t[3]) / 2)
                line.append(f"{output} {layout} {t[1]:.3f}, {t[2]:.3f} / "
                            f"{t[0]:.3f}, {t[3]:.3f}")
        print(f"# phase 4d [{smi}]: {label} propagate(method={method!r}) x "
              f"{N_TIMES}, ms through the epilogue kernel / the plain "
              f"epilogue route, in turns (outputs bit-equal, one epilogue "
              f"launch a call, none for the identity): " + "; ".join(line))
    return out


def phase4d_epilogue_timings(con, mcon, smi):
    """The sat_major tile walk's grids; the trips of the latitude iteration
    on the mixed catalog's ECEF points (:func:`trips_report`); the epilogue
    kernel alone on the mixed catalog's planes and f64 DENSE output, every
    output x layout, in turns with its plain version
    (:func:`_epilogue_turns`); then propagate() of both catalogs through
    each epilogue route (:func:`_propagate_routes`). Returns the kernels
    line's forms: f32 TEME time-major (propagate's default) and f64 TEME
    planes, each ``(Turns, bound, library_ms)``."""
    from astroz_tpu_torch import propagate
    from astroz_tpu_torch.ops import cuda_finalize as cf

    mcat = mcon.catalog
    jd = EPOCH_JD + np.arange(float(N_TIMES)) / 1440.0
    for dtype in (torch.float32, torch.float64):
        print(f"# phase 4d: the sat_major tile walk's grid, {dtype} "
              f"{N_TIMES} x {N_SATS}: "
              f"{cf.launch_grid(dtype, N_TIMES, N_SATS)}")
    jd_sum = torch.as_tensor(jd[:, None], dtype=torch.float64,
                             device=DEVICE)
    # the identity forms hand back the sweeps' own outputs
    planes = propagate(mcat, jd, method="fast", layout="planes")
    trips_report(propagate(mcat, jd, method="fast", output="ecef",
                           layout="planes")[0],
                 f"phase 4d: mixed {N_SATS} x {N_TIMES} f32 ECEF", smi)
    f32 = _epilogue_turns(*planes, jd_sum, "planes",
                          f"mixed {N_SATS} x {N_TIMES} f32 planes", smi)
    del planes
    dense = propagate(mcat, jd, method="f64")
    trips_report(propagate(mcat, jd, method="f64", output="ecef",
                           layout="planes")[0],
                 f"phase 4d: mixed {N_SATS} x {N_TIMES} f64 ECEF", smi)
    f64 = _epilogue_turns(*dense, jd_sum, "time_major",
                          f"mixed {N_TIMES} x {N_SATS} f64 time-major", smi)
    del dense
    for cat, label in ((con.catalog, "near-earth"), (mcat, "mixed")):
        _propagate_routes(cat, jd, f"{label} {N_SATS}", smi)
    return f32[("teme", "time_major")], f64[("teme", "planes")]


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

    from astroz_tpu_torch.propagation import resonance_steps

    cat = mcon.catalog
    times = np.arange(float(SCREEN_TIMES))
    jd = EPOCH_JD + times / 1440.0
    # the catalog's tables at this grid's depth are built once (TABLES)
    fresh = resonance_steps(jd, cat.deep_epochs_jd) not in cat._tables
    reset_launches()
    res = screen_all(cat, jd, threshold_km=SCREEN_KM)
    n = launches()
    print(f"# phase 6b: screen of the mixed catalog x {SCREEN_TIMES} at "
          f"{SCREEN_KM} km: {len(res[0])} pairs, kernel launches {n}")
    check(n == {**dict.fromkeys(n, 0), "sgp4_deep": 1, "sgp4_f64_escape": 1,
                "sgp4_shallow_merge": 1, "screen_candidates": 1,
                "resonance_tables": int(fresh)},
          "the mixed screen must launch K2, the escape, K3 and K4 "
          "(candidate mode) once each, TABLES at a new depth")
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


def row_loop_instructions(lib_path, kernel):
    """The static SASS instructions of the row loop of the kernel whose
    mangled name matches the regex ``kernel``, in the library at
    ``lib_path`` as ``cuobjdump -sass`` lists it: the span of the kernel's
    widest backward branch, the loop that walks the time rows. Returns
    ``(all, hot)``: all of them, and those outside the cold fallbacks of
    ``sgp4_common.cuh:fmod_exact`` (CUDA's f64 fmod loop for |x| >=
    2^52, which these grids never reach): the block that the branch on
    its DSETP of |x| against 2^52 jumps to, up to the target of the
    branch that ends the hot side before it. ``hot`` counts both sides of
    every other branch, so it is an upper estimate of the instructions a
    warp issues a row for its 32 points: a warp whose lanes all take one
    side issues fewer (an inner loop's body is counted once). Returns
    ``(all, hot, hot_f64)``, ``hot_f64`` those of ``hot`` whose opcode is
    one of F64_OPCODES. None if the dump shows no such loop."""
    from astroz_tpu_torch import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    dump = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=600).stdout
    body = next((f for f in re.split(r"\n\s*Function : ", dump)[1:]
                 if re.search(kernel, f.split(None, 1)[0])), None)
    if body is None:
        return None
    ins = [(int(m.group(1), 16), m.group(2).strip()) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    text = dict(ins)

    def target(t, pattern=r"\bBRA\b[^;]*?(0x[0-9a-f]+)"):
        m = re.search(pattern, t)
        return int(m.group(1), 16) if m else None

    spans = [(a - target(t), target(t), a) for a, t in ins
             if target(t) is not None and target(t) < a]
    if not spans:
        return None
    _, lo, hi = max(spans)
    cold = set()
    for i, (a, t) in enumerate(ins):
        guard = re.match(r"DSETP\.GEU\.AND (P\d), PT, \|?R\d+\|?, "
                         r"4\.503599627370496\d*e\+15", t)
        if not (guard and lo <= a <= hi):
            continue
        pred = guard.group(1)
        for b, u in ins[i + 1:]:
            m = re.match(rf"^@(!?){pred} BRA (0x[0-9a-f]+)", u)
            if not m:
                if re.match(rf"^(@!?P\d\s+)?[A-Z][\w.]*\s+{pred}\b", u):
                    break  # the guard's predicate is written again
                continue
            x = int(m.group(2), 16)
            if m.group(1):  # the hot side branches away: cold falls through
                start, end = b + 16, x
            else:  # the cold side branches away, up to the hot side's jump
                start = x
                end = target(text.get(x - 16, ""), r"^BRA (0x[0-9a-f]+)")
            if end is not None and start < end <= hi + 16:
                cold.update(c for c, _ in ins if start <= c < end)
            break
    loop = [a for a, _ in ins if lo <= a <= hi]
    hot = [a for a in loop if a not in cold]

    def opcode(t):
        return re.sub(r"^@!?\w+\s+", "", t).split(None, 1)[0].split(".")[0]

    return (len(loop), len(hot),
            sum(opcode(text[a]) in F64_OPCODES for a in hot))


def kernel_report(label, kernel, grid, points, ms, smi, f64=False):
    """Print a persistent kernel's registers and spills (ptxas), its grid
    (``cuda_sgp4.launch_grid``) and its issue estimate: the hot static
    instructions of its row loop a point (:func:`row_loop_instructions`,
    both sides of each branch, so an upper estimate) x ``points`` over
    the card's issue rate (its SMs x LANES_PER_SM lanes at its largest SM
    clock), and its share of the kernel's time ``ms``: an upper estimate
    of the share of the SMs' issue slots the kernel fills. With ``f64``,
    also its f64-pipe estimate: the hot f64 instructions a point
    (F64_OPCODES) x ``points`` over the SMs x F64_LANES_PER_SM lanes at
    that clock."""
    from astroz_tpu_torch import _build

    regs = [(rg, st, ld) for name, rg, st, ld in _build.ptxas_report()
            if re.search(kernel, name)]
    check(len(regs) == 1, f"{label}: ptxas reports {regs} for {kernel}")
    rg, st, ld = regs[0]
    loop = row_loop_instructions(_build.library_path(), kernel)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = _max_sm_clock_hz()
    issue = (None if loop is None
             else loop[1] * points / (sms * LANES_PER_SM * clock) * 1e3)
    issue_text = ("not measured (no row loop found in the SASS)"
                  if issue is None else
                  f"{issue:.4f} ms ({loop[1]} SASS instructions a point in "
                  f"the row loop's hot path, both sides of each branch, of "
                  f"{loop[0]} in the loop, x {points} points over {sms} SMs "
                  f"x {LANES_PER_SM} lanes at {clock / 1e9:.3f} GHz; "
                  f"{issue / ms:.1%} of the kernel's {ms:.4f} ms replayed "
                  f"from a CUDA graph)")
    f64_ms = (None if loop is None or not f64 else
              loop[2] * points / (sms * F64_LANES_PER_SM * clock) * 1e3)
    f64_text = ("" if not f64 else
                "; f64-pipe estimate not measured (no row loop found)"
                if f64_ms is None else
                f"; f64-pipe estimate {f64_ms:.4f} ms ({loop[2]} f64 "
                f"instructions ({', '.join(F64_OPCODES)}) a point in the "
                f"row loop's hot path, both sides of each branch, x "
                f"{points} points over {sms} SMs x {F64_LANES_PER_SM} f64 "
                f"lanes at {clock / 1e9:.3f} GHz; {f64_ms / ms:.1%} of the "
                f"kernel's {ms:.4f} ms replayed)")
    print(f"# {label} [{smi}]: {rg} registers, spill stores {st} B, spill "
          f"loads {ld} B; grid: {grid['per_sm']} blocks an SM x "
          f"{grid['sms']} SMs, {grid['blocks']} blocks launched, "
          f"{grid['waves']:.3f} waves; issue estimate (upper) {issue_text}"
          f"{f64_text}")


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
        f"{K4_MODES[name.split('screen_coarse_kernelILi')[1][0]]} mode {rg} "
        f"registers, "
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


def _device_work(*fns):
    """The names of the device activities (kernels, copies, fills) that
    one call of each of ``fns``, one after the other, runs, in the order
    they started, from one ``torch.profiler`` session (a second session
    in one process lost kernel events on the card)."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            fn()
            sync()
    return [name for _, name in sorted(
        (e.time_range.start, e.name) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA)]


def phase4c_dense_timings(mcon, smi, scan_ms, scan_peak, spread_cat):
    from astroz_tpu_torch import build_catalog, propagate
    from astroz_tpu_torch.ops import cuda_sgp4, sgp4_propagate
    from astroz_tpu_torch.ops.cuda_sgp4 import f64_staging
    from astroz_tpu_torch.ops.fast import shallow_staging

    cat = build_catalog(GOLDEN_L1 + "\n" + GOLDEN_L2, device=DEVICE)
    els = single_sat_elements(cat)
    _, n_year, step_year = SINGLE_SAT_SCENARIOS[-1]
    t = next(single_sat_chunks(n_year, step_year))
    staged = shallow_staging(els)
    kw = dict(grav=cat.grav, kepler_iters=5)
    # the main path's K5: the elements staged by the first call, then
    # K5's time-major store
    k5 = _in_turns(
        lambda: cuda_sgp4.propagate_fast_fused(els, t, **kw),
        lambda: cuda_sgp4.propagate_fast_fused_reference(els, t, **kw),
        50, 3)

    # the spine kernel, then K6, then the two through propagate_fast_grids
    spine = _in_turns(
        lambda: cuda_sgp4.spine_f64_grids(t, staged[0]),
        lambda: cuda_sgp4.spine_f64_grids_reference(t, staged[0]), 50, 3)
    grids, tail, flags = cuda_sgp4.spine_grids(els, t)

    def k6_plain():
        return cuda_sgp4.propagate_fast_spine_grids_reference(
            grids, tail, flags, **kw)

    k6 = _in_turns(
        lambda: cuda_sgp4.propagate_fast_spine_grids(grids, tail, flags,
                                                     **kw), k6_plain, 50, 3)
    grids_path = _in_turns(
        lambda: cuda_sgp4.propagate_fast_grids(els, t, **kw),
        lambda: cuda_sgp4.propagate_fast_grids_reference(els, t, **kw), 50, 3)
    props = t.numel()

    def sweep(fn):
        for chunk in single_sat_chunks(n_year, step_year):
            fn(els, chunk, cat.grav)

    def fast(e, chunk, grav):
        return cuda_sgp4.propagate_fast_fused(e, chunk, grav, kepler_iters=5)

    iss_f64 = f64_staging(els)

    def f64_kernel(e, chunk, grav):
        return cuda_sgp4.sgp4_f64_dense(chunk, *iss_f64, grav=grav,
                                        sdp4=False)

    year_fast = _cuda_ms(lambda: sweep(fast), 5)
    year_f64 = _cuda_ms(lambda: sweep(sgp4_propagate), 2)
    year_f64k = _cuda_ms(lambda: sweep(f64_kernel), 5)
    peak_fast, peak_f64, peak_f64k = (_peak(lambda: sweep(fast)),
                                      _peak(lambda: sweep(sgp4_propagate)),
                                      _peak(lambda: sweep(f64_kernel)))
    device_work = _device_work(
        lambda: fast(els, t, cat.grav),
        lambda: cuda_sgp4.propagate_fast_grids(els, t, **kw))
    print(f"# phase 4c: device work of a second propagate_fast_fused call "
          f"on the same elements, then of a second propagate_fast_grids "
          f"call (torch.profiler): {device_work}")
    check(len(device_work) == 3
          and "sgp4_dense_kernel" in device_work[0]
          and "sgp4_spine_grids_kernel" in device_work[1]
          and "sgp4_dense_kernel" in device_work[2]
          and device_work[0] != device_work[2],
          "a second propagate_fast_fused call on the same elements must run "
          "K5 and nothing else on the card, and a second "
          "propagate_fast_grids call the spine kernel and K6 and nothing "
          "else")

    times = np.arange(float(N_TIMES))
    f64_kw = dict(start_time=EPOCH_JD, method="f64")
    f64_planes = _cuda_ms(lambda: mcon.propagate(times, layout="planes",
                                                 **f64_kw), 10)
    f64_tm = _cuda_ms(lambda: mcon.propagate(times, **f64_kw), 10)
    # the f64 kernel alone at the main path's shapes, in turns with its
    # plain versions: DENSE over the mixed catalog x N_TIMES (minutes since
    # each epoch, as _propagate_f64 forms them); the scan (DENSE on the jd
    # and fr rows) over the first SCREEN_TIMES epochs (the plain scan takes
    # seconds at N_TIMES rows)
    mcat = mcon.catalog
    mst = mcat.f64_staging
    tsince = _headline_tsince(mcat)
    dkw = dict(grav=mcat.grav, sdp4=True)
    f64_dense = _in_turns(
        lambda: cuda_sgp4.sgp4_f64_dense(tsince, *mst, **dkw),
        lambda: cuda_sgp4.sgp4_f64_dense_reference(tsince, *mst, **dkw),
        10, 1)
    jd_day = torch.as_tensor(EPOCH_JD + times / 1440.0, device=DEVICE)
    fr_day = torch.zeros_like(jd_day)
    jd_s, fr_s = jd_day[:SCREEN_TIMES], fr_day[:SCREEN_TIMES]
    t_scan = tsince[:SCREEN_TIMES].contiguous()
    f64_scan = _in_turns(
        lambda: cuda_sgp4.sgp4_f64_scan(jd_s, fr_s, *mst, grav=mcat.grav),
        lambda: cuda_sgp4.sgp4_f64_scan_reference(jd_s, fr_s, *mst,
                                                  grav=mcat.grav), 10, 1)
    # scan_times=True over all N_TIMES epochs against the route it replaced:
    # torch's (T, S) tsince grid of the rows, then the same row walk on it
    jd_h = EPOCH_JD + times / 1440.0

    def scan_rows():
        return propagate(mcat, jd_h, method="f64", scan_times=True)

    def scan_grid():
        jd = torch.as_tensor(jd_h, device=DEVICE)
        return cuda_sgp4.sgp4_f64_dense(
            cuda_sgp4.epoch_tsince(jd, torch.zeros_like(jd),
                                   mcat.els.epoch_jd), *mst, **dkw)

    a, b = scan_rows(), scan_grid()
    sync()
    check(all(_same_or_both_nan(x, y) for x, y in zip(a[:2], b[:2]))
          and torch.equal(a[2], b[2]),
          "scan_times=True differs from DENSE on torch's grid of its rows")
    del a, b
    rows_ms, grid_ms = _cuda_ms(scan_rows, 5), _cuda_ms(scan_grid, 5)
    rows_ms = (rows_ms + _cuda_ms(scan_rows, 5)) / 2
    grid_ms = (grid_ms + _cuda_ms(scan_grid, 5)) / 2
    rows_peak, grid_peak = _peak(scan_rows), _peak(scan_grid)
    # DENSE where the epochs spread over +-SPREAD_DAYS: the resonance the
    # walk carries along a thread's rows would otherwise step from epoch
    s_st = spread_cat.f64_staging
    s_tsince = _headline_tsince(spread_cat)
    f64_spread = _in_turns(
        lambda: cuda_sgp4.sgp4_f64_dense(s_tsince, *s_st, **dkw),
        lambda: cuda_sgp4.sgp4_f64_dense_reference(s_tsince, *s_st, **dkw),
        10, 1)
    # one 1year_1s chunk through DENSE in SGP4 mode, replayed
    year_chunk_ms = _graph_ms(lambda: f64_kernel(els, t, cat.grav), 20)
    dense_ops = f64_ops(functools.partial(
        cuda_sgp4.sgp4_f64_dense_reference, sdp4=True), tsince, *mst,
        mcat.grav)
    scan_ops = f64_ops(_plain_scan, t_scan, *mst, mcat.grav)
    year_ops = count_ops(lambda: cuda_sgp4.sgp4_f64_dense_reference(
        t, *iss_f64, grav=cat.grav, sdp4=False))
    # r, v (T, S, 3) f64 and the i32 code a point
    dense_bound = bound(nbytes(tsince, *mst) + 52 * tsince.numel(),
                        *dense_ops)
    scan_bound = bound(nbytes(t_scan, *mst) + 52 * t_scan.numel(),
                       *scan_ops)
    year_bound = bound(nbytes(t, *iss_f64) + 52 * t.numel(), *year_ops)
    peak_planes = _peak(lambda: mcon.propagate(times, layout="planes",
                                               **f64_kw))
    peak_tm = _peak(lambda: mcon.propagate(times, **f64_kw))
    mixed_props = N_SATS * N_TIMES
    print(f"# phase 4c [{smi}]: time-major, propagate_fast_fused: "
          f"{k5.text('K5')} ({tuple(t.shape)}, "
          f"{props / k5.ms / 1e6:.3f} G props/s)")
    print(f"# phase 4c [{smi}]: {spine.text('spine')}")
    print(f"# phase 4c [{smi}]: time-major, as propagate_fast_grids runs "
          f"it: {k6.text('K6')}")
    print(f"# phase 4c [{smi}]: the whole propagate_fast_grids call (spine "
          f"kernel + K6 into (T, S, 3)): {grids_path.text('path')} "
          f"({props / grids_path.ms / 1e6:.3f} G props/s)")
    print(f"# phase 4c [{smi}]: {SINGLE_SAT_SCENARIOS[-1][0]} sweep ({n_year} "
          f"points): "
          f"propagate_fast_fused (K5) {year_fast:.3f} ms "
          f"({n_year / year_fast / 1e6:.3f} G props/s, peak "
          f"{peak_fast:.3f} GiB); f64 kernel (DENSE, SGP4) "
          f"{year_f64k:.3f} ms ({n_year / year_f64k / 1e6:.3f} G props/s, "
          f"peak {peak_f64k:.3f} GiB); plain f64 sgp4_propagate "
          f"{year_f64:.3f} ms ({n_year / year_f64 / 1e6:.3f} G props/s, "
          f"peak {peak_f64:.3f} GiB); the kernel's bound a chunk "
          f"{year_bound[0]:.4f} ms by {year_bound[1]} "
          f"({year_ops[1] / props:.1f} f64 operations a point)")
    print(f"# phase 4c [{smi}]: f64 propagate of the mixed catalog x "
          f"{N_TIMES}: planes {f64_planes:.3f} ms "
          f"({mixed_props / f64_planes / 1e6:.4f} G props/s, peak "
          f"{peak_planes:.3f} GiB), time_major "
          f"{f64_tm:.3f} ms (peak {peak_tm:.3f} GiB), scan_times=True "
          f"{scan_ms:.1f} ms (host clock, one call; peak "
          f"{scan_peak / 2**30:.3f} GiB)")
    print(f"# phase 4c [{smi}]: f64 DENSE (SDP4) of the mixed catalog x "
          f"{N_TIMES}: {f64_dense.text('f64 DENSE')} "
          f"({mixed_props / f64_dense.device_ms / 1e6:.4f} G props/s "
          f"replayed); bound {dense_bound[0]:.4f} ms by {dense_bound[1]} "
          f"({dense_ops[1] / tsince.numel():.1f} f64 operations a point), "
          f"{f64_dense.device_ms / dense_bound[0]:.2f}x the bound")
    print(f"# phase 4c [{smi}]: the scan (DENSE on the jd and fr rows) of "
          f"the mixed catalog x {SCREEN_TIMES} epochs: "
          f"{f64_scan.text('f64 scan')}; bound {scan_bound[0]:.4f} ms by "
          f"{scan_bound[1]} ({scan_ops[1] / t_scan.numel():.1f} f64 "
          f"operations a point)")
    print(f"# phase 4c [{smi}]: scan_times=True x {N_TIMES} epochs, back to "
          f"back: {rows_ms:.4f} ms, peak {rows_peak:.4f} GiB; the grid route "
          f"it replaced (torch's tsince grid, then DENSE on it) "
          f"{grid_ms:.4f} ms, peak {grid_peak:.4f} GiB; bit-equal")
    print(f"# phase 4c [{smi}]: f64 DENSE (SDP4) of the headline generator's "
          f"catalog with epochs spread over +-{SPREAD_DAYS:g} days x "
          f"{N_TIMES}: {f64_spread.text('f64 DENSE')}, "
          f"{f64_spread.device_ms / f64_dense.device_ms:.3f}x the "
          f"single-epoch headline replayed; one 1year_1s chunk "
          f"{tuple(t.shape)} through DENSE (SGP4) {year_chunk_ms:.4f} ms "
          f"replayed")
    k5_ops = count_ops(lambda: cuda_sgp4.propagate_fast_dense_reference(
        t, *staged, **kw))
    k5_out = cuda_sgp4.propagate_fast_dense(t, *staged, **kw)
    k5_bound = bound(nbytes(t, *staged, *k5_out), *k5_ops)
    k6_ops = count_ops(k6_plain)
    k6_bound = bound(nbytes(*grids, tail, flags, *k5_out), *k6_ops)
    spine_ops = count_ops(
        lambda: cuda_sgp4.spine_f64_grids_reference(t, staged[0]))
    spine_bound = bound(nbytes(t, staged[0], *grids), *spine_ops)
    print(f"# phase 4c: K5 bound {k5_bound[0]:.4f} ms by {k5_bound[1]} "
          f"({k5_ops[0] / props:.1f} f32 and {k5_ops[1] / props:.1f} f64 "
          f"operations a point); K6 bound {k6_bound[0]:.4f} ms by "
          f"{k6_bound[1]} ({k6_ops[0] / props:.1f} f32 and "
          f"{k6_ops[1] / props:.1f} f64); spine kernel bound "
          f"{spine_bound[0]:.4f} ms by {spine_bound[1]} "
          f"({spine_ops[0] / props:.1f} f32 and {spine_ops[1] / props:.1f} "
          f"f64)")
    for name, kernel, grid, turns in (
            ("K5", DENSE_KERNEL, "sgp4_shallow_dense", k5),
            ("K6", GRIDS_KERNEL, "sgp4_shallow_grids", k6)):
        kernel_report(f"phase 4c: {name} ({tuple(t.shape)}, 5 trips)",
                      kernel.format(5),
                      cuda_sgp4.launch_grid(grid, *t.shape, kepler_iters=5),
                      props, turns.device_ms, smi)
    for name, sdp4, shape, ms in (
            ("f64 DENSE (SDP4), the mixed catalog", True,
             tuple(tsince.shape), f64_dense.device_ms),
            ("f64 DENSE (SGP4), one 1year_1s chunk", False, tuple(t.shape),
             year_chunk_ms)):
        kernel_report(f"phase 4c: {name} {shape}", F64_KERNEL.format(
            int(sdp4)), cuda_sgp4.launch_grid(
                "sgp4_f64_dense", *shape, sdp4=sdp4), shape[0] * shape[1],
            ms, smi, f64=True)
    return ((k5, k5_bound), (k6, k6_bound), (spine, spine_bound),
            (f64_dense, dense_bound), (f64_scan, scan_bound))


#: phase 8: timed calls of SatrecArray.sgp4 and its pieces, calls of a
#: single-point engine, one-point calls on the card, and the one-second
#: points at which Satrec.sgp4_array's two paths are timed
API_REPS = 5
SINGLE_POINT_CALLS = 10000
CARD_POINT_CALLS = 100
LANES_SIZES = (1024, 2048, 4096, 16384, 32768, 65536, 131072, 262144,
               524288)


def _tle_pairs(text):
    """The (line 1, line 2) pairs of 2- or 3-line TLE text."""
    lines = [ln for ln in text.splitlines() if ln[:2] in ("1 ", "2 ")]
    return list(zip(lines[0::2], lines[1::2]))


def _wall_ms(fn, reps):
    """(mean, least) host milliseconds of a synchronized call of ``fn``,
    after one call to warm up."""
    fn()
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.mean(times)), float(np.min(times))


def _engine_satrec(engine, l1, l2):
    """A Satrec on DEVICE whose single-point calls run on one host
    engine: ``core`` (the extension's SatCore, the default), ``ctypes``
    (the native library through ctypes) or ``python``
    (``ops/scalar.py``)."""
    from contextlib import ExitStack
    from unittest import mock

    from astroz_tpu_torch import native
    from astroz_tpu_torch.api import Satrec

    sat = Satrec.twoline2rv(l1, l2, device=DEVICE)
    with ExitStack() as stack:
        if engine != "core":
            stack.enter_context(mock.patch.object(native, "sat_core",
                                                  lambda *a: None))
        if engine == "ctypes":
            stack.enter_context(mock.patch.object(native, "_get_ext",
                                                  lambda: None))
        if engine == "python":
            stack.enter_context(mock.patch.object(native, "scalar_engine",
                                                  lambda sat: None))
        sat._scalar_record()
    return sat


def _api_array(text, label):
    """Satrec.twoline2rv for every TLE of ``text`` on DEVICE, then a
    SatrecArray; prints the host time of each."""
    from astroz_tpu_torch.api import Satrec, SatrecArray

    pairs = _tle_pairs(text)
    t0 = time.perf_counter()
    sats = [Satrec.twoline2rv(l1, l2, device=DEVICE) for l1, l2 in pairs]
    t_sats = time.perf_counter() - t0
    t0 = time.perf_counter()
    arr = SatrecArray(sats)
    sync()
    t_arr = time.perf_counter() - t0
    print(f"# phase 8: {label}: {len(sats)} Satrec.twoline2rv in "
          f"{t_sats:.3f} s ({t_sats / len(sats) * 1e6:.1f} us each), "
          f"SatrecArray in {t_arr * 1e3:.1f} ms (host clock)")
    check(len(arr) == len(pairs) and arr.catalog.device.type == DEVICE,
          f"{label}: SatrecArray size or device")
    return arr


def _api_array_vs_propagate(arr, cat, expect, label):
    """SatrecArray.sgp4 over N_TIMES one-minute epochs: its launches
    (``expect``, by kernel) and its outputs, which must equal
    ``propagate(cat, fast, sat_major)`` cast to f64 bit for bit. Returns
    the epochs, the outputs and the launches of the call."""
    from astroz_tpu_torch import propagate

    jd = np.full(N_TIMES, EPOCH_JD)
    fr = np.arange(N_TIMES) / 1440.0
    reset_launches()
    e, r, v = arr.sgp4(jd, fr)
    moved = {k: n for k, n in launches().items() if n}
    print(f"# phase 8: {label}: SatrecArray.sgp4 launched {moved}")
    check(moved == expect, f"{label}: SatrecArray.sgp4 launched {moved}, "
          f"expected {expect}")
    rw, vw, ew = propagate(cat, jd, fr, method="fast", layout="sat_major")
    check(e.dtype == np.int32 and r.dtype == v.dtype == np.float64
          and r.shape == v.shape == (len(cat), N_TIMES, 3)
          and e.shape == (len(cat), N_TIMES), f"{label}: output types")
    check(np.array_equal(e, ew.cpu().numpy())
          and np.array_equal(r, rw.double().cpu().numpy())
          and np.array_equal(v, vw.double().cpu().numpy()),
          f"{label}: SatrecArray.sgp4 differs from propagate(fast, "
          "sat_major)")
    check(np.isfinite(r).all() and np.isfinite(v).all(),
          f"{label}: non-finite outputs")
    print(f"# phase 8: {label}: equal to propagate(fast, sat_major) in f64 "
          f"bit for bit; healthy points {(e == 0).mean():.6f}")
    return jd, fr, e, r, moved


def _api_array_timings(arr, cat, jd, fr, shape, label, smi):
    """The whole SatrecArray.sgp4 call and sgp4_into, and the call's
    split: propagate as planes, the relayout to sat_major, r, v and e
    over the bus into page-locked memory, the cast to f64 on the host
    into fresh arrays and into the caller's (``api._host_f64``'s route;
    ``shallow_variants.py --f64-routes`` times it against the others)."""
    from astroz_tpu_torch import propagate

    whole = _wall_ms(lambda: arr.sgp4(jd, fr), API_REPS)
    r_out, v_out = np.empty(shape), np.empty(shape)
    e_out = np.empty(shape[:2], np.int32)
    into = _wall_ms(lambda: arr.sgp4_into(jd, fr, r_out, v_out, e_out),
                    API_REPS)
    kw = dict(method="fast")
    planes = _cuda_ms(lambda: propagate(cat, jd, fr, layout="planes", **kw),
                      API_REPS)
    sat_major = _cuda_ms(
        lambda: propagate(cat, jd, fr, layout="sat_major", **kw), API_REPS)
    r, v, e = propagate(cat, jd, fr, layout="sat_major", **kw)
    staged = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
              for x in (r, v, e)]
    d2h = _wall_ms(lambda: [y.copy_(x) for x, y in zip((r, v, e), staged)],
                   API_REPS)
    cast = _wall_ms(lambda: [torch.from_numpy(np.empty(shape)).copy_(y)
                             for y in staged[:2]], API_REPS)
    cast_into = _wall_ms(lambda: [torch.from_numpy(o).copy_(y) for o, y in
                                  zip((r_out, v_out), staged[:2])],
                         API_REPS)
    del staged
    print(f"# phase 8 [{smi}]: {label} SatrecArray.sgp4 "
          f"({shape[0]} x {shape[1]}, f64 r, v and i32 e on the host): "
          f"{whole[0]:.2f} ms (least {whole[1]:.2f}); sgp4_into "
          f"preallocated buffers {into[0]:.2f} ms (least {into[1]:.2f}); "
          f"host clock, {API_REPS} calls")
    print(f"# phase 8 [{smi}]: {label} split: propagate planes {planes:.3f} "
          f"ms, sat_major {sat_major:.3f} ms (relayout "
          f"{sat_major - planes:.3f} ms; CUDA events); r, v, e (f32, i32) "
          f"into page-locked memory {d2h[0]:.2f} ms (least {d2h[1]:.2f}); "
          f"r, v cast to f64 on the host into fresh arrays {cast[0]:.2f} ms "
          f"(least {cast[1]:.2f}), into the caller's buffers "
          f"{cast_into[0]:.2f} ms (least {cast_into[1]:.2f})")


def lanes_crossover(smi):
    """``Satrec.sgp4_array``'s two paths for the ISS and a GEO TLE over
    each of LANES_SIZES one-second points: the card's time as lanes
    (``Satrec._sgp4_lanes``) within 2e-6 km of the native array engine
    (``tests/test_api.py``'s gate), both timed in turns (card, native,
    native, card; host clock around synchronized calls), and the path
    ``sgp4_array`` takes, which must be the one ``_LANES_MIN_TIMES``
    gives. Prints the sizes from which the card won in this run beside
    that threshold."""
    from astroz_tpu_torch import api
    from astroz_tpu_torch.api import Satrec

    deep_lines = GOLDEN_DEEP_TLES.splitlines()
    for name, (l1, l2) in (("ISS", (GOLDEN_L1, GOLDEN_L2)),
                           ("GEO", tuple(deep_lines[:2]))):
        sat = Satrec.twoline2rv(l1, l2, device=DEVICE)
        sat._scalar_record()
        threshold = api._LANES_MIN_TIMES[sat.is_deep_space]
        taken = []
        lanes = sat._sgp4_lanes

        def counted(jd, fr):
            taken.append(len(jd))
            return lanes(jd, fr)

        sat._sgp4_lanes = counted
        rows = []
        for n in LANES_SIZES:
            jd1 = np.full(n, sat.jdsatepoch)
            fr1 = sat.jdsatepochF + np.arange(n) / 86400.0
            tsince = ((jd1 - sat.jdsatepoch)
                      + (fr1 - sat.jdsatepochF)) * 1440.0
            el, rl, _ = lanes(jd1, fr1)
            en, rn, _ = sat._scalar_native.sgp4_array(tsince)
            d_lanes = float(np.abs(rl - rn).max())
            check(np.array_equal(el, en) and (el == 0).all()
                  and d_lanes <= 2e-6,
                  f"{name}: time as lanes over 2e-6 km from the native "
                  f"path at {n} points")
            paths = {"card": lambda: lanes(jd1, fr1),
                     "native": lambda: sat._scalar_native.sgp4_array(
                         tsince)}
            ms = {k: [] for k in paths}
            for k in ("card", "native", "native", "card"):
                ms[k].append(_wall_ms(paths[k], 2)[0])
            rows.append((n, float(np.mean(ms["card"])),
                         float(np.mean(ms["native"])), d_lanes))
            del taken[:]
            sat.sgp4_array(jd1, fr1)
            check(bool(taken) == (n >= threshold),
                  f"{name}: sgp4_array at {n} points did not take the "
                  f"path _LANES_MIN_TIMES gives")
        wins = [n for n, card, host, _ in rows if card < host]
        since = next((n for n, _, _, _ in rows
                      if all(m in wins for m in LANES_SIZES
                             if m >= n)), None)
        print(f"# phase 8 [{smi}]: {name} sgp4_array, time as lanes on "
              f"the card / the native array engine (ms, mean of 2 turns "
              f"of 2 calls; max|dr| km): " + "; ".join(
                  f"{n}: {card:.3f} / {host:.3f} ({d:.1e})"
                  for n, card, host, d in rows)
              + f"; the card won from {since} points on in this run, "
              f"the API takes it from {threshold}")


def phase8_api(con, mcon, text, mixed_text, smi):
    """The python-sgp4 drop-in API on the card (see the module
    docstring); prints the kernel launches of its SatrecArray calls."""
    from astroz_tpu_torch import build_catalog, native, propagate
    from astroz_tpu_torch import propagate_tsince
    from astroz_tpu_torch.api import (Satrec, SatrecArray, WGS72, WGS84,
                                      create_sgp4_propagator)

    t0 = time.perf_counter()
    native._get_ext()
    print(f"# phase 8: g++ built the scalar engine's CPython extension "
          f"({native._ext_path().name}) in "
          f"{time.perf_counter() - t0:.2f} s")

    # the mixed headline catalog
    marr = _api_array(mixed_text, "mixed")
    mcat = mcon.catalog
    # the array's own catalog: TABLES at its first sweep; sat_major: the
    # epilogue kernel
    jd, fr, e, r, moved = _api_array_vs_propagate(
        marr, mcat, {"sgp4_deep": 1, "sgp4_f64_escape": 1,
                     "sgp4_shallow_merge": 1, "resonance_tables": 1,
                     "finalize_f32": 1}, "mixed")
    api_launches = {"mixed SatrecArray.sgp4": moved}
    r64, _, e64 = propagate(mcat, jd, fr, method="f64", layout="sat_major",
                            velocities=False)
    check(np.array_equal(e64.cpu().numpy(), e),
          "mixed: fast and f64 error codes differ")
    ok = torch.from_numpy(e == 0).to(DEVICE)
    dist = ((torch.from_numpy(r).to(DEVICE) - r64).norm(dim=-1)
            .masked_fill(~ok, 0.0))
    _fast_vs_f64_gates(mcat, dist.amax(dim=1).cpu().numpy(),
                       "phase 8 (mixed SatrecArray)", float(ok.float().mean()))
    del r64, dist, r
    _api_array_timings(marr, mcat, jd, fr, (N_SATS, N_TIMES, 3), "mixed",
                       smi)

    # the near-earth catalog
    narr = _api_array(text, "near-earth")
    api_launches["near-earth SatrecArray.sgp4"] = _api_array_vs_propagate(
        narr, con.catalog, {"sgp4_shallow": 1, "finalize_f32": 1},
        "near-earth")[-1]
    _api_array_timings(narr, con.catalog, jd, fr, (N_SATS, N_TIMES, 3),
                       "near-earth", smi)
    del narr, marr

    # mixed gravity: one propagate a model
    pairs = _tle_pairs(text)[:1000]
    sats = [Satrec.twoline2rv(l1, l2, WGS72 if k < 500 else WGS84,
                              device=DEVICE)
            for k, (l1, l2) in enumerate(pairs)]
    garr = SatrecArray(sats)
    check(garr._grav_groups is not None and len(garr._grav_groups) == 2,
          "mixed gravity: two model groups")
    reset_launches()
    ge, gr, gv = garr.sgp4(jd, fr)
    moved = {k: n for k, n in launches().items() if n}
    api_launches["mixed-gravity SatrecArray.sgp4"] = moved
    check(moved == {"sgp4_shallow": 2, "finalize_f32": 2},
          "mixed gravity: not one propagate (K1 and epilogue launch) a "
          "model")
    for rows, part in ((slice(0, 500), sats[:500]),
                       (slice(500, 1000), sats[500:])):
        pe, pr, pv = SatrecArray(part).sgp4(jd, fr)
        check(np.array_equal(ge[rows], pe) and np.array_equal(gr[rows], pr)
              and np.array_equal(gv[rows], pv),
              "mixed gravity: a row differs from its single-model array")
    d_models = float(np.abs(gr[:500] - SatrecArray(
        [Satrec.twoline2rv(l1, l2, WGS84, device=DEVICE)
         for l1, l2 in pairs[:500]]).sgp4(jd, fr)[1]).max())
    check(d_models > 1e-3, "mixed gravity: the two models agree")
    print(f"# phase 8: mixed gravity (1,000 lanes, 500 WGS72 + 500 WGS84): "
          f"launches {moved}, every row equal to its single-model array's (the models "
          f"differ by up to {d_models:.3f} km)")
    print("# phase 8: API launches, main path: "
          + json.dumps(api_launches))

    # single-point calls on each host engine, and one point on the card
    per_call, answers = {}, {}
    for engine in ("core", "ctypes", "python"):
        sat = _engine_satrec(engine, GOLDEN_L1, GOLDEN_L2)
        jd0, fr0 = sat.jdsatepoch, sat.jdsatepochF
        frs = [fr0 + k / 1440.0 for k in range(SINGLE_POINT_CALLS)]
        call = sat.sgp4
        call(jd0, fr0)
        t0 = time.perf_counter()
        for x in frs:
            call(jd0, x)
        per_call[engine] = ((time.perf_counter() - t0)
                            / SINGLE_POINT_CALLS * 1e6)
        answers[engine] = (sat, sat.sgp4(jd0, fr0 + 0.25))
    core = answers["core"][0]
    check(core._core is not None and "sgp4" in core.__dict__
          and type(core.sgp4).__name__ == "builtin_function_or_method",
          "the native core is not the engine in use")
    fresh = Satrec.twoline2rv(GOLDEN_L1, GOLDEN_L2, device=DEVICE)
    fresh.sgp4(fresh.jdsatepoch, fresh.jdsatepochF)
    check("sgp4" in fresh.__dict__, "a Satrec does not bind the native core")
    check(answers["ctypes"][0]._scalar_native._ext is None
          and answers["python"][0]._scalar_native is None,
          "an engine was not pinned")
    check(answers["core"][1] == answers["ctypes"][1],
          "the native core and the ctypes engine differ")
    ec, rc, vc = answers["core"][1]
    ep, rp, vp = answers["python"][1]
    d_py = float(np.abs(np.subtract(rc, rp)).max())
    check(ec == ep == 0 and d_py < 1e-9,
          "the Python scalar engine differs from the native one")
    cat1 = build_catalog(f"{GOLDEN_L1}\n{GOLDEN_L2}", device=DEVICE)

    def one_point():
        r1, v1, e1 = propagate_tsince(cat1, 360.0)
        return r1.cpu(), v1.cpu(), e1.cpu()

    card_ms = _wall_ms(one_point, CARD_POINT_CALLS)[0]
    card_launch_us = _host_us(lambda: propagate_tsince(cat1, 360.0),
                              CARD_POINT_CALLS)
    r1 = one_point()[0].numpy()[0]
    _, r_core, _ = core.sgp4_tsince(360.0)
    check(float(np.abs(r1 - np.asarray(r_core)).max()) < 1e-6,
          "one point on the card differs from the native core")
    print(f"# phase 8 [{smi}]: Satrec.sgp4, {SINGLE_POINT_CALLS} calls: "
          f"native core {per_call['core']:.3f} us a call, ctypes engine "
          f"{per_call['ctypes']:.3f} us, Python scalar "
          f"{per_call['python']:.3f} us (host clock); one-point "
          f"propagate_tsince on the card with the copy back "
          f"{card_ms * 1e3:.1f} us a call ({card_launch_us:.1f} us of host "
          f"time without waiting for the card); Python vs native max|dr| "
          f"{d_py:.3e} km")

    lanes_crossover(smi)

    # create_sgp4_propagator on the card
    params, fn = create_sgp4_propagator(GOLDEN_L1, GOLDEN_L2, device=DEVICE)
    t = torch.arange(float(N_TIMES), dtype=torch.float64, device=DEVICE)
    rf, vf = fn(params, t)
    rt, vt, _ = propagate_tsince(cat1, t[:, None])
    check(rf.device.type == DEVICE and torch.equal(rf, rt[:, 0])
          and torch.equal(vf, vt[:, 0]),
          "propagate_fn differs from propagate_tsince")
    rv, vv = torch.func.vmap(lambda x: fn(params, x))(t)
    looped = [fn(params, x) for x in t]
    check(all(torch.equal(rv[k], a) and torch.equal(vv[k], b)
              for k, (a, b) in enumerate(looped)),
          "propagate_fn under vmap differs from the loop")
    gparams, gfn = create_sgp4_propagator(
        *GOLDEN_DEEP_TLES.splitlines()[:2], device=DEVICE)
    rg, vg = gfn(gparams, t)
    rgv, vgv = torch.func.vmap(lambda x: gfn(gparams, x, max_steps=4))(t)
    check(torch.equal(rg, rgv) and torch.equal(vg, vgv),
          "deep propagate_fn under vmap with max_steps differs")
    check("jax" not in sys.modules, "the API loaded jax")
    print(f"# phase 8: create_sgp4_propagator on the card: ISS x {N_TIMES} "
          f"equal to propagate_tsince and under vmap to the loop; GEO under "
          f"vmap with max_steps=4 equal to the plain call, bit for bit")


#: phase 9: the ingest catalogs (kind, satellites; 50,000 is README.md's
#: debris scale), timed turns of each route, the telemetry streams' size,
#: and the small grids timed against the native host engine
INGEST_CATALOGS = (("mixed", N_SATS), ("near-earth", N_SATS),
                   ("mixed", 50000))
INGEST_TURNS = 3
FRAME_STREAM_BYTES = 64 << 20
FRAME_SYNC = b"\x1a\xcf\xfc\x1d"  # the CCSDS attached sync marker
SMALL_GRID_REPS = 20


def host_cpu():
    """The host CPU from /proc/cpuinfo: its model name, or, where the
    file gives none (as some virtual machines do), its vendor, family,
    model and clock; and the logical core count."""
    info = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            if not line.strip():
                break  # the first processor's block is enough
            key, _, value = line.partition(":")
            info[key.strip()] = value.strip()
    name = info.get("model name", "unknown")
    if name == "unknown":
        name = (f"{info.get('vendor_id', '?')} family "
                f"{info.get('cpu family', '?')} model "
                f"{info.get('model', '?')} at {info.get('cpu MHz', '?')} MHz")
    return f"{name}, {os.cpu_count()} logical cores"


def _catalog_text(kind, n):
    return (mixed_catalog_text if kind == "mixed"
            else near_earth_catalog_text)(n)


def _first_sweep(text, route, expect):
    """TLE text -> ``build_catalog(..., device="cuda")`` -> the first
    ``propagate(method="fast", layout="planes")`` over N_TIMES one-minute
    epochs, synchronized (host clock, ms), through the native parser or
    through Python-parsed ``TleArrays``; then the same steps one by one
    on a fresh catalog for the split. Checks that the native route
    parsed natively (and the Python route not) and the launches of the
    first sweep. Returns (total, split, r, e, cat)."""
    from astroz_tpu_torch import build_catalog, native, propagate
    from astroz_tpu_torch.propagation import (catalog_from_elements,
                                              elements_from_arrays,
                                              resonance_steps)
    from astroz_tpu_torch.tle import TleArrays

    jd = np.full(N_TIMES, EPOCH_JD)
    fr = np.arange(N_TIMES) / 1440.0
    parse_native = native.parse_catalog
    parsed = []
    native.parse_catalog = lambda t: parsed.append(1) or parse_native(t)
    try:
        sync()
        reset_launches()
        t0 = time.perf_counter()
        src = (text if route == "native"
               else TleArrays.from_text(text, allow_native=False))
        cat = build_catalog(src, device=DEVICE)
        r, _, e = propagate(cat, jd, fr, method="fast", layout="planes")
        sync()
        total = (time.perf_counter() - t0) * 1e3
        moved = {k: n for k, n in launches().items() if n}
        check(moved == expect, f"{route} first sweep launched {moved}, "
              f"not {expect}")
        check(len(parsed) == (route == "native"),
              f"the {route} route parsed natively {len(parsed)} times")

        split = {}
        t = time.perf_counter()
        arrays = TleArrays.from_text(text, allow_native=route == "native")
        split["parse"] = time.perf_counter() - t
        t = time.perf_counter()
        els = elements_from_arrays(arrays)
        split["init"] = time.perf_counter() - t
        t = time.perf_counter()
        fresh = catalog_from_elements(els, cat.grav, arrays.satnum,
                                      device=DEVICE)
        sync()
        split["sdp4 init + device catalog"] = time.perf_counter() - t
        t = time.perf_counter()
        fresh.fast_staging
        if fresh.has_deep:
            fresh.resonance_tables(resonance_steps(jd + fr,
                                                   fresh.deep_epochs_jd))
            fresh.heo_escape
        sync()
        split["staging + resonance tables"] = time.perf_counter() - t
        t = time.perf_counter()
        propagate(fresh, jd, fr, method="fast", layout="planes")
        sync()
        split["sweep"] = time.perf_counter() - t
    finally:
        native.parse_catalog = parse_native
    return total, {k: v * 1e3 for k, v in split.items()}, r, e, cat


def _ingest(kind, n, smi, cpu):
    """Phase 9's ingest of one catalog: the native and the plain parse
    in turns, bit-equal columns, and the time to first sweep of each
    route in turns."""
    from astroz_tpu_torch import native
    from astroz_tpu_torch.tle import TleArrays

    text = _catalog_text(kind, n)
    label = f"{kind} {n:,}"
    nat = TleArrays.from_text(text)
    py = TleArrays.from_text(text, allow_native=False)
    cols = ("satnum", "epoch_jd", "jdsatepoch", "jdsatepochF", "no_kozai",
            "ecco", "inclo", "nodeo", "argpo", "mo", "bstar", "ndot",
            "nddot")
    check(len(nat) == len(py) == n and all(
        np.array_equal(getattr(nat, c), getattr(py, c)) for c in cols),
        f"{label}: native and Python columns differ")
    parse = {"native": [], "python": []}
    for k in range(INGEST_TURNS):
        for route in (("native", "python") if k % 2 == 0
                      else ("python", "native")):
            t0 = time.perf_counter()
            TleArrays.from_text(text, allow_native=route == "native")
            parse[route].append((time.perf_counter() - t0) * 1e3)
    p_nat, p_py = (float(np.mean(parse[k])) for k in ("native", "python"))
    print(f"# phase 9 [{smi}; {cpu}]: {label} TLEs ({len(text) / 2**20:.2f} "
          f"MiB of text): parse native {p_nat:.2f} ms, Python "
          f"{p_py:.2f} ms ({p_py / p_nat:.1f}x; host clock, mean of "
          f"{INGEST_TURNS} in turns); all 12 columns and the satellite "
          f"numbers bit-equal")

    # a fresh catalog: TABLES once; TEME planes: no epilogue launch
    expect = ({"sgp4_deep": 1, "sgp4_f64_escape": 1, "sgp4_shallow_merge": 1,
               "resonance_tables": 1}
              if kind == "mixed" else {"sgp4_shallow": 1})
    # one untimed run first (its outputs are gated), then the turns
    _, _, r, e, cat = _first_sweep(text, "native", expect)
    check(r.device.type == DEVICE and tuple(r.shape) == (3, N_TIMES, n)
          and torch.isfinite(r).all().item(), f"{label}: outputs")
    if kind == "mixed":
        _regime_gates(cat, r, e, f"phase 9: {label}")
    del r, e, cat
    runs = {"native": [], "python": []}
    for k in range(INGEST_TURNS):
        for route in (("native", "python") if k % 2 == 0
                      else ("python", "native")):
            total, split = _first_sweep(text, route, expect)[:2]
            runs[route].append((total, split))
    for route, rs in runs.items():
        total = float(np.mean([t for t, _ in rs]))
        split = {key: float(np.mean([sp[key] for _, sp in rs]))
                 for key in rs[0][1]}
        print(f"# phase 9 [{smi}; {cpu}]: {label} time to first sweep "
              f"({route} parse): {total:.2f} ms (host clock, mean of "
              f"{INGEST_TURNS} in turns); split, ms: " + ", ".join(
                  f"{key} {v:.2f}" for key, v in split.items())
              + f"; first sweep launched {expect}")


def _frame_stream(kind, rng):
    """About FRAME_STREAM_BYTES of packets with 0-8 corrupt bytes and the
    attached sync marker before each."""
    from astroz_tpu_torch.io.ccsds import build_packet as ccsds_packet
    from astroz_tpu_torch.io.vita49 import build_packet as vita49_packet

    parts, size, k = [], 0, 0
    while size < FRAME_STREAM_BYTES:
        if kind == "ccsds":
            pkt = ccsds_packet(apid=int(rng.integers(0, 2048)),
                               payload=rng.bytes(int(rng.integers(1, 1024))),
                               sequence_count=k % 16384)
        else:
            pkt = vita49_packet(
                payload=rng.bytes(4 * int(rng.integers(1, 256))),
                stream_id=int(rng.integers(0, 1 << 16)), packet_count=k % 16)
        gap = rng.bytes(int(rng.integers(0, 9)))
        parts += [gap, FRAME_SYNC, pkt]
        size += len(gap) + len(FRAME_SYNC) + len(pkt)
        k += 1
    return b"".join(parts), k


def _frame_scans(cpu):
    """The native frame scanner against the Python walk on ~64 MiB
    streams, with and without the sync marker: equal offsets and
    lengths, both timed in turns; iter_frames (native route, fields in
    Python) timed once."""
    from astroz_tpu_torch import native
    from astroz_tpu_torch.io import Ccsds, Parser, Vita49

    rng = np.random.default_rng(9)
    for kind, ftype in (("ccsds", Ccsds), ("vita49", Vita49)):
        blob, n_pkts = _frame_stream(kind, rng)
        for sync_pattern in (FRAME_SYNC, None):
            parser = Parser(ftype, sync_pattern=sync_pattern)
            found, ms = {}, {"native": [], "walk": []}
            for route in ("native", "walk", "walk", "native"):
                t0 = time.perf_counter()
                if route == "native":
                    o, ln = native.scan_frames(kind, blob, sync_pattern)
                    found[route] = (o.tolist(), ln.tolist())
                else:
                    w = [(o, f.total_length) for o, f in parser._walk(blob)]
                    found[route] = ([o for o, _ in w], [ln for _, ln in w])
                ms[route].append((time.perf_counter() - t0) * 1e3)
            check(found["native"] == found["walk"],
                  f"{kind}: native scan and Python walk differ")
            n_frames = len(found["native"][0])
            if sync_pattern:
                check(n_frames == n_pkts, f"{kind}: {n_frames} frames of "
                      f"{n_pkts} sync-framed packets")
            t0 = time.perf_counter()
            n_parsed = sum(1 for _ in parser.iter_frames(blob))
            it_ms = (time.perf_counter() - t0) * 1e3
            check(n_parsed == n_frames, f"{kind}: iter_frames count")
            nat, walk = np.mean(ms["native"]), np.mean(ms["walk"])
            print(f"# phase 9 [{cpu}]: {kind} stream of "
                  f"{len(blob) / 2**20:.2f} MiB ({n_pkts} packets, corrupt "
                  f"bytes between), sync marker "
                  f"{'on' if sync_pattern else 'off'}: {n_frames} frames, "
                  f"offsets and lengths equal; scan native {nat:.2f} ms, "
                  f"Python walk {walk:.2f} ms ({walk / nat:.0f}x; host "
                  f"clock, mean of 2 in turns); iter_frames (native scan, "
                  f"fields in Python) {it_ms:.2f} ms")


def _c_abi(cpu):
    """The C ABI through ctypes: tle_parse -> sgp4_init ->
    sgp4_propagate_batch over N_TIMES minutes of the ISS and GEO golden
    TLEs, against ``Satrec`` on the native core."""
    import ctypes

    from astroz_tpu_torch import native
    from astroz_tpu_torch.api import Satrec

    lib = native.get_lib()
    dbl = ctypes.POINTER(ctypes.c_double)
    geo = GOLDEN_DEEP_TLES.splitlines()[:2]
    t = np.arange(float(N_TIMES))
    n_fields = len(native.SCALAR_FIELDS)
    for name, (l1, l2) in (("ISS", (GOLDEN_L1, GOLDEN_L2)),
                           ("GEO", tuple(geo))):
        th, sh = ctypes.c_void_p(), ctypes.c_void_p()
        check(lib.tle_parse(f"{l1}\n{l2}".encode(), ctypes.byref(th)) == 0,
              f"C ABI: tle_parse of {name}")
        check(lib.sgp4_init(th, 1, ctypes.byref(sh)) == 0,  # 1: WGS72
              f"C ABI: sgp4_init of {name}")
        try:
            vec = np.ctypeslib.as_array(
                (ctypes.c_double * n_fields).from_address(sh.value)).copy()
            batch = np.zeros((N_TIMES, 6))
            t0 = time.perf_counter()
            code = lib.sgp4_propagate_batch(sh, t.ctypes.data_as(dbl),
                                            batch.ctypes.data_as(dbl),
                                            N_TIMES)
            batch_us = (time.perf_counter() - t0) * 1e6
            check(code == 0, f"C ABI: {name} batch returned {code}")
            pos, vel = (ctypes.c_double * 3)(), (ctypes.c_double * 3)()
            single = np.zeros((N_TIMES, 6))
            for i, x in enumerate(t):
                check(lib.sgp4_propagate(sh, x, pos, vel) == 0,
                      f"C ABI: {name} sgp4_propagate")
                single[i] = list(pos) + list(vel)
        finally:
            lib.sgp4_free(sh)
            lib.tle_free(th)
        sat = Satrec.twoline2rv(l1, l2, device=DEVICE)
        sat._scalar_record()
        sat.sgp4(sat.jdsatepoch, sat.jdsatepochF)
        check("sgp4" in sat.__dict__, "the native core is not bound")
        core = np.array([np.concatenate(sat.sgp4_tsince(x)[1:]) for x in t])
        e, r, v = sat._scalar_native.sgp4_array(t)
        check(np.array_equal(vec, native.pack_scalar_sat(sat._scalar)),
              f"C ABI: {name} sgp4_init differs from the Python init")
        check(np.array_equal(single, core), f"C ABI: {name} sgp4_propagate "
              f"differs from Satrec.sgp4_tsince on the native core")
        check((e == 0).all() and np.array_equal(
            batch, np.concatenate([r, v], -1)), f"C ABI: {name} batch "
            f"differs from the native engine's array path")
        d_batch = float(np.abs(batch - core).max())
        check(d_batch <= 1e-9, f"C ABI: {name} batch vs points {d_batch}")
        print(f"# phase 9 [{cpu}]: C ABI {name} x {N_TIMES} min: sgp4_init "
              f"equals the Python init's element vector, sgp4_propagate "
              f"equals Satrec.sgp4_tsince on the native core and the batch "
              f"the engine's array path, bit for bit; batch vs points "
              f"max diff {d_batch:.3e} (km, km/s); batch {batch_us:.1f} us")


def _small_grids(smi, cpu):
    """``propagate(method="fast")`` of small grids on the card against
    ``native.sgp4_grid`` on the same inputs, in turns: the card with
    CUDA events (outputs on the card) and with the copy to the host
    (host clock), the native engine on the host clock."""
    from astroz_tpu_torch import build_catalog, native, propagate
    from astroz_tpu_torch.ops import scalar
    from astroz_tpu_torch.tle import iter_tles

    grids = (("ISS x 1,440", f"{GOLDEN_L1}\n{GOLDEN_L2}", N_TIMES),
             ("100 near-earth x 100", near_earth_catalog_text(100), 100))
    for label, text, n_t in grids:
        cat = build_catalog(text, device=DEVICE)
        jd = np.full(n_t, EPOCH_JD)
        fr = np.arange(n_t) / 1440.0
        vecs = np.stack([native.pack_scalar_sat(scalar.sgp4init(
            scalar.wgs72(), t.epoch_jd, t.bstar, t.ecco, t.argpo, t.inclo,
            t.mo, t.no_kozai, t.nodeo)) for t in iter_tles(text)])
        tsince = ((jd[None, :] - cat.epochs_jd[:, None])
                  + fr[None, :]) * 1440.0

        def card():
            return propagate(cat, jd, fr, method="fast")

        def card_host():
            return tuple(x.cpu().numpy() for x in card())

        def host():
            return native.sgp4_grid(vecs, tsince)

        ms = {"card": [], "card + copy": [], "native": []}
        for route in ("card", "native", "native", "card"):
            if route == "card":
                ms["card"].append(_cuda_ms(card, SMALL_GRID_REPS))
                ms["card + copy"].append(
                    _wall_ms(card_host, SMALL_GRID_REPS)[0])
            else:
                ms["native"].append(_wall_ms(host, SMALL_GRID_REPS)[0])
        r, _, e = card_host()
        he, hr, _ = host()
        ok = (e.T == 0) & (he == 0)
        check(np.array_equal(e.T, he) and ok.any(),
              f"{label}: card and native error codes differ")
        d = float(np.abs(np.transpose(r, (1, 0, 2)) - hr)[ok].max())
        check(d < 0.05, f"{label}: fast path {d} km from the native f64")
        means = {k: float(np.mean(v)) for k, v in ms.items()}
        print(f"# phase 9 [{smi}; {cpu}]: small grid {label}: propagate "
              f"fast on the card {means['card']:.3f} ms (CUDA events), "
              f"{means['card + copy']:.3f} ms with the copy to the host; "
              f"native.sgp4_grid {means['native']:.3f} ms (host clock); "
              f"mean of 2 turns of {SMALL_GRID_REPS} calls; max|dr| "
              f"{d * 1e3:.2f} m")


def phase9_ingest(smi):
    """The native ingest and runtime layer (see the module docstring)."""
    cpu = host_cpu()
    print(f"# phase 9: host CPU {cpu}; card {smi}")
    for kind, n in INGEST_CATALOGS:
        _ingest(kind, n, smi, cpu)
    _frame_scans(cpu)
    _c_abi(cpu)
    _small_grids(smi, cpu)
    check("jax" not in sys.modules, "phase 9 loaded jax")


#: phase 11: the mesh of shards on the card(s): every visible card, or
#: MESH_SHARDS shards on one card; the f64 sweep's epochs (of the
#: 1,440); the threshold of the ragged rectangle-mode check, km
MESH_SHARDS = 4
MESH_F64_TIMES = 240
RECT_SMALL_KM = 200.0


def mesh_devices():
    """The phase-11 mesh's devices: each visible card once, or one card
    repeated MESH_SHARDS times, and a note saying which."""
    n = torch.cuda.device_count()
    if n > 1:
        return ([torch.device("cuda", i) for i in range(n)],
                f"{n} cards, one shard each")
    return ([torch.device("cuda", 0)] * MESH_SHARDS,
            f"one card repeated {MESH_SHARDS} times (shards take turns on "
            f"it: the times measure the cost of sharding on one card, not "
            f"a speed-up)")


def _same(got, want, label):
    for a, b in zip(got, want):
        check((a is None) == (b is None), f"{label}: velocities")
        if a is not None:
            check(a.shape == b.shape and a.dtype == b.dtype
                  and torch.equal(a, b), f"{label}: differs from the "
                  "single-device sweep")


def _same_screen(got, want, label):
    check(all(np.array_equal(a, b) for a, b in zip(got, want)),
          f"{label}: pairs, distances or epochs differ from screen_all's")


def _rect_vs_twin(rows, cols, thr2, label, **kw):
    """K4's rectangle mode against its plain version (in PLAIN_COLS-column
    blocks), the same (i, j) pairs in order; returns the plain pairs and
    the largest index difference."""
    from astroz_tpu_torch.ops import cuda_screen

    got = cuda_screen.coarse_candidates_rect(rows, cols, thr2, **kw)
    ref = cuda_screen.coarse_candidates_rect_reference(
        rows, cols, thr2,
        work_bytes=cuda_screen.PLAIN_BYTES_PER_ENTRY * rows.shape[2]
        * PLAIN_COLS)
    check(len(got[0]) == len(ref[0]),
          f"K4 rectangle {label}: {len(got[0])} pairs, the plain version "
          f"{len(ref[0])}")
    err = ((torch.stack(got) - torch.stack(ref)).abs().max().item()
           if len(ref[0]) else 0)
    check(err == 0, f"K4 rectangle {label}: pairs differ from the plain "
          f"version's (largest index difference {err})")
    return ref, float(err)


def phase11_mesh(mcon, scon, smi):
    """Phase 11 (module docstring): the multi-device paths on a mesh of
    the card(s). Returns the rectangle mode's kernels-line entry pieces
    ``(launches, max_abs_err, (ms, plain_ms, (bound_ms, bound_by)))``."""
    from astroz_tpu_torch import propagate, screen_all
    from astroz_tpu_torch.ops import cuda_screen
    from astroz_tpu_torch import _build, build_catalog
    from astroz_tpu_torch.parallel import (make_mesh, propagate_sharded,
                                           propagate_sharded_fast,
                                           shard_catalog, stage_sharded_fast)
    from astroz_tpu_torch.screening import (_positions_planes_f32,
                                            _ring_planes, screen_all_ring)
    from astroz_tpu_torch.tle import format_lines

    devs, note = mesh_devices()
    meshes = {"sat 4": make_mesh(devs),
              "time 2 x sat 2": make_mesh(devs, time_parallel=2)}
    print(f"# phase 11: mesh of {note}: "
          + "; ".join(f"{k} {m}" for k, m in meshes.items()))
    cat, scat = mcon.catalog, scon.catalog
    jd = EPOCH_JD + np.arange(float(N_TIMES)) / 1440.0

    # 11a: the sharded fast sweep of the mixed catalog, bit for bit
    cases = [dict(layout="time_major"), dict(layout="sat_major"),
             dict(layout="planes"), dict(layout="planes", velocities=False),
             dict(layout="planes", output="ecef")]
    want = [propagate(cat, jd, method="fast", **kw) for kw in cases]
    for name, mesh in meshes.items():
        deep = [s.has_deep for s in shard_catalog(cat, mesh)[0].shards.flat]
        for kw, ref in zip(cases, want):
            reset_launches()
            got = propagate_sharded_fast(cat, jd, mesh=mesh, **kw)
            sync()
            n = launches()
            _same(got, ref, f"phase 11a {name} {kw}")
        check((n["sgp4_deep"], n["sgp4_shallow_merge"], n["sgp4_shallow"])
              == (sum(deep), sum(deep), len(deep) - sum(deep)),
              f"phase 11a {name}: launches {n}, expected K2 and K3 once a "
              f"shard with deep lanes ({sum(deep)}), K1 once a shard "
              "without")
        print(f"# phase 11a: {name}: propagate_sharded_fast of the mixed "
              f"{N_SATS} x {N_TIMES} ({sum(deep)} of {len(deep)} shards "
              f"with deep lanes) bit-equal to propagate(method='fast') in "
              f"{len(cases)} forms (time_major, sat_major, planes, "
              f"velocities=False, ECEF), escape lanes included; launches "
              f"of the last call {n}")

    # 11b: the sharded f64 sweep, bit for bit
    jd_f64 = jd[:MESH_F64_TIMES]
    ref = propagate(cat, jd_f64, method="f64")
    for name, mesh in meshes.items():
        _same(propagate_sharded(cat, jd_f64, mesh=mesh), ref,
              f"phase 11b {name}")
    print(f"# phase 11b: propagate_sharded (f64) of the mixed {N_SATS} x "
          f"{MESH_F64_TIMES} bit-equal to propagate(method='f64') on both "
          "meshes")

    # 11c, 11d: the mesh screens against screen_all
    jd_s = SCREEN_EPOCH_JD + np.arange(float(SCREEN_TIMES)) / 1440.0
    mesh = meshes["sat 4"]
    shell_ref = screen_all(scat, jd_s, threshold_km=SCREEN_KM)
    reset_launches()
    got = screen_all(scat, jd_s, threshold_km=SCREEN_KM, mesh=mesh)
    n_time = launches()
    _same_screen(got, shell_ref, "phase 11c shell")
    check(n_time["screen_candidates"] == len(devs)
          and n_time["sgp4_shallow"] == 1,
          f"phase 11c: launches {n_time}")
    print(f"# phase 11c: screen_all(mesh=) of the shell ({len(got[0])} "
          f"pairs) equals screen_all; launches {n_time}")
    reset_launches()
    got = screen_all_ring(scat, jd_s, threshold_km=SCREEN_KM, mesh=mesh)
    n_ring = launches()
    _same_screen(got, shell_ref, "phase 11d shell")
    d = len(devs)
    check(n_ring["screen_candidates"] == d
          and n_ring["screen_candidates_rect"] == d * (d - 1)
          and n_ring["sgp4_shallow"] == d,
          f"phase 11d: launches {n_ring}")
    jd_m = EPOCH_JD + np.arange(float(SCREEN_TIMES)) / 1440.0
    mixed_ref = screen_all(cat, jd_m, threshold_km=SCREEN_KM)
    _same_screen(screen_all_ring(cat, jd_m, threshold_km=SCREEN_KM,
                                 mesh=mesh), mixed_ref, "phase 11d mixed")
    _same_screen(screen_all(cat, jd_m, threshold_km=SCREEN_KM, mesh=mesh),
                 mixed_ref, "phase 11c mixed")
    # two decayed lanes at local column 0 of two shards (0 and 2 of 4):
    # parked by their local columns they would meet at one point
    decayed = [format_lines(satnum=99990 + k, epoch_jd=SCREEN_EPOCH_JD - 2.0,
                            ecco=5e-4, inclo_deg=53.0, nodeo_deg=10.0 * k,
                            argpo_deg=20.0, mo_deg=30.0, no_rev_day=16.0,
                            bstar=0.5) for k in range(2)]
    shell = screening_shell_text(1998).splitlines()
    lines = [*decayed[0], *shell[:1998], *decayed[1], *shell[1998:]]
    failed = build_catalog("\n".join(lines), device=DEVICE)
    check(len(failed) == 2000, "the catalog with failed lanes")
    res = screen_all_ring(failed, jd_s, threshold_km=SCREEN_KM, mesh=mesh)
    _same_screen(res, screen_all(failed, jd_s, threshold_km=SCREEN_KM),
                 "phase 11d failed lanes")
    hit = set(res[0].tolist()) | set(res[1].tolist())
    check(not {0, 1000} & hit, "phase 11d: a failed lane made a pair")
    err0 = propagate(failed, jd_s[:1], method="fast")[2][0]
    check(bool(err0[0] != 0 and err0[1000] != 0), "the lanes did not fail")
    print(f"# phase 11d: screen_all_ring equals screen_all on the shell "
          f"({len(shell_ref[0])} pairs; launches {n_ring}) and on the mixed "
          f"catalog ({len(mixed_ref[0])} pairs; screen_all(mesh=) too), and "
          f"on 2,000 shell lanes with failed lanes 0 and 1,000 (local column "
          f"0 of two shards): {len(res[0])} pairs, none with them")

    # 11e: the rectangle mode against its plain version
    full = _positions_planes_f32(scat, jd_s)
    n_full = full.shape[2]
    rows = full[:, :, :1003].clone()
    cols = full[:, :, n_full // 2:n_full // 2 + 777].contiguous()
    rows[1, SCREEN_TIMES // 2, 500] = float("nan")
    thr_small = float(np.float32(RECT_SMALL_KM ** 2))
    small_pairs, _ = _rect_vs_twin(rows, cols, thr_small, "1003 x 777")
    before = cuda_screen.LAUNCHES["screen_candidates_rect"]
    _rect_vs_twin(rows, cols, thr_small, "1003 x 777, cap=1", cap=1)
    sync()
    check(cuda_screen.LAUNCHES["screen_candidates_rect"] == before + 2,
          "rectangle mode: the overflow path must launch twice")
    check(len(small_pairs[0]) > 0, "no rectangle pairs within 200 km")
    planes = _ring_planes(scat, jd_s, None, make_mesh(devs), "fast")
    thr2 = float(np.float32((SCREEN_KM * (1.0 + 1.0e-6)) ** 2))
    tile_pairs, rect_err = _rect_vs_twin(planes[1], planes[0], thr2,
                                         "ring tile")
    print(f"# phase 11e: K4 rectangle mode equals its plain version: 1003 x "
          f"777 x {SCREEN_TIMES} with a NaN at {RECT_SMALL_KM} km "
          f"({len(small_pairs[0])} pairs, also with cap=1), the ring tile "
          f"{tuple(planes[1].shape)} x {tuple(planes[0].shape)} at "
          f"{SCREEN_KM} km ({len(tile_pairs[0])} pairs)")

    # 11f: times
    fns = {}
    for name, m in meshes.items():
        fn, args, _ = stage_sharded_fast(cat, jd, mesh=m, layout="planes")
        fns[name] = (fn, args)

    def single():
        return propagate(cat, jd, method="fast", layout="planes")

    t = [_cuda_ms(single, 10)]
    t += [_cuda_ms(lambda f=f, a=a: f(*a), 10) for f, a in fns.values()]
    t += [_cuda_ms(lambda f=f, a=a: f(*a), 10)
          for f, a in reversed(list(fns.values()))]
    t.append(_cuda_ms(single, 10))
    sweep = {"single device": (t[0] + t[-1]) / 2,
             "sat 4": (t[1] + t[4]) / 2, "time 2 x sat 2": (t[2] + t[3]) / 2}
    print(f"# phase 11f [{smi}]: mixed {N_SATS} x {N_TIMES} planes sweep "
          f"(staged, not gathered), {note}: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in sweep.items())
          + f" (in turns: {', '.join(f'{x:.4f}' for x in t)})")
    screens = {
        "screen_all": lambda: screen_all(scat, jd_s, threshold_km=SCREEN_KM),
        "screen_all(mesh=)": lambda: screen_all(
            scat, jd_s, threshold_km=SCREEN_KM, mesh=mesh),
        "screen_all_ring": lambda: screen_all_ring(
            scat, jd_s, threshold_km=SCREEN_KM, mesh=mesh)}
    order = list(screens) + list(reversed(screens))
    st = [(k, _cuda_ms(screens[k], 3)) for k in order]
    screen_ms = {k: sum(v for kk, v in st if kk == k) / 2 for k in screens}
    print(f"# phase 11f [{smi}]: shell screen {N_SATS} x {SCREEN_TIMES} at "
          f"{SCREEN_KM} km, {note}: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in screen_ms.items())
          + f" (in turns: {', '.join(f'{k} {v:.4f}' for k, v in st)})")

    rows, cols = planes[1], planes[0]
    count = torch.zeros(1, dtype=torch.int64, device=rows.device)

    def rect_kernel():
        count.zero_()
        cuda_screen._launch_rect(rows, cols, thr2, cuda_screen.CANDIDATE_CAP,
                                 count)

    def rect_plain():
        return cuda_screen.coarse_candidates_rect_reference(
            rows, cols, thr2, work_bytes=cuda_screen.PLAIN_BYTES_PER_ENTRY
            * rows.shape[2] * PLAIN_COLS)

    rt = [_cuda_ms(rect_plain, 1, warm=False), _cuda_ms(rect_kernel, 20),
          _cuda_ms(rect_kernel, 20), _cuda_ms(rect_plain, 1, warm=False)]
    rect_ms, rect_plain_ms = (rt[1] + rt[2]) / 2, (rt[0] + rt[3]) / 2
    pair_times = SCREEN_TIMES * rows.shape[2] * cols.shape[2]
    rect_bound = bound(nbytes(rows, cols) + 8 * len(tile_pairs[0]),
                       K4_OPS * pair_times, 0)
    regs = [(name, rg, sp, ld) for name, rg, sp, ld in _build.ptxas_report()
            if "ILi2E" in name and "screen_coarse" in name]
    print(f"# phase 11f [{smi}]: K4 rectangle mode on the ring tile "
          f"{rows.shape[2]} x {cols.shape[2]} x {SCREEN_TIMES} "
          f"({pair_times:.4g} pair-times): {rect_ms:.4f} ms, "
          f"{rect_bound[0] / rect_ms:.1%} of the {rect_bound[0]:.4f} ms "
          f"bound ({K4_OPS} f32 operations a pair-time over the whole "
          f"rectangle, by {rect_bound[1]}); plain version {rect_plain_ms:.4f}"
          f" ms (in turns: {', '.join(f'{x:.4f}' for x in rt)}); ptxas "
          + "; ".join(f"{rg} registers, spill stores {sp} B, spill loads "
                      f"{ld} B" for _, rg, sp, ld in regs))
    check(all(sp == ld == 0 for _, _, sp, ld in regs),
          f"K4 rectangle mode spills: {regs}")
    return (n_ring["screen_candidates_rect"], rect_err,
            (rect_ms, rect_plain_ms, rect_bound))


#: phase 10, the numerical stack. 10a: NUMERICAL_LANES Monte-Carlo lanes
#: drawn from default_rng(NUMERICAL_SEED) around the ISS golden TLE's
#: state (sigma 1 km, 1 m/s), RK4 of TwoBody + J2 + Drag over one
#: NUMERICAL_ORBIT_S orbit at NUMERICAL_DT_S, on the card and once on the
#: host (its first NUMERICAL_CPU_CUT lanes where the whole would take over
#: NUMERICAL_CPU_LIMIT_S), TwoBody alone on NUMERICAL_ENERGY_LANES of them;
#: 10b: one adaptive DP8(7) trajectory over NUMERICAL_DP87_S at 60 s outer
#: steps; 10c: run_hohmann_monte_carlo of NUMERICAL_MC_SAMPLES; 10d: the
#: ISS as a Spacecraft over 6 h at 30 s with two impulses, and
#: NUMERICAL_ATTITUDE_STEPS attitude steps. The profiler counts the device
#: work of LAUNCH_STEPS fixed steps.
NUMERICAL_LANES = 100000
NUMERICAL_SEED = 11
NUMERICAL_ORBIT_S = 5400.0
NUMERICAL_DT_S = 30.0
NUMERICAL_CPU_LIMIT_S = 30.0
NUMERICAL_CPU_CUT = 10000
NUMERICAL_ENERGY_LANES = 1000
NUMERICAL_DP87_S = 6 * 3600.0
#: 10b: the other models' trajectories, one of each signature, over this
NUMERICAL_SIGNATURE_S = 3600.0
NUMERICAL_MC_SAMPLES = 1000000
NUMERICAL_ATTITUDE_STEPS = 10000
LAUNCH_STEPS = 10
#: 10a's fixed-step DP8(7) case: the first NUMERICAL_DP87_FIXED_LANES
#: lanes over NUMERICAL_DP87_FIXED_STEPS steps
NUMERICAL_DP87_FIXED_LANES = 10000
NUMERICAL_DP87_FIXED_STEPS = 10
#: ADAPTIVE against its plain version over 10b's trajectory: the same
#: substep count on every outer step, states within this (the two take
#: err^(-1/8) from the device's and the host's pow). It holds where each
#: outer step is one clamped substep, as in 10b's 60 s steps, and over one
#: outer step where h binds; carried over outer steps of several substeps
#: the two part further (1.2e-8 km after 1.5 h of 600 s steps)
ADAPTIVE_TOL_KM = 1e-8
#: the step h that ADAPTIVE's control law returns against its plain
#: version's, relative, where the states are bit-equal: only the last bits
#: of the two pows differ
ADAPTIVE_H_RTOL = 1e-13
#: the outer step over which 10b starts ADAPTIVE and its plain version from
#: each of its trajectory's states with a step that binds
ADAPTIVE_BIND_S = 600.0
#: the integrator kernel's modes in the kernels line: (LAUNCHES key,
#: name, the XLA program it replaces)
INTEGRATE_MODES = (
    ("integrate_fixed",
     "integrate_fixed (the integrator kernel, FIXED: propagate_fixed)",
     "astroz_tpu/propagators/driver.py:30"),
    ("integrate_adaptive",
     "integrate_adaptive (the integrator kernel, TRAJECTORY for one outer "
     "step: dp87_adaptive)",
     "astroz_tpu/propagators/integrators.py:131"),
    ("integrate_trajectory",
     "integrate_trajectory (the integrator kernel, TRAJECTORY: "
     "Propagator.propagate over a DormandPrince87)",
     "astroz_tpu/propagators/driver.py:76"),
    ("integrate_attitude",
     "integrate_attitude (the integrator kernel, ATTITUDE: "
     "propagate_attitude)", "astroz_tpu/calculations.py:273"))


def iss_state():
    """The ISS golden TLE's state (r km, v km/s) by a direct Kepler
    conversion of its mean elements (``tle_to_elements`` +
    ``elements_to_state`` on the card), as numpy f64."""
    from astroz_tpu_torch.calculations import (elements_to_state,
                                               tle_to_elements)
    from astroz_tpu_torch.tle import parse_lines

    r, v = elements_to_state(tle_to_elements(
        parse_lines(GOLDEN_L1, GOLDEN_L2), device=DEVICE))
    return torch.cat([r, v]).cpu().numpy()


def monte_carlo_lanes(n):
    """``n`` states around :func:`iss_state`: gaussian noise of 1 km in
    position and 1 m/s in velocity from ``default_rng(NUMERICAL_SEED)``."""
    rng = np.random.default_rng(NUMERICAL_SEED)
    return iss_state() + rng.normal(
        0.0, [1.0, 1.0, 1.0, 1e-3, 1e-3, 1e-3], (n, 6))


def _mc_forces():
    from astroz_tpu_torch.propagators import Composite, Drag, J2, TwoBody

    return Composite([TwoBody(), J2(), Drag()])


def _dp87_forces():
    from astroz_tpu_torch.propagators import Composite, J2, TwoBody

    return Composite([TwoBody(), J2()])


def _dp87_deriv():
    from astroz_tpu_torch.propagators import make_deriv

    return make_deriv(_dp87_forces())


def _plain_model(accel):
    """``accel`` behind a lambda: the same arithmetic with no kernel
    terms, so that the entry points run their plain loops on the card."""
    return lambda r, v, t: accel(r, v, t)


def _integrate_turns(call, launch, plain, reps, per_graph=10,
                     plain_reps=1):
    """:class:`Turns` of an integrator mode: ``call`` (its wrapper, back
    to back), ``launch`` (the kernel alone, replayed from a CUDA graph)
    and ``plain`` (its plain version on the card, ``plain_reps`` calls
    each side, not warmed again)."""
    return Turns((_cuda_ms(plain, plain_reps, warm=False),
                  _cuda_ms(call, reps), _graph_ms(launch, reps, per_graph),
                  _graph_ms(launch, reps, per_graph), _cuda_ms(call, reps),
                  _cuda_ms(plain, plain_reps, warm=False)))


def _integrate_entry(mode, n_launches, err, turns, bound_ms_by):
    """The kernels line's entry of an integrator mode."""
    key, name, replaces = next(m for m in INTEGRATE_MODES if m[0] == mode)
    return {"name": name, "route": "cuda",
            "source": "astroz_tpu_torch/csrc/integrate_f64.cu",
            "replaces": replaces, "launches": n_launches,
            "max_abs_err": err, "ms": turns.ms, "plain_ms": turns.plain_ms,
            "bound_ms": bound_ms_by[0], "bound_by": bound_ms_by[1],
            "library_ms": None, "device_ms": turns.device_ms}


def _numerical_launches():
    """The device activities (kernels, copies, fills) of LAUNCH_STEPS RK4
    steps of 10a's lanes and model, of one 60 s outer step of 10b's DP8(7)
    trajectory (``dp87_adaptive``), and of a whole 1 h ``Propagator.
    propagate`` of it, from one ``torch.profiler`` session, split by
    marker kernels: a dict of counts."""
    from astroz_tpu_torch.propagators import (DormandPrince87, Propagator,
                                              dp87_adaptive, propagate_fixed)

    accel = _mc_forces()
    lanes = torch.as_tensor(monte_carlo_lanes(NUMERICAL_LANES),
                            device=DEVICE)
    deriv = _dp87_deriv()
    one = torch.as_tensor(iss_state(), device=DEVICE)

    def rk4():
        propagate_fixed(accel, lanes, 0.0, LAUNCH_STEPS * NUMERICAL_DT_S,
                        NUMERICAL_DT_S)

    def dp87():
        dp87_adaptive(deriv, one, 0.0, 60.0, rtol=1e-10)

    def trajectory():
        Propagator(DormandPrince87(_dp87_forces(), rtol=1e-10)).propagate(
            one, 0.0, 3600.0, 60.0)

    def spin():
        torch.cuda._sleep(1000)

    rk4()
    dp87()
    trajectory()
    names = _device_work(rk4, spin, dp87, spin, trajectory)
    cuts = [i for i, n in enumerate(names) if "spin" in n]
    check(len(cuts) == 2, f"phase 10: the profiler saw {names}")

    def counts(part):
        kernels = [n for n in part if not n.startswith(("Memcpy", "Memset"))]
        reads = [n for n in part if n.startswith("Memcpy DtoH")]
        return len(kernels), len(part), len(reads)

    (rk4_k, rk4_all, _), (dp_k, dp_all, _), (tr_k, tr_all, tr_reads) = (
        counts(names[:cuts[0]]), counts(names[cuts[0] + 1:cuts[1]]),
        counts(names[cuts[1] + 1:]))
    return {"rk4_steps": LAUNCH_STEPS, "rk4_kernels": rk4_k,
            "rk4_activities": rk4_all, "dp87_step_kernels": dp_k,
            "dp87_step_activities": dp_all, "trajectory_kernels": tr_k,
            "trajectory_activities": tr_all, "trajectory_reads": tr_reads}


def _op_us(device, n=2000):
    """Host microseconds of one eager torch op on ``device``: ``n`` adds
    to a one-element tensor, synchronized at the end."""
    x = torch.zeros(1, dtype=torch.float64, device=device)
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        x = x + 1.0
    sync()
    return (time.perf_counter() - t0) / n * 1e6


def _syncs(fn):
    """Run ``fn`` once under ``torch.cuda.set_sync_debug_mode("warn")``:
    the host syncs it made (reads back to the host, synchronous copies),
    counted from the warnings."""
    import warnings

    sync()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sync()
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


def _energy(states):
    from astroz_tpu_torch.constants import EARTH

    r = torch.linalg.vector_norm(states[..., :3], dim=-1)
    v = torch.linalg.vector_norm(states[..., 3:], dim=-1)
    return 0.5 * v * v - EARTH.mu / r


#: f64 routines whose throughput on the card phase 10a measures, in the
#: order of F64_RATE_CU's OP: an add, a multiply, a correctly rounded
#: divide, square root and reciprocal, libdevice's pow(x, 5.0) and exp
F64_RATE_OPS = ("add", "mul", "div", "sqrt", "rcp", "pow5", "exp")
F64_RATE_CU = r"""
#include <cuda_runtime.h>
// one step of chain k of a thread: x = op(x), kept finite and away from
// the routines' special cases (pow(1, y), exp's underflow); sqrt, pow and
// exp carry one add or FMA beside the routine (the add's own cost is
// taken off on the host)
template <int OP>
__device__ __forceinline__ double step(double x) {
  switch (OP) {
    case 0: return __dadd_rn(x, 1e-300);
    case 1: return __dmul_rn(x, 0.9999999999999999);
    case 2: return __ddiv_rn(1.7, x);
    case 3: return __dadd_rn(__dsqrt_rn(x), 0.5);
    case 4: return __drcp_rn(x);
    case 5: return __fma_rn(pow(x, 5.0), 0.01, 1.2);
    default: return __dadd_rn(exp(-x), 0.3);
  }
}
template <int OP>
__global__ void op_rate_kernel(double* out, int iters) {
  double x[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) x[k] = 1.3 + 0.01 * k + threadIdx.x * 1e-7;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = step<OP>(x[k]);
  }
  double s = 0.0;
#pragma unroll
  for (int k = 0; k < 8; ++k) s += x[k];
  if (s == 12345.678) out[0] = s;
}
extern "C" int astroz_op_rate(int op, int blocks, int threads, int iters,
                              double* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case 0: op_rate_kernel<0><<<blocks, threads, 0, st>>>(out, iters); break;
    case 1: op_rate_kernel<1><<<blocks, threads, 0, st>>>(out, iters); break;
    case 2: op_rate_kernel<2><<<blocks, threads, 0, st>>>(out, iters); break;
    case 3: op_rate_kernel<3><<<blocks, threads, 0, st>>>(out, iters); break;
    case 4: op_rate_kernel<4><<<blocks, threads, 0, st>>>(out, iters); break;
    case 5: op_rate_kernel<5><<<blocks, threads, 0, st>>>(out, iters); break;
    default: op_rate_kernel<6><<<blocks, threads, 0, st>>>(out, iters);
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def f64_op_seconds():
    """Seconds the whole card takes for one of each F64_RATE_OPS routine
    at its throughput: F64_RATE_CU built as the integrator kernel is
    (``--fmad=true``), 16 blocks of 256 threads an SM, each thread 8
    independent chains, timed with CUDA events; the scaffold's add taken
    off sqrt's, pow's and exp's."""
    import ctypes

    from astroz_tpu_torch import _build

    d = _build.BUILD_DIR / "probes"
    d.mkdir(parents=True, exist_ok=True)
    (d / "f64_rate.cu").write_text(F64_RATE_CU)
    lib_path = d / "libf64_rate.so"
    flags = [f.replace("=false", "=true") for f in _build.NVCC_FLAGS]
    subprocess.run([_build._nvcc(), *flags, "-shared", "-o", str(lib_path),
                    str(d / "f64_rate.cu")], check=True, timeout=600,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.astroz_op_rate.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    out = torch.empty(1, dtype=torch.float64, device=DEVICE)
    blocks = 16 * torch.cuda.get_device_properties(0).multi_processor_count
    threads, iters = 256, 2048
    secs = {}
    for k, name in enumerate(F64_RATE_OPS):
        def run():
            rc = lib.astroz_op_rate(k, blocks, threads, iters,
                                    out.data_ptr(),
                                    torch.cuda.current_stream().cuda_stream)
            check(rc == 0, f"f64 rate probe {name}: cudaError {rc}")
        ms = min(_cuda_ms(run, 3) for _ in range(3))
        secs[name] = ms * 1e-3 / (blocks * threads * iters * 8)
    for name in ("sqrt", "pow5", "exp"):
        secs[name] -= secs["add"]
    return secs


#: f64 operations of the integrator kernel's RK4 FIXED mode, counted from
#: csrc/integrate_f64.cu as the function needs them: each + - * and FMA
#: one op (negations fold into their operands, and divide3's window tests
#: are integer work), the routines by name; a product the code repeats
#: (J2's 5 z2) once, and none for stage 4's weight of 1. A derivative
#: computes |r| once (norm3: 3 mul, 2 add, a square root) ...
FIXED_DERIV_OPS = {"mul": 3, "add": 2, "sqrt": 1}
#: ... then each term (kind_accel), the terms summed left to right (3 adds
#: a term after the first)
FIXED_TERM_OPS = {
    # |r|^3, mu r, and the three quotients through one reciprocal
    # (divide3: q0 and two FMA corrections each)
    "TWO_BODY": {"mul": 8, "fma": 12, "rcp": 1},
    # r_z / |r| (a divide), recip(pow(|r|, 5)) mu', 1 - 5 z2, 3 - 5 z2
    # and the three products of two
    "J2": {"div": 1, "pow5": 1, "rcp": 1, "mul": 9, "add": 2},
    # the altitude, rho (an exp), |v| (norm3), its coefficient and c v
    "DRAG": {"mul": 13, "add": 3, "exp": 1, "sqrt": 1},
}
#: rk4_step's own a step: h / 2 and h / 6 (a divide), the stage states y
#: + off k of stages 1-3, the weighted sum of k1..k4, y + (h / 6) acc
FIXED_RK4_OPS = {"mul": 37, "add": 42, "div": 1}


def fixed_rk4_ops(kinds):
    """The f64 operations a lane-step of the integrator kernel's RK4 FIXED
    mode does for a model of the term kinds ``kinds`` (``ops.
    cuda_integrate.KINDS`` names), ``{op: count}``: four derivatives and
    the step's own arithmetic (:data:`FIXED_RK4_OPS`)."""
    deriv = dict(FIXED_DERIV_OPS)
    deriv["add"] += 3 * (len(kinds) - 1)
    for kind in kinds:
        check(kind in FIXED_TERM_OPS, f"fixed_rk4_ops: no count for {kind}")
        for op, n in FIXED_TERM_OPS[kind].items():
            deriv[op] = deriv.get(op, 0) + n
    ops = dict(FIXED_RK4_OPS)
    for op, n in deriv.items():
        ops[op] = ops.get(op, 0) + 4 * n
    return ops


def f64_work_ms(ops, lane_steps, secs):
    """The least time, ms, of ``lane_steps`` times the f64 operations
    ``ops`` (``{op: count}``, :func:`fixed_rk4_ops`), each at the card's
    rate for it (``secs``, :func:`f64_op_seconds`; an FMA at the
    multiply's)."""
    unit = dict(secs, fma=secs["mul"])
    total = 0.0
    for op, n in ops.items():
        check(op in unit, f"f64_work_ms: no rate for {op}")
        total += n * unit[op]
    return total * lane_steps * 1e3


def _phase10a_lanes(smi):
    """Batched Monte-Carlo lanes through ``propagate_fixed`` on the card
    (the integrator kernel's FIXED mode) and on the host; FIXED against
    its plain version on the card, RK4 on every lane and DP8(7) on some.
    Returns FIXED's kernels-line entry and the card's ms a step."""
    from astroz_tpu_torch.ops import cuda_integrate
    from astroz_tpu_torch.propagators import TwoBody, propagate_fixed
    from astroz_tpu_torch.propagators.driver import fixed_reference
    from astroz_tpu_torch.propagators.forces import kernel_terms

    accel = _mc_forces()
    lanes = monte_carlo_lanes(NUMERICAL_LANES)
    state = torch.as_tensor(lanes, device=DEVICE)
    n_steps = int(NUMERICAL_ORBIT_S // NUMERICAL_DT_S)

    def card():
        return propagate_fixed(accel, state, 0.0, NUMERICAL_ORBIT_S,
                               NUMERICAL_DT_S)[1]

    card()  # the first call builds the kernel library where needed
    sync()
    reset_launches()
    out = card()
    sync()
    moved = {k: n for k, n in launches().items() if n}
    check(moved == {"integrate_fixed": 1}, f"phase 10a: propagate_fixed "
          f"launched {moved}, not the integrator kernel's FIXED mode once")
    n_syncs = _syncs(card)
    check(n_syncs == 0, f"phase 10a: propagate_fixed synced the host "
          f"{n_syncs} times on the card")
    ms = [_cuda_ms(card, 1, warm=False) for _ in range(3)]
    peak = _peak(card)
    n_samples = out.shape[0]
    check(tuple(out.shape) == (n_samples, NUMERICAL_LANES, 6)
          and n_samples == n_steps + 1
          and out.dtype == torch.float64 and bool(out.isfinite().all()),
          f"phase 10a: output {tuple(out.shape)} {out.dtype}")
    # FIXED against its plain version on the card, then both in turns
    def kernel():
        return cuda_integrate.fixed(accel, state, 0.0, n_steps,
                                    NUMERICAL_DT_S)

    def plain():
        return fixed_reference(accel, state, 0.0, n_steps, NUMERICAL_DT_S)

    want = plain()
    err = float((out - want).abs().max())
    check(torch.equal(out, want), f"phase 10a: FIXED (RK4) differs from "
          f"its plain version on the card by {err} km")
    del want
    turns = _integrate_turns(kernel, kernel, plain, 5, per_graph=2)
    # the bound: the larger of the bytes and the f64 work the kernel's
    # RK4 step needs, each op at the card's measured rate for it (pow,
    # exp and the correctly rounded divides and square roots are tens of
    # f64 instructions each)
    secs = f64_op_seconds()
    by_op = fixed_rk4_ops([kind for kind, _ in kernel_terms(accel)])
    work_ms = f64_work_ms(by_op, NUMERICAL_LANES * n_steps, secs)
    step_ops = sum(by_op.values())  # f64 operations a lane-step
    bytes_ms = nbytes(state, out) / PEAK_BYTES_S * 1e3
    fixed_bound = ((work_ms, "operations") if work_ms > bytes_ms
                   else (bytes_ms, "bytes"))
    f64_lane = (torch.cuda.get_device_properties(0).multi_processor_count
                * F64_LANES_PER_SM * _max_sm_clock_hz())  # f64 lane-cycles a s
    rate_text = ", ".join(f"{k} {v * f64_lane:.1f}" for k, v in secs.items())
    step_cycles = work_ms * 1e-3 / (NUMERICAL_LANES * n_steps) * f64_lane
    ops_text = ", ".join(f"{op} {n}" for op, n in
                         sorted(by_op.items(), key=lambda x: -x[1]))
    # DP8(7) fixed steps on some of the lanes
    sub = state[:NUMERICAL_DP87_FIXED_LANES]

    def dp_kernel():
        return cuda_integrate.fixed(accel, sub, 0.0,
                                    NUMERICAL_DP87_FIXED_STEPS,
                                    NUMERICAL_DT_S, method="dp87")

    def dp_plain():
        return fixed_reference(accel, sub, 0.0, NUMERICAL_DP87_FIXED_STEPS,
                               NUMERICAL_DT_S, method="dp87")

    dp_out, dp_want = dp_kernel(), dp_plain()
    dp_err = float((dp_out - dp_want).abs().max())
    check(torch.equal(dp_out, dp_want), f"phase 10a: FIXED (DP8(7)) "
          f"differs from its plain version on the card by {dp_err} km")
    dp_turns = _integrate_turns(dp_kernel, dp_kernel, dp_plain, 10)
    dp_bound = bound(nbytes(sub, dp_out), *count_ops(dp_plain))
    # the host: estimate from 10 steps, then the whole orbit once
    t0 = time.perf_counter()
    propagate_fixed(accel, lanes, 0.0, 10 * NUMERICAL_DT_S, NUMERICAL_DT_S,
                    device="cpu")
    projected = (time.perf_counter() - t0) * (n_samples - 1) / 10
    n_cpu = NUMERICAL_LANES if projected <= NUMERICAL_CPU_LIMIT_S \
        else NUMERICAL_CPU_CUT
    t0 = time.perf_counter()
    _, host = propagate_fixed(accel, lanes[:n_cpu], 0.0, NUMERICAL_ORBIT_S,
                              NUMERICAL_DT_S, device="cpu")
    host_s = time.perf_counter() - t0
    dr = float((out[:, :n_cpu, :3].cpu() - host[..., :3]).abs().max())
    check(dr <= 1e-6, f"phase 10a: card vs host max|dr| {dr} km")
    # TwoBody alone: the energy drift after the orbit
    two = propagate_fixed(TwoBody(), state[:NUMERICAL_ENERGY_LANES], 0.0,
                          NUMERICAL_ORBIT_S, NUMERICAL_DT_S)[1]
    e = _energy(two)
    drift = float(((e[-1] - e[0]) / e[0]).abs().max())
    check(drift < 1e-5, f"phase 10a: TwoBody energy drift {drift}")
    card_ms = float(np.mean(ms))
    host_ms = host_s * 1e3 * (NUMERICAL_LANES / n_cpu)
    steps = n_samples - 1
    print(f"# phase 10 [{smi}]: 10a: RK4 propagate_fixed of "
          f"Composite([TwoBody, J2, Drag]), {NUMERICAL_LANES} lanes x "
          f"{n_samples} samples ({NUMERICAL_ORBIT_S:.0f} s at "
          f"{NUMERICAL_DT_S:.0f} s), f64 output {out.numel() * 8 / 1e9:.3f} "
          f"GB: card {card_ms:.3f} ms (CUDA events, mean of 3 after a "
          f"warm-up: {', '.join(f'{x:.3f}' for x in ms)}), "
          f"{card_ms / steps:.5f} ms a step, launches {moved}, {n_syncs} "
          f"host syncs a call; peak device memory {peak:.3f} GiB")
    print(f"# phase 10 [{smi}]: 10a: FIXED (RK4) bit-equal to its plain "
          f"version on the card (max|diff| {err}); "
          f"{turns.text('integrate_fixed')}; bound {fixed_bound[0]:.4f} ms "
          f"by {fixed_bound[1]} (bytes {bytes_ms:.4f} ms, f64 work "
          f"{work_ms:.4f} ms: {step_ops} f64 operations a lane-step of the "
          f"kernel's RK4 step, counted from its source ({ops_text}), each "
          f"at the card's rate for it: {step_cycles:.1f} f64-lane cycles a "
          f"lane-step, in f64-lane cycles an op: {rate_text}; "
          f"{turns.device_ms / fixed_bound[0]:.2f}x the bound replayed)")
    print(f"# phase 10 [{smi}]: 10a: FIXED (DP8(7)), "
          f"{NUMERICAL_DP87_FIXED_LANES} lanes x "
          f"{NUMERICAL_DP87_FIXED_STEPS} steps: bit-equal to its plain "
          f"version (max|diff| {dp_err}); {dp_turns.text('dp87')}; bound "
          f"{dp_bound[0]:.5f} ms ({dp_bound[1]})")
    cut_note = "" if n_cpu == NUMERICAL_LANES else (
        f" (the first {n_cpu} lanes: all {NUMERICAL_LANES} were projected "
        f"at {projected:.1f} s, over {NUMERICAL_CPU_LIMIT_S:.0f} s; scaled "
        f"to {NUMERICAL_LANES} lanes: {host_ms:.0f} ms)")
    print(f"# phase 10 [{smi}]: 10a: host (device='cpu', "
          f"{torch.get_num_threads()} threads) {host_s * 1e3:.1f} ms, one "
          f"run{cut_note}; card vs host max|dr| {dr:.3e} km over {n_cpu} "
          f"lanes; {'the card' if card_ms < host_ms else 'the host'} wins "
          f"by {max(host_ms, card_ms) / min(host_ms, card_ms):.1f}x; TwoBody "
          f"alone, {NUMERICAL_ENERGY_LANES} lanes: max relative energy "
          f"drift {drift:.3e} after the orbit")
    return (_integrate_entry("integrate_fixed", moved["integrate_fixed"],
                             err, turns, fixed_bound), card_ms / steps)


def _dp87_run(integ, start, n_outer, dt=60.0):
    """``Propagator(integ).propagate``'s outer loop over ``n_outer`` steps
    of ``dt`` from ``start``: the (n_outer + 1, 6) states, the substeps of
    each outer step and the step ``h_current`` after each."""
    state, states, subs, hs = start, [start], [], []
    for k in range(n_outer):
        before = integ.n_substeps
        state = integ.step(state, k * dt, dt)
        subs.append(integ.n_substeps - before)
        hs.append(integ.h_current)
        states.append(state)
    return torch.stack([torch.as_tensor(x) for x in states]), subs, hs


def _signature_models():
    """10b's other models: one of each signature the one-thread modes are
    compiled for besides the main path's TwoBody + J2 (TwoBody; TwoBody +
    J2 + Drag) and one of none (every kind, through the kernel's run-time
    dispatch)."""
    from astroz_tpu_torch.propagators import (
        Composite, Drag, ImprovedDrag, J2, J3, J4, SolarRadiationPressure,
        TwoBody)

    return {"TwoBody": TwoBody(),
            "TwoBody + J2 + Drag": Composite([TwoBody(), J2(), Drag()]),
            "every kind": Composite([TwoBody(), J2(), J3(), J4(),
                                     ImprovedDrag(f107=220.0),
                                     SolarRadiationPressure()])}


def _dp87_signatures(start):
    """``Propagator.propagate`` over a ``DormandPrince87`` (rtol 1e-10) of
    each of :func:`_signature_models` on the card from ``start`` over
    NUMERICAL_SIGNATURE_S at 60 s outer steps: one TRAJECTORY launch, bit
    for bit the loop of ``step`` calls (one launch each: states, each
    outer step's substeps and |h|, ``h_current``, ``n_substeps``), and
    against the plain trajectory on the card
    (``adaptive_trajectory_reference``) the same counts, states within
    ADAPTIVE_TOL_KM, and |h| within ADAPTIVE_H_RTOL after each outer step
    that starts from bit-equal states and takes one substep (where h
    binds, as across the Earth's shadow for SRP, the kernel's err^(-1/8)
    from the device's pow and the plain loop's from the host's carry the
    two apart, as ADAPTIVE_TOL_KM says). Returns {model: (substeps, outer
    steps of several substeps, the first outer step after which the
    states differ or None, max|dr| km, |h| relative, outer steps whose
    |h| was held)}."""
    from astroz_tpu_torch.ops import cuda_integrate
    from astroz_tpu_torch.propagators import DormandPrince87, Propagator
    from astroz_tpu_torch.propagators.integrators import (
        adaptive_trajectory_reference)

    n_outer = int(NUMERICAL_SIGNATURE_S // 60.0)
    seen = {}
    for name, accel in _signature_models().items():
        one = DormandPrince87(accel, rtol=1e-10, device=DEVICE)
        before = cuda_integrate.LAUNCHES["integrate_trajectory"]
        got = Propagator(one).propagate(start, 0.0, NUMERICAL_SIGNATURE_S,
                                        60.0)[1]
        check(cuda_integrate.LAUNCHES["integrate_trajectory"] == before + 1,
              f"phase 10b: {name}: Propagator.propagate did not launch "
              f"TRAJECTORY once")
        loop = DormandPrince87(accel, rtol=1e-10, device=DEVICE)
        k_states, k_subs, k_h = _dp87_run(loop, start, n_outer)
        t_states, t_subs, t_h, _ = cuda_integrate.trajectory(
            one.deriv, start, 0.0, 60.0, n_outer + 1, rtol=1e-10,
            atol=1e-12, h_carried=None, h_min=1e-3, h_max=3600.0,
            max_substeps=10000)
        check(torch.equal(got, k_states) and torch.equal(t_states, k_states)
              and t_subs.tolist() == k_subs and t_h.tolist() == k_h
              and (one.h_current, one.n_substeps)
              == (loop.h_current, loop.n_substeps),
              f"phase 10b: {name}: TRAJECTORY differs from the loop of "
              f"step calls")
        p_states, p_subs, p_h, _ = adaptive_trajectory_reference(
            one.deriv, start, 0.0, 60.0, n_outer + 1, rtol=1e-10,
            atol=1e-12)
        dr = float((t_states - p_states)[:, :3].abs().max())
        same = [bool(torch.equal(a, b)) for a, b in zip(t_states, p_states)]
        held = [k for k in range(n_outer) if same[k] and p_subs[k] == 1]
        h_rel = max((_rel(float(t_h[k]), float(p_h[k])) for k in held),
                    default=0.0)
        check(t_subs.tolist() == p_subs.tolist() and dr <= ADAPTIVE_TOL_KM
              and h_rel <= ADAPTIVE_H_RTOL, f"phase 10b: {name}: TRAJECTORY "
              f"vs its plain version: counts equal "
              f"{t_subs.tolist() == p_subs.tolist()}, max|dr| {dr} km, h "
              f"relative {h_rel} over {len(held)} outer steps")
        seen[name] = (one.n_substeps, int((p_subs > 1).sum()),
                      same.index(False) if False in same else None, dr,
                      h_rel, len(held))
    return seen


def _rel(a, b):
    return abs(a - b) / abs(b)


def _dp87_binding(deriv, states, hs, dt=60.0):
    """ADAPTIVE against its plain version from each of ``states`` (10b's
    trajectory, at ``dt`` apart) over ADAPTIVE_BIND_S, where the step
    binds and is not carried: one substep of ``hs``, the trajectory's h
    after each outer step (mostly accepted), one of ADAPTIVE_BIND_S (rejected: the shrink law),
    each with the state bit-equal and h within ADAPTIVE_H_RTOL, and the
    whole outer step from h = ADAPTIVE_BIND_S, with the same substep count
    and states within ADAPTIVE_TOL_KM. Returns a dict of what it saw."""
    from astroz_tpu_torch.ops import cuda_integrate
    from astroz_tpu_torch.propagators.integrators import adaptive_reference

    kw = dict(rtol=1e-10, atol=1e-12, h_min=1e-3, h_max=3600.0)
    one = {**kw, "max_substeps": 1}
    seen = {"starts": len(hs), "accepted": 0, "rejected": 0, "h_rel": 0.0,
            "whole_bits": 0, "whole_dr": 0.0, "whole_h_rel": 0.0,
            "substeps": 0}
    for k, h in enumerate(hs):
        y, t0 = states[k], k * dt
        t1 = t0 + ADAPTIVE_BIND_S
        for h0 in (h, ADAPTIVE_BIND_S):
            got = cuda_integrate.adaptive(deriv, y, t0, t1, h0, **one)
            want = adaptive_reference(deriv, y, t0, t1, h0, **one)
            check(torch.equal(got[0], want[0]) and got[2] == want[2] == 1,
                  f"phase 10b: ADAPTIVE's one substep of {h0} s from outer "
                  f"step {k} differs from its plain version's")
            rel = _rel(got[1], want[1])
            check(rel <= ADAPTIVE_H_RTOL, f"phase 10b: ADAPTIVE's next h "
                  f"{got[1]} after one substep of {h0} s from outer step "
                  f"{k}, its plain version's {want[1]}")
            seen["h_rel"] = max(seen["h_rel"], rel)
            seen["rejected" if torch.equal(want[0], y) else "accepted"] += 1
        got = cuda_integrate.adaptive(deriv, y, t0, t1, ADAPTIVE_BIND_S,
                                      max_substeps=10000, **kw)
        want = adaptive_reference(deriv, y, t0, t1, ADAPTIVE_BIND_S,
                                  max_substeps=10000, **kw)
        check(got[2] == want[2], f"phase 10b: from outer step {k} over "
              f"{ADAPTIVE_BIND_S} s ADAPTIVE took {got[2]} substeps, its "
              f"plain version {want[2]}")
        dr = float((got[0] - want[0]).abs().max())
        check(dr <= ADAPTIVE_TOL_KM, f"phase 10b: from outer step {k} over "
              f"{ADAPTIVE_BIND_S} s ADAPTIVE vs its plain version {dr} km")
        seen["whole_bits"] += bool(torch.equal(got[0], want[0]))
        seen["whole_dr"] = max(seen["whole_dr"], dr)
        seen["whole_h_rel"] = max(seen["whole_h_rel"], _rel(got[1], want[1]))
        seen["substeps"] += want[2]
    return seen


def _phase10b_dp87(smi):
    """One adaptive DP8(7) trajectory through ``Propagator.propagate``:
    on the card in one TRAJECTORY launch, through ``DormandPrince87.step``
    (one ADAPTIVE launch an outer step), through the plain loop on the
    card, and on the host, in turns; TRAJECTORY bit for bit against the
    ADAPTIVE launches, both against their plain versions; one outer step
    of ADAPTIVE and the whole TRAJECTORY timed in turns with theirs.
    Returns ADAPTIVE's and TRAJECTORY's kernels-line entries."""
    from astroz_tpu_torch.constants import EARTH
    from astroz_tpu_torch.ops import cuda_integrate
    from astroz_tpu_torch.propagators import (DormandPrince87, Propagator,
                                              TwoBody)
    from astroz_tpu_torch.propagators.integrators import (
        adaptive_reference, adaptive_trajectory_reference)

    accel = _dp87_forces()
    start = iss_state()
    on_card = torch.as_tensor(start, device=DEVICE)
    n_outer = int(NUMERICAL_DP87_S // 60.0)
    routes = {"cpu": ("cpu", accel), "kernel": (DEVICE, accel),
              "steps": (DEVICE, accel),
              "plain": (DEVICE, _plain_model(accel))}

    def run(route, duration=NUMERICAL_DP87_S):
        device, model = routes[route]
        integ = DormandPrince87(model, rtol=1e-10, device=device)
        state = start if device == "cpu" else on_card
        t0 = time.perf_counter()
        if route == "steps":  # the outer loop of step calls
            states = _dp87_run(integ, state, int(duration // 60.0))[0]
        else:
            states = Propagator(integ).propagate(state, 0.0, duration,
                                                 60.0)[1]
        end = states[-1].cpu()
        return (time.perf_counter() - t0) * 1e3, integ.n_substeps, end

    run("kernel", 600.0)  # warm up the kernel
    run("steps", 600.0)
    # the main path: the trajectory through Propagator and through step
    reset_launches()
    Propagator(DormandPrince87(accel, rtol=1e-10)).propagate(
        on_card, 0.0, NUMERICAL_DP87_S, 60.0)
    _dp87_run(DormandPrince87(accel, rtol=1e-10), on_card, n_outer)
    sync()
    moved = {k: n for k, n in launches().items() if n}
    check(moved == {"integrate_trajectory": 1,
                    "integrate_adaptive": n_outer},
          f"phase 10b: Propagator.propagate and the loop of step calls "
          f"launched {moved}, not TRAJECTORY once and ADAPTIVE once an "
          f"outer step")
    ms = {r: [] for r in routes}
    subs, ends = {}, {}
    for route in ("cpu", "plain", "steps", "kernel", "kernel", "steps",
                  "plain", "cpu"):
        t, subs[route], ends[route] = run(route)
        ms[route].append(t)
    # the host syncs of one Propagator.propagate call on the card (1 h)
    reads = _syncs(lambda: Propagator(DormandPrince87(
        accel, rtol=1e-10)).propagate(on_card, 0.0, 3600.0, 60.0))
    check(reads == 1, f"phase 10b: Propagator.propagate synced the host "
          f"{reads} times, not once")
    check(subs["cpu"] == subs["kernel"] == subs["steps"], f"phase 10b: "
          f"substeps host {subs['cpu']} card {subs['kernel']} through step "
          f"{subs['steps']}")
    dr = float((ends["kernel"] - ends["cpu"])[:3].abs().max())
    check(dr <= 1e-5, f"phase 10b: card vs host final |dr| {dr} km")
    # TRAJECTORY against the ADAPTIVE launches, bit for bit
    steps_integ = DormandPrince87(accel, rtol=1e-10, device=DEVICE)
    k_states, k_subs, k_h = _dp87_run(steps_integ, on_card, n_outer)
    deriv = _dp87_deriv()
    kw = dict(rtol=1e-10, atol=1e-12, h_min=1e-3, h_max=3600.0,
              max_substeps=10000)
    t_states, t_subs, t_h, t_info = cuda_integrate.trajectory(
        deriv, on_card, 0.0, 60.0, n_outer + 1, h_carried=None, **kw)
    one = DormandPrince87(accel, rtol=1e-10)
    p_one = Propagator(one).propagate(on_card, 0.0, NUMERICAL_DP87_S,
                                      60.0)[1]
    traj_bits = (torch.equal(t_states, k_states) and torch.equal(p_one,
                                                                 k_states)
                 and t_subs.tolist() == k_subs and t_h.tolist() == k_h
                 and t_info.tolist() == [n_outer, steps_integ.h_current,
                                         steps_integ.n_substeps,
                                         steps_integ.h_current]
                 and (one.h_current, one.n_substeps)
                 == (steps_integ.h_current, steps_integ.n_substeps))
    check(traj_bits, "phase 10b: TRAJECTORY differs from the ADAPTIVE "
          "launches of step (states, substeps, h or the integrator's "
          "h_current and n_substeps)")
    # ADAPTIVE against its plain version on the card, outer step by step
    p_states, p_subs, p_h = _dp87_run(DormandPrince87(
        _plain_model(accel), rtol=1e-10, device=DEVICE), on_card, n_outer)
    err = float((k_states - p_states)[:, :3].abs().max())
    bits = bool(torch.equal(k_states, p_states))
    check(k_subs == p_subs, "phase 10b: ADAPTIVE and its plain version "
          "took different substep counts on some outer step")
    check(err <= ADAPTIVE_TOL_KM, f"phase 10b: ADAPTIVE vs its plain "
          f"version max|dr| {err} km")
    h_rel = max(_rel(a, b) for a, b in zip(k_h, p_h))
    check(h_rel <= ADAPTIVE_H_RTOL, f"phase 10b: ADAPTIVE's h_current vs "
          f"its plain version's, relative {h_rel} on some outer step")
    # TRAJECTORY against its plain version on the card
    r_states, r_subs, r_h, r_info = adaptive_trajectory_reference(
        deriv, on_card, 0.0, 60.0, n_outer + 1, rtol=1e-10, atol=1e-12)
    t_err = float((t_states - r_states)[:, :3].abs().max())
    t_h_rel = float(((t_h - r_h).abs() / r_h.abs()).max())
    check(t_subs.tolist() == r_subs.tolist()
          and t_err <= ADAPTIVE_TOL_KM and t_h_rel <= ADAPTIVE_H_RTOL,
          f"phase 10b: TRAJECTORY vs its plain version: counts equal "
          f"{t_subs.tolist() == r_subs.tolist()}, max|dr| {t_err} km, h "
          f"relative {t_h_rel}")
    # where h binds: from each state of the trajectory, not carried
    bind = _dp87_binding(deriv, p_states[:-1], p_h)
    # a model of each other signature
    sigs = _dp87_signatures(on_card)
    # a circular 500 km orbit returns to its start after one period
    r0 = EARTH.eq_radius + 500.0
    vc = np.sqrt(EARTH.mu / r0)
    circ = np.array([r0, 0.0, 0.0, 0.0, vc * np.cos(0.9), vc * np.sin(0.9)])
    per = 2 * np.pi * np.sqrt(r0 ** 3 / EARTH.mu)
    end = Propagator(DormandPrince87(TwoBody(), rtol=1e-12, atol=1e-12,
                                     device=DEVICE)).propagate_to(
        circ, 0.0, per, per).cpu().numpy()
    closure = float(np.linalg.norm(end[:3] - circ[:3]))
    check(closure < 1e-3, f"phase 10b: circular orbit closure {closure} km")
    # one outer step (0 -> 60 s from the ISS state) of ADAPTIVE, and the
    # whole trajectory through TRAJECTORY, each in turns with its plain
    # version
    step_kw = dict(kw, max_substeps=10000)
    turns = _integrate_turns(
        lambda: cuda_integrate.adaptive(deriv, on_card, 0.0, 60.0, 60.0,
                                        **step_kw),
        lambda: cuda_integrate.trajectory(deriv, on_card, 0.0, 60.0, 2,
                                          h_carried=60.0, **step_kw),
        lambda: adaptive_reference(deriv, on_card, 0.0, 60.0, 60.0,
                                   **step_kw),
        200, plain_reps=20)
    f32, f64 = count_ops(lambda: adaptive_reference(
        deriv, on_card, 0.0, 60.0, 60.0, **step_kw))
    step_bound = bound(nbytes(on_card) + 9 * 8, f32, f64)
    traj_turns = _integrate_turns(
        lambda: Propagator(DormandPrince87(accel, rtol=1e-10)).propagate(
            on_card, 0.0, NUMERICAL_DP87_S, 60.0),
        lambda: cuda_integrate.trajectory(deriv, on_card, 0.0, 60.0,
                                          n_outer + 1, h_carried=None, **kw),
        lambda: adaptive_trajectory_reference(
            deriv, on_card, 0.0, 60.0, n_outer + 1, rtol=1e-10, atol=1e-12),
        5, per_graph=1)
    f32, f64 = count_ops(lambda: adaptive_trajectory_reference(
        deriv, on_card, 0.0, 60.0, n_outer + 1, rtol=1e-10, atol=1e-12))
    traj_bound = bound(nbytes(on_card, t_states, t_subs, t_h, t_info), f32,
                       f64)
    clock = _max_sm_clock_hz()
    n = subs["kernel"]
    traj_cycles = traj_turns.device_ms * 1e-3 * clock / n
    mean = {r: float(np.mean(ms[r])) for r in ms}
    turns_text = {r: ", ".join(f"{x:.2f}" for x in ms[r]) for r in ms}
    fastest = min(mean, key=mean.get)
    print(f"# phase 10 [{smi}]: 10b: Propagator(DormandPrince87(Composite("
          f"[TwoBody, J2]), rtol 1e-10)), ISS {NUMERICAL_DP87_S / 3600:.0f} h "
          f"at 60 s outer steps: {n} substeps on each route; host "
          f"{mean['cpu']:.1f} ms ({turns_text['cpu']}), card through "
          f"TRAJECTORY {mean['kernel']:.3f} ms ({turns_text['kernel']}), "
          f"card through step (ADAPTIVE an outer step) {mean['steps']:.2f} "
          f"ms ({turns_text['steps']}), card through the plain loop "
          f"{mean['plain']:.1f} ms ({turns_text['plain']}) (host clock, the "
          f"final state's copy included, in turns host, plain, step, "
          f"TRAJECTORY, TRAJECTORY, step, plain, host); launches of "
          f"Propagator.propagate and the loop of step calls {moved}; "
          f"{reads} host sync in a Propagator.propagate call of 1 h; the "
          f"fastest, {fastest}, wins by "
          f"{sorted(mean.values())[1] / mean[fastest]:.1f}x over the next")
    print(f"# phase 10 [{smi}]: 10b: TRAJECTORY bit-equal to the ADAPTIVE "
          f"launches over the {n_outer} outer steps (states, substeps, h, "
          f"h_current, n_substeps: {traj_bits}); against its plain version "
          f"counts equal, max|dr| {t_err!r} km, h within {t_h_rel!r} "
          f"relative; ADAPTIVE vs its plain version: substep counts equal "
          f"on each, max|dr| {err:.3e} km (bit-equal: {bits}); card vs host "
          f"final |dr| {dr:.3e} km; a circular 500 km orbit, TwoBody, rtol "
          f"1e-12, back at its start after one period within "
          f"{closure * 1e3:.3f} m on the card")
    print(f"# phase 10 [{smi}]: 10b: ADAPTIVE's h_current vs its plain "
          f"version's over the {n_outer} outer steps: max relative "
          f"{h_rel!r}; where h binds, from each of the {bind['starts']} "
          f"states over {ADAPTIVE_BIND_S:.0f} s: one substep of the "
          f"trajectory's h and one of {ADAPTIVE_BIND_S:.0f} s "
          f"({bind['accepted']} accepted, {bind['rejected']} rejected) "
          f"bit-equal with the next h within {bind['h_rel']!r} relative; "
          f"the whole {ADAPTIVE_BIND_S:.0f} s from h {ADAPTIVE_BIND_S:.0f} "
          f"s ({bind['substeps']} substeps): counts equal on each, "
          f"{bind['whole_bits']} of {bind['starts']} bit-equal, max|d| "
          f"{bind['whole_dr']!r} km, h_final within {bind['whole_h_rel']!r} "
          f"relative")
    print(f"# phase 10 [{smi}]: 10b: the other signatures, "
          f"{NUMERICAL_SIGNATURE_S / 3600:.0f} h at 60 s outer steps: "
          f"TRAJECTORY bit-equal to the loop of step calls and, against its "
          f"plain version, counts equal; " + "; ".join(
              f"{k}: {v[0]} substeps ({v[1]} outer steps of several), "
              f"states bit-equal up to {'the end' if v[2] is None else v[2]}"
              f", max|dr| {v[3]!r} km, h within {v[4]!r} relative over "
              f"{v[5]} outer steps" for k, v in sigs.items()))
    print(f"# phase 10 [{smi}]: 10b: one dp87_adaptive call (0 -> 60 s "
          f"from the ISS state, one substep): "
          f"{turns.text('integrate_adaptive')}; bound "
          f"{step_bound[0]:.6f} ms ({step_bound[1]})")
    print(f"# phase 10 [{smi}]: 10b: the whole trajectory ({n_outer} outer "
          f"steps, {n} substeps): {traj_turns.text('integrate_trajectory')}; "
          f"{traj_cycles:.0f} cycles a substep replayed at "
          f"{clock / 1e9:.3f} GHz; bound {traj_bound[0]:.6f} ms "
          f"({traj_bound[1]})")
    return (_integrate_entry("integrate_adaptive",
                             moved["integrate_adaptive"], err, turns,
                             step_bound),
            _integrate_entry("integrate_trajectory",
                             moved["integrate_trajectory"], t_err,
                             traj_turns, traj_bound))


def _phase10c_hohmann(smi):
    """``run_hohmann_monte_carlo`` at NUMERICAL_MC_SAMPLES on the card."""
    from astroz_tpu_torch.montecarlo import (MonteCarloConfig,
                                             run_hohmann_monte_carlo)

    cfg = MonteCarloConfig(n_samples=NUMERICAL_MC_SAMPLES)
    res = run_hohmann_monte_carlo(cfg, device=DEVICE)
    ms = _wall_ms(lambda: run_hohmann_monte_carlo(cfg, device=DEVICE), 3)[0]
    t0 = time.perf_counter()
    host = run_hohmann_monte_carlo(cfg, device="cpu")
    host_ms = (time.perf_counter() - t0) * 1e3
    tot = res["total_delta_v"]
    check(abs(tot.mean - 3.85) < 0.1, f"phase 10c: mean total dv "
          f"{tot.mean}")
    check(all(s.n + s.n_failed == NUMERICAL_MC_SAMPLES
              for s in res.values()), "phase 10c: n + n_failed")
    se = np.hypot(tot.std, host["total_delta_v"].std) / np.sqrt(tot.n)
    d_mean = abs(tot.mean - host["total_delta_v"].mean)
    check(d_mean <= 4 * se, f"phase 10c: card and host means differ by "
          f"{d_mean} ({se} combined standard error)")
    print(f"# phase 10 [{smi}]: 10c: run_hohmann_monte_carlo of "
          f"{NUMERICAL_MC_SAMPLES} samples: card {ms:.2f} ms (host clock, "
          f"mean of 3 after a warm-up), host {host_ms:.2f} ms (one run); "
          f"mean total dv {tot.mean:.6f} km/s (host "
          f"{host['total_delta_v'].mean:.6f}), std {tot.std:.6f}, n "
          f"{tot.n} + failed {tot.n_failed}")
    return ms, host_ms


def _plane_angle_deg(a, b):
    ha, hb = np.cross(a[:3], a[3:]), np.cross(b[:3], b[3:])
    c = np.dot(ha, hb) / (np.linalg.norm(ha) * np.linalg.norm(hb))
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def _phase10d_spacecraft(smi):
    """The ISS as a ``Spacecraft`` with a prograde and a plane-change
    impulse, and attitude propagation: on the card through the integrator
    kernel (FIXED, ATTITUDE), on the card through their plain versions,
    and on the host. Returns ATTITUDE's kernels-line entry and FIXED's
    launches on the spacecraft's path."""
    from astroz_tpu_torch.calculations import (attitude_reference,
                                               state_to_elements)
    from astroz_tpu_torch.ops import cuda_integrate
    from astroz_tpu_torch.spacecraft import Impulse, ImpulseKind, Spacecraft
    from astroz_tpu_torch.tle import parse_lines

    tle = parse_lines(GOLDEN_L1, GOLDEN_L2)
    burn = np.deg2rad(5.0)
    imps = [Impulse(time=3600.0, kind=ImpulseKind.PROGRADE, magnitude=0.1),
            Impulse(time=10800.0, kind=ImpulseKind.PLANE_CHANGE,
                    delta_inclination=burn)]
    w0, inertia = np.array([0.01, -0.02, 0.1]), np.array([10.0, 12.0, 20.0])

    def craft(route):
        sc = Spacecraft.from_tle(tle, device="cpu" if route == "cpu"
                                 else DEVICE)
        if route == "plain":  # the same model without kernel terms
            forces = sc._forces()
            sc._forces = lambda: _plain_model(forces)
        return sc

    def orbit(route):
        sc = craft(route)
        start = sc.state.copy()
        t0 = time.perf_counter()
        times, states = sc.propagate(0.0, 0.25, 30.0, impulses=imps)
        return (time.perf_counter() - t0) * 1e3, (start, times, states)

    orbit("kernel")  # warm-up
    out, ms = {}, {r: [] for r in ("cpu", "kernel", "plain")}
    moved = None
    for route in ("cpu", "plain", "kernel", "kernel", "plain"):
        if route == "kernel" and moved is None:
            reset_launches()
            t, out[route] = orbit(route)
            moved = {k: n for k, n in launches().items() if n}
        else:
            t, out[route] = orbit(route)
        ms[route].append(t)
    check(moved == {"integrate_fixed": 3}, f"phase 10d: the spacecraft "
          f"launched {moved}, not FIXED once a segment (3)")
    start, times, states = out["kernel"]
    check(np.array_equal(states, out["plain"][2]), "phase 10d: the "
          "spacecraft through FIXED differs from its plain version")
    check(np.array_equal(times, out["cpu"][1]), "phase 10d: sample times")
    dr = float(np.abs(states[:, :3] - out["cpu"][2][:, :3]).max())
    check(dr <= 1e-5, f"phase 10d: card vs host max|dr| {dr} km")
    el0 = state_to_elements(start[:3], start[3:], device=DEVICE)
    el1 = state_to_elements(states[-1, :3], states[-1, 3:], device=DEVICE)
    da = float(el1.semi_major_axis - el0.semi_major_axis)
    di = float(np.degrees(float(el1.inclination - el0.inclination)))
    k = np.flatnonzero(times == imps[1].time)
    check(len(k) == 2, "phase 10d: the plane change's two samples")
    turn = _plane_angle_deg(states[k[0]], states[k[1]])
    check(da > 100.0, f"phase 10d: the orbit was raised by {da} km only")
    check(abs(turn - np.degrees(burn)) < 0.5 and abs(di) > 0.1,
          f"phase 10d: the plane turned {turn} deg, inclination {di} deg")
    # attitude: the Spacecraft on the card and on the host
    quat, att_ms = {}, {}
    for device in (DEVICE, "cpu"):
        sc = Spacecraft.from_tle(tle, device=device)
        q0 = sc.quaternion.copy()
        sc.angular_velocity, sc.inertia_diag = w0.copy(), inertia.copy()
        if device == DEVICE:
            sc.propagate_attitude(0.01, 1.0)  # warm-up
            sc.quaternion, sc.angular_velocity = q0.copy(), w0.copy()
            reset_launches()
        t0 = time.perf_counter()
        sc.propagate_attitude(0.01, 0.01 * NUMERICAL_ATTITUDE_STEPS)
        att_ms[device] = (time.perf_counter() - t0) * 1e3
        if device == DEVICE:
            att_moved = {k: n for k, n in launches().items() if n}
        quat[device] = np.concatenate([sc.quaternion, sc.angular_velocity])
    check(att_moved == {"integrate_attitude": 1}, f"phase 10d: attitude "
          f"launched {att_moved}, not ATTITUDE once")
    dq = float(np.abs(quat[DEVICE] - quat["cpu"]).max())
    check(dq <= 1e-12, f"phase 10d: attitude card vs host {dq}")
    # ATTITUDE against its plain version on the card, then in turns
    args = [torch.as_tensor(x, device=DEVICE)
            for x in (q0, w0, inertia, np.zeros(3))]

    def att_kernel():
        return cuda_integrate.attitude(*args, 0.01, NUMERICAL_ATTITUDE_STEPS)

    def att_plain():
        return attitude_reference(*args, 0.01, NUMERICAL_ATTITUDE_STEPS)

    got, want = att_kernel(), att_plain()
    att_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"phase 10d: ATTITUDE differs from its plain version by {att_err}")
    att_turns = _integrate_turns(att_kernel, att_kernel, att_plain, 5,
                                 per_graph=2)
    f32, f64 = count_ops(lambda: attitude_reference(*args, 0.01, 100))
    att_bound = bound(nbytes(*args, *got), f32 * NUMERICAL_ATTITUDE_STEPS
                      / 100, f64 * NUMERICAL_ATTITUDE_STEPS / 100)
    clock = _max_sm_clock_hz()
    att_cycles = att_turns.device_ms * 1e-3 * clock / NUMERICAL_ATTITUDE_STEPS
    mean = {r: float(np.mean(ms[r])) for r in ms}
    print(f"# phase 10 [{smi}]: 10d: Spacecraft.from_tle(ISS).propagate "
          f"over 6 h at 30 s ({len(times)} samples) with a 0.1 km/s "
          f"prograde burn at 1 h and a 5 deg plane change at 3 h: card "
          f"through FIXED {mean['kernel']:.2f} ms "
          f"({', '.join(f'{x:.2f}' for x in ms['kernel'])}), card through "
          f"its plain version {mean['plain']:.1f} ms "
          f"({', '.join(f'{x:.1f}' for x in ms['plain'])}), host "
          f"{mean['cpu']:.1f} ms (host clock, in turns host, plain, kernel, "
          f"kernel, plain); launches {moved}; FIXED bit-equal to the plain "
          f"version; semi-major axis +{da:.1f} km, the plane turned "
          f"{turn:.3f} deg, inclination {di:+.3f} deg; card vs host max|dr| "
          f"{dr:.3e} km")
    print(f"# phase 10 [{smi}]: 10d: propagate_attitude, "
          f"{NUMERICAL_ATTITUDE_STEPS} RK4 steps: card {att_ms[DEVICE]:.2f} "
          f"ms, host {att_ms['cpu']:.1f} ms (host clock, one run each, "
          f"Spacecraft.propagate_attitude); launches {att_moved}; card vs "
          f"host max diff {dq:.1e}; ATTITUDE bit-equal to its plain version "
          f"on the card (max diff {att_err}); "
          f"{att_turns.text('integrate_attitude')}; {att_cycles:.1f} "
          f"cycles a step replayed at {clock / 1e9:.3f} GHz; bound "
          f"{att_bound[0]:.6f} ms ({att_bound[1]})")
    return (_integrate_entry("integrate_attitude",
                             att_moved["integrate_attitude"], att_err,
                             att_turns, att_bound),
            moved["integrate_fixed"])


#: the divide probe's random pairs: significands, signs and exponents
#: over +-DIVIDE_EXPONENTS
DIVIDE_PAIRS = 10 ** 7
DIVIDE_EXPONENTS = 60


def _divide_probe(smi):
    """The integrator kernel's divides through a reciprocal (TwoBody's,
    ATTITUDE's) and its reciprocals against ``__ddiv_rn`` on the card, bit
    for bit: DIVIDE_PAIRS random pairs, as many with a / b just below a
    power of two (where a RN(1/b) is furthest from a / b), and the edges
    (zeros, subnormals, inf, NaN, the window's bounds, quotients that
    under- or overflow). Returns the mismatches."""
    from astroz_tpu_torch.ops import cuda_integrate

    gen = torch.Generator(device=DEVICE).manual_seed(NUMERICAL_SEED)

    def randoms(n, e):
        m = 1.0 + torch.rand(n, generator=gen, device=DEVICE,
                             dtype=torch.float64)
        x = torch.ldexp(m, torch.randint(-e, e + 1, (n,), generator=gen,
                                         device=DEVICE))
        return x * (torch.randint(0, 2, (n,), generator=gen,
                                  device=DEVICE) * 2 - 1)

    b = 1.5 + 0.5 * torch.rand(DIVIDE_PAIRS, generator=gen, device=DEVICE,
                               dtype=torch.float64)
    d = torch.ldexp(torch.ones_like(b), torch.randint(
        -52, -7, (DIVIDE_PAIRS,), generator=gen, device=DEVICE))
    edges = torch.tensor([0.0, -0.0, 5e-324, -5e-324, 1e-310, 2.2e-308,
                          float("inf"), -float("inf"), float("nan"),
                          2.0 ** -400, 2.0 ** -401, 2.0 ** 400, 2.0 ** 401,
                          1e300, -1e300, 1e-300, 3.0, -7.5, 1.0],
                         dtype=torch.float64, device=DEVICE)
    ea, eb = torch.meshgrid(edges, edges, indexing="ij")
    sets = {"random": (randoms(DIVIDE_PAIRS, DIVIDE_EXPONENTS),
                       randoms(DIVIDE_PAIRS, DIVIDE_EXPONENTS)),
            "a/b just below a power of two": (b * (1.0 - d), b),
            "edges": (ea.reshape(-1), eb.reshape(-1))}
    miss = {}
    for name, (x, y) in sets.items():
        got, want, rcp, rcp_want = cuda_integrate.divide_probe(x, y)
        miss[name] = (int((got.view(torch.int64)
                           != want.view(torch.int64)).sum()),
                      int((rcp.view(torch.int64)
                           != rcp_want.view(torch.int64)).sum()), x.numel())
    check(all(m[0] == m[1] == 0 for m in miss.values()),
          f"phase 10d: the integrator kernel's divides differ from "
          f"__ddiv_rn: {miss}")
    print(f"# phase 10 [{smi}]: 10d: the divides through a reciprocal "
          f"(RN(1/b), two corrections) and the reciprocals against "
          f"__ddiv_rn, mismatches (quotients, reciprocals, pairs): "
          + "; ".join(f"{k} {v}" for k, v in miss.items()))
    return miss


def numerical_phase():
    """``python3 chip_smoke.py --numerical`` (needs a card): phase 10 in a
    fresh process, as phase 10 runs it: 10a-10d timed first, then one
    ``torch.profiler`` session for the device work a step, and the cost
    of one eager op on the card and on the host before and after that
    session. Prints the integrator kernel's kernels-line entries as JSON
    on a line of its own (``# phase 10 kernels: ...``)."""
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = card_line()
    ops = {"card": _op_us(DEVICE), "host": _op_us("cpu")}
    print(f"# phase 10 [{smi}]: a process of its own; host CPU "
          f"{host_cpu()}, {torch.get_num_threads()} torch threads; one "
          f"eager f64 op {ops['card']:.2f} us on the card, {ops['host']:.2f} "
          f"us on the host")
    fixed, step_ms = _phase10a_lanes(smi)
    adaptive, trajectory = _phase10b_dp87(smi)
    _phase10c_hohmann(smi)
    attitude, craft_launches = _phase10d_spacecraft(smi)
    fixed["launches"] += craft_launches  # the main path: 10a and 10d
    _divide_probe(smi)
    launch = _numerical_launches()
    check(launch["rk4_kernels"] == 1 and launch["dp87_step_kernels"] == 1
          and launch["trajectory_kernels"] == 1
          and launch["trajectory_reads"] == 1,
          f"phase 10: the profiler saw {launch}: not one kernel for "
          f"{LAUNCH_STEPS} RK4 steps, one for a DP8(7) outer step, and one "
          f"kernel and one read for a Propagator.propagate call")
    after = {"card": _op_us(DEVICE), "host": _op_us("cpu")}
    print(f"# phase 10 [{smi}]: device work (profiler, run last): "
          f"{LAUNCH_STEPS} RK4 steps of 10a {launch['rk4_kernels']} kernel, "
          f"{launch['rk4_activities']} activities with copies and fills "
          f"({step_ms * LAUNCH_STEPS * 1e3:.1f} us for them in 10a); a "
          f"DP8(7) outer step of 10b {launch['dp87_step_kernels']} kernel, "
          f"{launch['dp87_step_activities']} activities (the read of h and "
          f"the substeps); a Propagator.propagate of 10b over 1 h (60 outer "
          f"steps) {launch['trajectory_kernels']} kernel, "
          f"{launch['trajectory_reads']} read, "
          f"{launch['trajectory_activities']} activities; one eager op "
          f"after the profiler session {after['card']:.2f} us on the card, "
          f"{after['host']:.2f} us on the host")
    check("jax" not in sys.modules, "phase 10 loaded jax")
    print("# phase 10 kernels: " + json.dumps([fixed, adaptive, trajectory,
                                               attitude]))


def phase10_numerical():
    """Phase 10 (see the module docstring) in a child process: its device
    work is counted by ``torch.profiler``, and a second profiler session
    in one process lost kernel events (phase 4c holds the first); a
    fresh process also times the same whether phase 10 runs alone or
    after phases 1-9. Returns the integrator kernel's kernels-line
    entries."""
    child = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--numerical"], capture_output=True, text=True,
                           timeout=900)
    sys.stdout.write(child.stdout)
    check(child.returncode == 0, f"phase 10: {child.stderr[-2000:]}")
    tag = "# phase 10 kernels: "
    line = next(x for x in child.stdout.splitlines() if x.startswith(tag))
    return json.loads(line[len(tag):])


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
    near_cat = build_catalog(text, device=DEVICE)
    k1_err = phase2_kernel_vs_twin(near_cat)
    mixed_cat = build_catalog(mixed_text, device=DEVICE)
    deep_err = phase2b_deep_and_merge(mixed_cat)
    dense_err = phase2c_dense_vs_twin()
    spread_cat = build_catalog(mixed_catalog_text(
        N_SATS, epoch_spread_days=SPREAD_DAYS), device=DEVICE)
    f64_err = phase2d_f64_vs_plain(mixed_cat, spread_cat)
    fin_err = phase2e_epilogue_and_tables(near_cat, mixed_cat, spread_cat)
    con, k1_launches = phase3_main_path(text)
    mcon, mixed_launches = phase3b_mixed_path(mixed_text)
    dense_launches = phase3c_single_sat()
    scan_ms, scan_peak, scan_launches, f64_launches = phase3d_f64_path(mcon)
    k1 = phase4_timings(con, smi)
    k2, k3, f64_escape, tables = phase4b_mixed_timings(mcon, smi)
    fin32, fin64 = phase4d_epilogue_timings(con, mcon, smi)
    scon = Constellation(shell_text, device=DEVICE)
    k4_err, k4c_err, plain_pairs = phase5_coarse_vs_twin(scon)
    screen_launches = phase6_screen(scon, plain_pairs)
    phase6b_mixed_screen(mcon)
    k4, k4c = phase7_screen_timings(scon, smi)
    k5, k6, spine, f64_dense, f64_scan = phase4c_dense_timings(
        mcon, smi, scan_ms, scan_peak, spread_cat)
    phase8_api(con, mcon, text, mixed_text, smi)
    phase9_ingest(smi)
    rect = phase11_mesh(mcon, scon, smi)
    integrate = phase10_numerical()
    print(f"# chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(smi)

    def entry(name, source, replaces, n, err, times, library_ms=None):
        if isinstance(times[0], Turns):
            turns, (bound_ms, bound_by) = times
            ms, plain_ms, device_ms = (turns.ms, turns.plain_ms,
                                       turns.device_ms)
        else:  # K4: launched back to back only
            ms, plain_ms, (bound_ms, bound_by) = times[:3]
            device_ms = None
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms,
                "device_ms": device_ms}

    print(json.dumps({"kernels": [
        entry("sgp4_shallow (K1)", "astroz_tpu_torch/csrc/sgp4_shallow.cu",
              "astroz_tpu/ops/pallas_sgp4.py:286",
              k1_launches["sgp4_shallow"], k1_err[0],
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
        # a tile of the ring screen (phase 11), launched there
        entry("screen_candidates_rect (K4, rectangle mode)",
              "astroz_tpu_torch/csrc/screen_coarse.cu",
              "astroz_tpu/ops/pallas_screen.py:57", rect[0], rect[1],
              rect[2]),
        entry("sgp4_shallow_dense (K5)",
              "astroz_tpu_torch/csrc/sgp4_shallow.cu",
              "astroz_tpu/ops/pallas_sgp4.py:202",
              dense_launches["sgp4_shallow_dense"], dense_err[0], k5),
        entry("sgp4_shallow_grids (K6)",
              "astroz_tpu_torch/csrc/sgp4_shallow.cu",
              "astroz_tpu/ops/pallas_sgp4.py:66",
              dense_launches["sgp4_shallow_grids"], dense_err[0], k6),
        # the f64 spine that XLA fused around K6's Pallas call
        entry("sgp4_spine_grids (the f64 spine feeding K6)",
              "astroz_tpu_torch/csrc/sgp4_shallow.cu",
              "astroz_tpu/ops/pallas_sgp4.py:139",
              dense_launches["sgp4_spine_grids"], dense_err[2], spine),
        # not TPU kernels: the f64 XLA programs the JAX package jits around
        # its Pallas kernels; launches of the main path's f64 calls (phase
        # 3d: planes, time-major, scan_times) and mixed sweeps (phase 3b)
        entry("sgp4_f64_dense (the f64 kernel, DENSE: f64 propagate)",
              "astroz_tpu_torch/csrc/sgp4_f64.cu",
              "astroz_tpu/propagation.py:822",
              f64_launches["sgp4_f64_dense"], f64_err["dense"], f64_dense),
        entry("sgp4_f64_escape (the f64 kernel, ESCAPE: the HEO escape)",
              "astroz_tpu_torch/csrc/sgp4_f64.cu",
              "astroz_tpu/propagation.py:918",
              mixed_launches["sgp4_f64_escape"], f64_err["escape"],
              f64_escape),
        entry("sgp4_f64_scan (scan_times=True: the f64 kernel's DENSE "
              "launch on the jd and fr rows)",
              "astroz_tpu_torch/csrc/sgp4_f64.cu",
              "astroz_tpu/ops/sdp4.py:841", scan_launches, f64_err["scan"],
              f64_scan),
        # not TPU kernels: the epilogue XLA fuses into the jitted sweeps,
        # and the resonance tables' lax.scan; launches of the main path's
        # calls (phases 3 and 3b: the f32 epilogue for ECEF planes and
        # time-major, TABLES at the mixed catalog's first sweep; phase
        # 3d: the f64 epilogue for planes); timed (phase 4d) as the
        # default propagate's TEME time-major and the f64 TEME planes,
        # beside the one permute(...).contiguous() of r and v
        entry("finalize (f32) (the epilogue kernel: frames, layouts, mask)",
              "astroz_tpu_torch/csrc/finalize.cu",
              "astroz_tpu/propagation.py:773",
              k1_launches.get("finalize_f32", 0)
              + mixed_launches.get("finalize_f32", 0), fin_err["f32"],
              fin32[:2], fin32[2]),
        entry("finalize (f64) (the epilogue kernel on the f64 path)",
              "astroz_tpu_torch/csrc/finalize.cu",
              "astroz_tpu/propagation.py:752",
              f64_launches["finalize_f64"], fin_err["f64"], fin64[:2],
              fin64[2]),
        entry("resonance_tables (TABLES)",
              "astroz_tpu_torch/csrc/sgp4_deep.cu",
              "astroz_tpu/ops/fast.py:138",
              mixed_launches["resonance_tables"], fin_err["tables"], tables),
        # not TPU kernels: the XLA scan and while loop of the numerical
        # stack (phase 10, whose launches are its main path's: 10a and the
        # spacecraft of 10d, 10b's trajectory through step and through
        # Propagator.propagate, 10d's attitude)
        *integrate]}))
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
    elif sys.argv[1:2] == ["--numerical"]:
        numerical_phase()
    else:
        main()
