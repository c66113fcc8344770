"""Monte-Carlo transfer analysis, batched over the sample axis.

Counterpart of ``astroz_tpu/montecarlo.py``: gaussian perturbations of
(r1, r2, mu) with a 0.5x safety floor, every sample's Hohmann transfer
in one batch of device ops, statistics with a 95% confidence interval,
and CSV export. The samples come from a ``torch.Generator`` on the
device, seeded from ``config.seed``; its streams are not those of
``jax.random``, so the two packages agree in their statistics, not in
their samples.
"""

from __future__ import annotations

import csv
import math
from dataclasses import dataclass
from typing import Dict

import torch

from .calculations import hohmann_transfer
from .config import DEFAULT_DTYPE
from .constants import EARTH
from .ops.sgp4 import _device

__all__ = ["MonteCarloConfig", "StatisticalSummary", "export_csv",
           "run_hohmann_monte_carlo"]


@dataclass
class MonteCarloConfig:
    """Nominal transfer radii and gravitational parameter, their
    gaussian sigmas, the sample count and the generator's seed."""

    n_samples: int = 1000
    seed: int = 42
    r1_km: float = EARTH.eq_radius + 400.0
    r2_km: float = 42164.0
    mu: float = EARTH.mu
    r1_sigma_km: float = 10.0
    r2_sigma_km: float = 50.0
    mu_sigma: float = 0.0


@dataclass
class StatisticalSummary:
    """Sample statistics of one metric with its 95% confidence
    interval of the mean; ``n_failed`` samples were dropped."""

    mean: float
    std: float
    minimum: float
    maximum: float
    ci95_low: float
    ci95_high: float
    n: int
    n_failed: int


def _summary(x: torch.Tensor, n_failed: int) -> StatisticalSummary:
    """Statistics of the 1-D samples ``x``, computed on their device and
    read back once."""
    n = int(x.numel())
    spread = x.std() if n > 1 else x.new_zeros(())
    mean, std, lo, hi = torch.stack(
        [x.mean(), spread, x.min(), x.max()]).tolist()
    half = 1.959963984540054 * std / math.sqrt(max(n, 1))
    return StatisticalSummary(
        mean=mean, std=std, minimum=lo, maximum=hi, ci95_low=mean - half,
        ci95_high=mean + half, n=n, n_failed=n_failed)


def run_hohmann_monte_carlo(config: MonteCarloConfig, *, device="cuda"
                            ) -> Dict[str, StatisticalSummary]:
    """Perturb (r1, r2, mu) with gaussian noise (no sample below half
    its nominal), evaluate every sample's transfer in one batch on
    ``device``, and summarize the dv/time statistics."""
    device = _device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(config.seed)
    n = config.n_samples

    def normal():
        return torch.randn(n, generator=gen, dtype=DEFAULT_DTYPE,
                           device=device)

    r1 = config.r1_km + config.r1_sigma_km * normal()
    r2 = config.r2_km + config.r2_sigma_km * normal()
    mu = config.mu + config.mu_sigma * normal()
    # safety floor: no sample below half the nominal
    r1 = torch.clamp(r1, min=0.5 * config.r1_km)
    r2 = torch.clamp(r2, min=0.5 * config.r2_km)
    mu = torch.clamp(mu, min=0.5 * config.mu)

    dv1, dv2, total, tof = hohmann_transfer(r1, r2, mu)
    # failure = degenerate transfer (radii crossed to within 1 km)
    ok = torch.abs(r2 - r1) > 1.0
    n_failed = int((~ok).sum())

    out = {}
    for name, arr in (("delta_v1", dv1), ("delta_v2", dv2),
                      ("total_delta_v", total), ("transfer_time", tof)):
        out[name] = _summary(arr[ok], n_failed)
    return out


def export_csv(results: Dict[str, StatisticalSummary],
               path: str) -> None:
    """Write the summaries as CSV, one metric a row."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["metric", "mean", "std", "min", "max", "ci95_low",
                    "ci95_high", "n", "n_failed"])
        for name, s in results.items():
            w.writerow([name, s.mean, s.std, s.minimum, s.maximum,
                        s.ci95_low, s.ci95_high, s.n, s.n_failed])
