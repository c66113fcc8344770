"""Monte-Carlo dispersion of a transfer (reference: MonteCarlo.zig demo;
the PyTorch port of examples/monte_carlo.py: the samples are drawn and
reduced in one batch of device ops).

Run: ``python examples_torch/monte_carlo.py`` (on the card).
"""

from astroz_tpu_torch.montecarlo import (MonteCarloConfig,
                                         run_hohmann_monte_carlo)


def main(device="cuda", small=False):
    cfg = MonteCarloConfig(n_samples=500 if small else 5000,
                           r1_sigma_km=10.0, r2_sigma_km=50.0)
    res = run_hohmann_monte_carlo(cfg, device=device)
    for name, s in res.items():
        print(f"{name:15s} mean={s.mean:10.4f}  std={s.std:8.5f}  "
              f"95% CI [{s.ci95_low:.4f}, {s.ci95_high:.4f}]")


if __name__ == "__main__":
    main()
