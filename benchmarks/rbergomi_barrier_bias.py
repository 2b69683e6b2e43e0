#!/usr/bin/env python
"""Measure the rough-Bergomi bridge-barrier bias exponent by PAIRED refinement.

ADVICE r4 flagged that the Heston-measured Richardson weight (α = 0.75,
montecarlo._RICH_ALPHA) was applied to rBergomi barrier grids unvalidated;
round 5 gated the extrapolation to HestonDynamics.  This study measures the
actual refinement behavior of the plain bridge estimator on rBergomi with
the SAME estimator-pair construction the Heston α came from: the simulated
grid is re-bridged at every 2nd node (montecarlo._coarse_bridge_inputs), and
the per-path paired difference

    D(N) = E[value_fine(N) − value_coarse(N/2 view)]  ≈  C·(2^α − 1)·N^(−α)

has tiny variance (common paths), so α = log2(D(N)/D(2N)) resolves with
moderate path counts.  If α is stable across N/seeds/Hurst, a validated
rBergomi weight 2^α/(2^α − 1) can be shipped; if not, the Heston gate stays
and this file is the evidence.

Usage: python -u benchmarks/rbergomi_barrier_bias.py [hurst=0.1] [N ...]

RECORDED RESULTS (H=0.1, η=1.5, ρ=−0.7, ξ₀=0.04, down-and-out call
K=100 H=85, 2^16 QMC pairs × 2 seeds/rung):

    N=16   p_fine=8.05113   D(N)=−886.96±2.72 e-4
    N=32   p_fine=8.08428   D(N)=−636.24±20.65 e-4
    N=64   p_fine=8.11295   D(N)=−478.13±6.32 e-4
    N=128  p_fine=8.12566   D(N)=−343.94±2.16 e-4

D-ladder exponents: α(16→32)=0.48, α(32→64)=0.41, α(64→128)=0.48 — the
bridge-resolution component alone looks ~√Δt-ish (clearly NOT Heston's
0.75).  BUT the plain price ladder RISES with refinement (total bias is
dominated by the opposite-signed Euler/simulation component), and applying
the α=0.5 weight w=3.41 produces an extrapolated ladder
(7.837, 7.931, 7.998, 8.043) whose refinement steps are LARGER than the
plain ladder's (last step 55 bp vs 16 bp) — the bridge and Euler biases
interfere, so single-weight Richardson on the bridge pair OVERSHOOTS and
degrades convergence.  Conclusion: the round-5 gate
(montecarlo._richardson_applies — HestonDynamics only, plain bridge for
rBergomi) is the measured right call; an rBergomi correction would need a
joint (Euler, bridge) two-exponent model, out of scope.
"""

import datetime as dt
import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import hedgehog_tpu as hh  # noqa: E402
from hedgehog_tpu.methods.montecarlo import (  # noqa: E402
    MonteCarlo,
    _barrier_path_values,
    _bridge_log_grid,
    _coarse_bridge_inputs,
    _sim_params,
    brownian_bridge_survival_factors,
)
from hedgehog_tpu.market.rate_curve import df  # noqa: E402

REF = dt.date(2024, 1, 1)
EXPIRY = dt.date(2024, 12, 31)
K, H_BAR = 100.0, 85.0
LADDER = (16, 32, 64, 128)
SEEDS = (0, 1)
PAIRS = 1 << 16


def paired_values(market, steps: int, seed: int):
    """(mean_fine, mean_coarse) per-path barrier values on ONE grid."""
    cfg = hh.SimulationConfig(
        trajectories=PAIRS, steps=steps,
        variance_reduction=hh.Antithetic(), seed=seed, qmc=True,
    )
    m = MonteCarlo(hh.RoughBergomiDynamics(), hh.EulerMaruyama(), cfg)
    ko = hh.BarrierOption(K, EXPIRY, H_BAR, direction=hh.Down(),
                          knock=hh.KnockOut())
    prob = hh.PricingProblem(ko, market)
    _, T, _ = _sim_params(prob)
    discount = df(market.rate, ko.expiry)

    @jax.jit
    def run():
        spot_grid, seg_vars, _ = _bridge_log_grid(prob, m, "barrier")
        log_grid = jnp.log(spot_grid)
        log_b = jnp.log(ko.barrier)
        t_mids = (jnp.arange(steps) + 0.5) * (T / steps)
        f_fine = brownian_bridge_survival_factors(log_grid, seg_vars, log_b, False)
        pay = ko(spot_grid[-1])
        v_fine = _barrier_path_values(pay, f_fine, t_mids, ko, market, discount)
        lg2, sv2, tm2 = _coarse_bridge_inputs(log_grid, seg_vars, T, steps)
        f_coarse = brownian_bridge_survival_factors(lg2, sv2, log_b, False)
        v_coarse = _barrier_path_values(pay, f_coarse, tm2, ko, market, discount)
        return (discount * jnp.mean(v_fine, axis=(0, -1)),
                discount * jnp.mean(v_coarse, axis=(0, -1)))

    pf, pc = run()
    return float(pf), float(pc)


def main():
    hurst = float(sys.argv[1]) if len(sys.argv) > 1 else 0.1
    ladder = (
        tuple(int(a) for a in sys.argv[2:]) if len(sys.argv) > 2 else LADDER
    )
    market = hh.RoughBergomiInputs(REF, 0.03, 100.0, 0.04, 1.5, hurst, -0.7)
    diffs = {}
    for n in ladder:
        t0 = time.perf_counter()
        ds, pfs = [], []
        for s in SEEDS:
            pf, pc = paired_values(market, n, s)
            ds.append(pf - pc)
            pfs.append(pf)
        d = float(np.mean(ds))
        se = float(np.std(ds) / np.sqrt(len(ds)))
        diffs[n] = d
        print(f"H={hurst} N={n:4d}  p_fine={np.mean(pfs):.5f}  "
              f"D(N)=p_fine−p_coarse={d*1e4:+.2f}±{se*1e4:.2f}e-4  "
              f"({time.perf_counter()-t0:.1f}s)", flush=True)
    for n in ladder[1:]:
        if diffs[n] != 0.0 and diffs[n // 2] / diffs[n] > 0.0:
            alpha = float(np.log2(diffs[n // 2] / diffs[n]))
            w = 2.0 ** alpha / (2.0 ** alpha - 1.0) if alpha > 0 else float("nan")
            print(f"H={hurst}  alpha from D({n//2})/D({n}) = {alpha:+.3f} "
                  f"(weight {w:.2f}); Heston ships 0.75 (weight 2.47)",
                  flush=True)
        else:
            print(f"H={hurst}  D({n//2})/D({n}) sign flip — no power law at "
                  f"this noise level", flush=True)


if __name__ == "__main__":
    main()
