"""Monte Carlo benchmark harness, mirroring reference
examples/montecarlo_benchmark.jl: exact-BS MC price (5k paths) and LSM
American put (10k paths × 100 steps, degree 5, antithetic) wall times —
plus accelerator-sized variants (QMC, 100× the path counts).
"""

import datetime as dt

import jax

import hedgehog_tpu as hh
from hedgehog_tpu.utils.profiling import time_fn

REF, EXPIRY = dt.date(2024, 1, 1), dt.date(2025, 1, 1)


def main():
    market = hh.BlackScholesInputs(REF, 0.05, 100.0, 0.2)
    euro = hh.PricingProblem(
        hh.VanillaOption(100.0, EXPIRY, hh.European(), hh.Call(), hh.Spot()), market
    )
    amer = hh.PricingProblem(
        hh.VanillaOption(100.0, EXPIRY, hh.American(), hh.Put(), hh.Spot()), market
    )

    # reference harness 1: exact-BS MC, 5,000 paths (montecarlo_benchmark.jl:25-31)
    m1 = hh.MonteCarlo(
        hh.LognormalDynamics(), hh.BlackScholesExact(), hh.SimulationConfig(5_000, seed=0)
    )
    f1 = jax.jit(lambda p: hh.solve(p, m1).price)
    t1 = time_fn(f1, euro)
    print(f"exact-BS MC 5k paths:         {float(f1(euro)):8.4f}  ({t1*1e6:8.1f} µs)")

    # accelerator-sized variant: 500k QMC paths
    m1b = hh.MonteCarlo(
        hh.LognormalDynamics(), hh.BlackScholesExact(),
        hh.SimulationConfig(500_000, seed=0, qmc=True),
    )
    f1b = jax.jit(lambda p: hh.solve(p, m1b).price)
    t1b = time_fn(f1b, euro)
    print(f"exact-BS QMC 500k paths:      {float(f1b(euro)):8.4f}  ({t1b*1e6:8.1f} µs)")

    # reference harness 2: LSM American put, 10k paths × 100 steps, degree 5,
    # antithetic (montecarlo_benchmark.jl:52-67)
    lsm = hh.LSM(
        hh.MonteCarlo(
            hh.LognormalDynamics(), hh.BlackScholesExact(),
            hh.SimulationConfig(10_000, steps=100, seed=0, variance_reduction=hh.Antithetic()),
        ),
        5,
    )
    f2 = jax.jit(lambda p: hh.solve(p, lsm).price)
    t2 = time_fn(f2, amer, reps=5)
    print(f"LSM 10k×100 deg5 antithetic:  {float(f2(amer)):8.4f}  ({t2*1e3:8.1f} ms)")


if __name__ == "__main__":
    main()
