"""On-chip serving throughput of the GRID engines: 1-D PDE, 2-D ADI, CRR,
batched Carr-Madan (options/s, fp32 where safe).

The MC kernels carry the headline; this script records the serving story for
the deterministic engines, which the BENCH artifacts never measured before
round 4.  All four engines run in fp32 via ``jax.enable_x64(False)`` — the
grid math is branchless tridiagonal/scan work whose fp32-vs-fp64 drift is
~1e-4 relative (well inside a 5 bp serving budget; measured and printed).

Batching model: one jit'd ``vmap`` over a strike grid = one dispatch pricing
the whole book slice (instrument parallelism, SURVEY.md §2c).
"""
import datetime as dt
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import warnings

import jax
import jax.numpy as jnp

import hedgehog_tpu as hh

# fp32 mode truncates the engines' internal float64 dtype requests by design
warnings.filterwarnings("ignore", message=".*requested in asarray is not available.*")

REF = dt.date(2024, 1, 1)
EXPIRY = dt.date(2025, 1, 1)
R, SPOT = 0.03, 100.0
HESTON = dict(V0=0.04, kappa=2.0, theta=0.04, sigma=0.3, rho=-0.7)

bs_mkt = hh.BlackScholesInputs(REF, R, SPOT, 0.2)
h_mkt = hh.HestonInputs(REF, R, SPOT, *HESTON.values())


def _opt(k):
    return hh.VanillaOption(k, EXPIRY, hh.European(), hh.Call(), hh.Spot())


def _am(k):
    return hh.VanillaOption(k, EXPIRY, hh.American(), hh.Put(), hh.Spot())


def bench_engine(name, fn, strikes, reps=5):
    """Time jit(vmap(fn)) over ``strikes``; report options/s and fp32 error."""
    fn_v = jax.jit(jax.vmap(fn))
    with jax.enable_x64(False):
        out32 = fn_v(jnp.asarray(strikes, jnp.float32))
        jax.block_until_ready(out32)
        t0 = time.perf_counter()
        for _ in range(reps):
            out32 = fn_v(jnp.asarray(strikes, jnp.float32))
            jax.block_until_ready(out32)
        dt_s = (time.perf_counter() - t0) / reps
    # fp64 reference on the first few strikes (CPU ok) for the error line
    ref = jax.jit(jax.vmap(fn))(jnp.asarray(strikes[:4], jnp.float64))
    rel = float(jnp.max(jnp.abs(jnp.asarray(out32[:4], jnp.float64) - ref) / ref))
    ops = len(strikes) / dt_s
    print(
        f"{name}: {len(strikes)} options in {dt_s*1e3:.1f} ms = {ops:.3e} options/s "
        f"(fp32; max rel err vs fp64 {rel:.1e})"
    )
    return ops


def main():
    print(f"backend={jax.default_backend()}")
    ks_wide = jnp.linspace(60.0, 140.0, 256)
    ks_mid = jnp.linspace(60.0, 140.0, 64)
    ks_small = jnp.linspace(80.0, 120.0, 8)

    # 1-D PDE: American put book (the engine's reason to exist)
    pde1 = hh.PDEMethod(space_steps=256, time_steps=128)
    bench_engine(
        "PDE-1D BS American put (256x128)",
        lambda k: hh.solve(hh.PricingProblem(_am(k), bs_mkt), pde1).price,
        ks_mid,
    )

    # CRR binomial, 1024 steps, American put
    crr = hh.CoxRossRubinsteinMethod(1024)
    bench_engine(
        "CRR-1024 BS American put",
        lambda k: hh.solve(hh.PricingProblem(_am(k), bs_mkt), crr).price,
        ks_wide,
    )

    # Batched Carr-Madan on the Heston CF (European call book)
    cm = hh.CarrMadan(1.0, 32.0, hh.HestonDynamics())
    bench_engine(
        "Carr-Madan Heston European call",
        lambda k: hh.solve(hh.PricingProblem(_opt(k), h_mkt), cm).price,
        ks_wide,
    )

    # 2-D ADI Heston American put (the heavyweight)
    adi = hh.PDEMethod(hh.HestonDynamics(), space_steps=128, time_steps=64,
                       var_steps=48)
    bench_engine(
        "ADI-2D Heston American put (128x48x64)",
        lambda k: hh.solve(hh.PricingProblem(_am(k), h_mkt), adi).price,
        ks_small,
    )


if __name__ == "__main__":
    main()
