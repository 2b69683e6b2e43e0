"""A structured-products desk day: autocallable issue, vol hedge, dividend book.

Three workflows that go beyond the reference's vanilla scope but reuse its
problem/method architecture unchanged (`solve(PricingProblem(payoff, market),
method)` everywhere — reference parity: src/Hedgehog.jl solve stack):

1. Issue a phoenix-memory autocallable on a Heston underlier, priced on the
   conditional (Romano-Touzi) mixing grid — the V-path-only simulation that
   backs the Monte Carlo flagship — and risk it with plain `jax.grad` (the bridge
   knock-in leg is smooth, so vega flows pathwise).
2. Hedge the vol exposure with a VIX call on the SAME Heston market —
   `VIXAnalytic` prices the 30-day forward variance-swap root by
   survival-form quadrature over the exact CIR transition, AD end-to-end.
3. Mark the American-put dividend book: discrete CASH dividends under BOTH
   market conventions — the spot model (the PDE grid drops the spot by the
   cash amount at each ex-date) and Hull's escrowed model (the CRR lattice
   rides a PV-shifted spot).  The few-percent gap between them is a real
   modelling choice desks argue about, not numerical error
   (tests/unit/test_discrete_dividends.py pins both engines separately).

Run: PYTHONPATH=. python examples/structured_desk.py   (CPU, ~1 min)
"""

import datetime as dt

import jax
import numpy as np

jax.config.update("jax_enable_x64", True)

import hedgehog_tpu as hh  # noqa: E402

REF = dt.date(2025, 1, 1)
EXPIRY = dt.date(2027, 1, 1)
R, S0 = 0.03, 100.0

# ---------------------------------------------------------------- 1. issue
print("=== phoenix autocallable on the Heston conditional grid ===")
heston = hh.HestonInputs(REF, R, S0, V0=0.04, kappa=2.0, theta=0.05,
                         sigma=0.6, rho=-0.7)
note = hh.Autocallable(
    EXPIRY, periods=8, autocall_barrier=1.0, coupon=0.02,
    knock_in_barrier=0.7, coupon_barrier=0.8,  # phoenix-memory convention
)
mc = hh.MonteCarlo(
    hh.HestonDynamics(), hh.HestonQE(conditional=True),
    hh.SimulationConfig(trajectories=2**15, steps=64,
                        variance_reduction=hh.Antithetic(), seed=7),
)
prob = hh.PricingProblem(note, heston)
price = hh.solve(prob, mc).price
print(f"issue price (per 1.0 notional): {float(price):.5f}")


def reprice(v0, sigma_v):
    m = hh.FieldLens("market_inputs.V0").set(prob, v0)
    m = hh.FieldLens("market_inputs.sigma").set(m, sigma_v)
    return hh.solve(m, mc).price


# the bridge KI and smooth conditional close keep the whole note AD-able:
dV0, dsig = jax.grad(reprice, argnums=(0, 1))(0.04, 0.6)
print(f"dPrice/dV0 = {float(dV0):+.4f}   dPrice/dsigma_v = {float(dsig):+.4f}")

# ---------------------------------------------------------------- 2. hedge
print("\n=== VIX call overlay on the same market ===")
vix_exp = dt.date(2025, 7, 1)
fut = hh.solve(hh.PricingProblem(hh.VIXFuture(vix_exp), heston),
               hh.VIXAnalytic()).price
print(f"VIX future ({vix_exp}): {float(fut):.3f}")
for K in (18.0, 22.0, 26.0):
    c = hh.solve(hh.PricingProblem(hh.VIXOption(K, vix_exp), heston),
                 hh.VIXAnalytic()).price
    print(f"  VIX call K={K:.0f}: {float(c):.4f}")

# vega of the overlay in the SAME parameters as the note's risk above:
vix_vega = jax.grad(
    lambda sv: hh.solve(
        hh.PricingProblem(hh.VIXOption(22.0, vix_exp),
                          hh.FieldLens("sigma").set(heston, sv)),
        hh.VIXAnalytic(),
    ).price
)(0.6)
print(f"VIX call dPrice/dsigma_v = {float(vix_vega):+.4f} "
      "(hedges the book's vol-of-vol exposure)")

# ---------------------------------------------------------------- 3. book
print("\n=== American put, discrete cash dividends: two conventions ===")
divs = hh.DividendSchedule([dt.date(2025, 7, 1), dt.date(2026, 7, 1)],
                           [2.5, 2.5])
bs_div = hh.BlackScholesInputs(REF, R, S0, 0.25, dividends=divs)
put = hh.VanillaOption(100.0, EXPIRY, hh.American(), hh.Put(), hh.Spot())
p_pde = hh.solve(hh.PricingProblem(put, bs_div),
                 hh.PDEMethod(space_steps=300, time_steps=120)).price
p_crr = hh.solve(hh.PricingProblem(put, bs_div),
                 hh.CoxRossRubinsteinMethod(800)).price
print(f"spot model (PDE, cash drop at ex-date): {float(p_pde):.4f}")
print(f"escrowed (CRR on the PV-shifted spot):  {float(p_crr):.4f}")
print(f"convention gap: {abs(float(p_pde) - float(p_crr)) / float(p_crr) * 1e4:.0f} bp"
      " — a modelling choice, not numerical error")
