"""Exact-transition segmented mixing — the price flagship.

`HestonExactMixing` removes the time-discretization bias of the conditional
(Romano-Touzi) estimator: per segment it draws the EXACT noncentral-χ² CIR
transition and the conditional ∫V | endpoints from its Broadie-Kaya
Laplace-transform moments, then closes with the conditional Black-Scholes
formula.  TWO segments suffice for sub-bp bias on the whole stress grid
(docs/adr/adr-008-conditional-mc.md addendum 2).

Shows on one market:
1. price agreement with Carr-Madan at 2 segments (vs 11 QE mixing steps),
2. QMC composability (the estimator takes a Sobol' stream),
3. unbiased 7-param greeks via the likelihood-ratio estimator — baked into
   the per-path values, so `jax.grad` through the solve just works (the raw
   pathwise gradient, shown for contrast, would be badly biased).

Run: python examples/exact_mixing_flagship.py
"""

import datetime as dt

import jax
import jax.numpy as jnp

import hedgehog_tpu as hh
from hedgehog_tpu.methods.mixing_greeks import (
    GREEK_ORDER,
    heston_exact_price_and_greeks,
)

REF = dt.date(2024, 1, 1)
EXPIRY = dt.date(2025, 1, 1)
MARKET = hh.HestonInputs(REF, 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
PAYOFF = hh.VanillaOption(100.0, EXPIRY, hh.European(), hh.Call(), hh.Spot())
PROB = hh.PricingProblem(PAYOFF, MARKET)

CM = float(hh.solve(PROB, hh.CarrMadan(1.0, "auto", hh.HestonDynamics())).price)
print(f"Carr-Madan reference price: {CM:.6f}\n")

# ---- 1. price: 2 exact segments vs 11 QE mixing steps --------------------
cfg = hh.SimulationConfig(
    trajectories=1 << 17, steps=2, variance_reduction=hh.Antithetic(),
    seed=7, qmc=True,
)
exact = hh.MonteCarlo(hh.HestonDynamics(), hh.HestonExactMixing(), cfg)
p_exact = float(hh.solve(PROB, exact).price)

cfg_qe = hh.SimulationConfig(
    trajectories=1 << 17, steps=11, variance_reduction=hh.Antithetic(),
    seed=7, qmc=True,
)
qe_mix = hh.MonteCarlo(hh.HestonDynamics(), hh.HestonQE(conditional=True), cfg_qe)
p_qe = float(hh.solve(PROB, qe_mix).price)
print(f"exact mixing, 2 segments : {p_exact:.6f}  ({(p_exact-CM)/CM*1e4:+.2f}bp)")
print(f"QE mixing,    11 steps   : {p_qe:.6f}  ({(p_qe-CM)/CM*1e4:+.2f}bp)")
print("(2 segments × 4 draws beats 11 steps × 2 draws on bias AND work)\n")

# ---- 2. unbiased greeks (likelihood ratio) -------------------------------
price, greeks = heston_exact_price_and_greeks(PROB, exact)
print("7-param greek vector (pathwise + Poisson likelihood-ratio term):")
for k in GREEK_ORDER:
    print(f"  {k:6s} {float(greeks[k]):+10.5f}")

# jax.grad straight through solve ALSO works (the per-path values carry the
# likelihood-ratio surrogate) — here is what the raw pathwise gradient
# (score term dropped) would have given instead
from hedgehog_tpu.methods.montecarlo import _heston_exact_mixing_values

def mc_sigma_price(sigma):
    m = hh.HestonInputs(REF, 0.03, 100.0, 0.04, 2.0, 0.04, sigma, -0.7)
    return hh.solve(hh.PricingProblem(PAYOFF, m), exact).price

def raw_pathwise_sigma_price(sigma):
    m = hh.HestonInputs(REF, 0.03, 100.0, 0.04, 2.0, 0.04, sigma, -0.7)
    vals, _ = _heston_exact_mixing_values(
        hh.PricingProblem(PAYOFF, m), cfg, None, with_score=True
    )
    T = hh.yearfrac(REF, EXPIRY)
    return jnp.exp(-0.03 * T) * jnp.mean(vals)

def cm_sigma_price(sigma):
    m = hh.HestonInputs(REF, 0.03, 100.0, 0.04, 2.0, 0.04, sigma, -0.7)
    return hh.solve(hh.PricingProblem(PAYOFF, m), hh.CarrMadan(1.0, "auto", hh.HestonDynamics())).price

g_solve = float(jax.grad(mc_sigma_price)(jnp.float64(0.3)))
g_raw = float(jax.grad(raw_pathwise_sigma_price)(jnp.float64(0.3)))
g_cm = float(jax.grad(cm_sigma_price)(jnp.float64(0.3)))
print(f"\nsigma-greek: Carr-Madan {g_cm:+.4f} | jax.grad through solve "
      f"{g_solve:+.4f} | raw pathwise {g_raw:+.4f}  <- biased without the score")
