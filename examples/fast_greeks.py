"""Fast 7-parameter Heston greek vectors: two routes, one answer.

The mixing estimator's per-path value is closed-form in the variance-path
functionals (IV, J), which makes its full greek vector a FORWARD pass:

1. `jax.grad` through the seeded `solve` (reverse AD — the reference's
   ForwardDiff-through-re-solve pattern, works for every method),
2. `heston_mixing_price_and_greeks` (forward-mode fast path: tangents ride
   the variance scan, (spot, rho, rate) close analytically).

Both agree; route 2 costs a small multiple of the price alone.

Run: PYTHONPATH=. python examples/fast_greeks.py   (CPU ~20 s)
"""

import datetime as dt

import jax
import jax.numpy as jnp

import hedgehog_tpu as hh
from hedgehog_tpu.methods.mixing_greeks import GREEK_ORDER

REF, EXPIRY = dt.date(2024, 1, 1), dt.date(2025, 1, 1)
SPOT, STRIKE, R = 100.0, 100.0, 0.03
HESTON = dict(V0=0.04, kappa=2.0, theta=0.04, sigma=0.3, rho=-0.7)


def main():
    cfg = hh.SimulationConfig(
        trajectories=1 << 14, steps=12, variance_reduction=hh.Antithetic(), seed=0
    )
    method = hh.MonteCarlo(hh.HestonDynamics(), hh.HestonQE(conditional=True), cfg)
    payoff = hh.VanillaOption(STRIKE, EXPIRY, hh.European(), hh.Call(), hh.Spot())

    # route 1: reverse AD through solve
    def price(params):
        spot, v0, kappa, theta, sigma, rho, r = params
        market = hh.HestonInputs(REF, r, spot, v0, kappa, theta, sigma, rho)
        return hh.solve(hh.PricingProblem(payoff, market), method).price

    params = tuple(jnp.float64(x) for x in (SPOT, HESTON["V0"], HESTON["kappa"],
                                            HESTON["theta"], HESTON["sigma"],
                                            HESTON["rho"], R))
    p1, g1 = jax.value_and_grad(price)(params)

    # route 2: forward-mode fast path (one pass, price + 7 greeks)
    market = hh.HestonInputs(REF, R, SPOT, *HESTON.values())
    p2, g2 = hh.heston_mixing_price_and_greeks(
        hh.PricingProblem(payoff, market), method
    )

    print(f"price: reverse={float(p1):.6f}  forward={float(p2):.6f}")
    print(f"{'greek':8s} {'reverse AD':>14s} {'forward mode':>14s}")
    for k, g in zip(GREEK_ORDER, g1):
        print(f"{k:8s} {float(g):+14.6f} {float(g2[k]):+14.6f}")
    rel = max(abs(float(g2[k]) - float(g)) / (abs(float(g)) + 1e-12)
              for k, g in zip(GREEK_ORDER, g1))
    print(f"max rel diff: {rel:.2e}")
    assert rel < 1e-9


if __name__ == "__main__":
    main()
