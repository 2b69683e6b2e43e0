"""Experiment: OU-bridge conditional-mean ∫V weights vs trapezoid (round-3
VERDICT item 6 — sub-bp mixing bias at ≤8 steps).

The mixing estimator's bias is the V-path discretization of IV = ∫V dt
(trapezoid, ≈430/n² bp on the bench market).  Matching the UNCONDITIONAL
start-mean (γ-matching) made it worse (ADR-008 dead end); here we try the
BRIDGE conditional mean: for an OU process with mean-reversion κ the bridge
mean given both endpoints integrates in closed form,

    E[∫₀^Δ V | V₀=x, V_Δ=y] = (x+y)·tk + θ·(Δ − 2·tk),  tk = tanh(κΔ/2)/κ,

i.e. symmetric endpoint shrinkage + a θ pull — the drift effect exactly
(the CIR's √v diffusion perturbs this at higher order).  The J identity
J = (ΔV − κθΔ + κ·IV)/σ consumes the same IV estimate, so one change
corrects both channels.

Usage: python benchmarks/qe_bridge_bias.py [steps ...]  (CPU or GPU)
"""

import datetime as dt
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import hedgehog_tpu as hh
from hedgehog_tpu.models.heston_qe import qe_constants, qe_v_step

REF = dt.date(2024, 1, 1)
EXPIRY = dt.date(2025, 1, 1)
R, SPOT, STRIKE = 0.03, 100.0, 100.0
H = dict(V0=0.04, kappa=2.0, theta=0.04, sigma=0.3, rho=-0.7)


def mixing_price(weighting: str, steps: int, n_pairs: int, seed: int):
    """ATM call price via the mixing estimator with the chosen ∫V weights."""
    T = float(hh.yearfrac(REF, hh.to_ticks(EXPIRY)))
    dtau = T / steps
    kappa, theta, sigma, rho, v0 = (H["kappa"], H["theta"], H["sigma"], H["rho"], H["V0"])
    c = qe_constants(kappa, theta, sigma, rho, R, dtau)
    if weighting == "trapezoid":
        w1, w0 = 0.5 * dtau, 0.0
    elif weighting == "bridge":
        tk = float(np.tanh(kappa * dtau / 2.0) / kappa)
        w1, w0 = tk, theta * (dtau - 2.0 * tk)
    else:
        raise ValueError(weighting)

    from hedgehog_tpu.methods.montecarlo import _qmc_normals_and_uniforms

    key = jax.random.PRNGKey(seed)
    zb, ub = _qmc_normals_and_uniforms(key, steps, 1, n_pairs)
    zb = zb[:, 0, :]
    z = jnp.stack([zb, -zb])
    us = jnp.stack([ub, 1.0 - ub])
    ktd = kappa * theta * dtau

    v = jnp.full((2, n_pairs), v0)
    iv = jnp.zeros_like(v)
    j = jnp.zeros_like(v)

    def step(carry, inp):
        v, iv, j = carry
        zk, uk = inp
        vn = qe_v_step(v, zk, uk, c)
        iv_step = w1 * (v + vn) + w0
        jn = j + (vn - v - ktd + kappa * iv_step) / sigma
        return (vn, iv + iv_step, jn), None

    (v, iv, j), _ = jax.lax.scan(
        step, (v, iv, j), (jnp.moveaxis(z, 1, 0), jnp.moveaxis(us, 1, 0))
    )
    f_eff = SPOT * jnp.exp(R * T + rho * j - 0.5 * rho**2 * iv)
    var = jnp.maximum((1.0 - rho**2) * iv, 1e-18)
    sd = jnp.sqrt(var)
    d1 = (jnp.log(f_eff / STRIKE) + 0.5 * var) / sd
    ncdf = jax.scipy.stats.norm.cdf
    vals = f_eff * ncdf(d1) - STRIKE * ncdf(d1 - sd)
    return float(jnp.exp(-R * T) * jnp.mean(vals))


def main():
    market = hh.HestonInputs(REF, R, SPOT, *H.values())
    payoff = hh.VanillaOption(STRIKE, EXPIRY, hh.European(), hh.Call(), hh.Spot())
    with jax.default_device(jax.devices("cpu")[0]):
        cm = float(hh.solve(hh.PricingProblem(payoff, market),
                            hh.CarrMadan(1.0, "auto", hh.HestonDynamics())).price)
    print(f"Carr-Madan oracle: {cm:.6f}")
    steps_list = [int(s) for s in sys.argv[1:]] or [6, 8, 11, 16]
    n_pairs, n_rand = 1 << 20, 4
    run = jax.jit(mixing_price, static_argnames=("weighting", "steps", "n_pairs"))
    for steps in steps_list:
        for wtg in ("trapezoid", "bridge"):
            ps = [mixing_price(wtg, steps, n_pairs, s) for s in range(n_rand)]
            mean, se = float(np.mean(ps)), float(np.std(ps) / np.sqrt(n_rand))
            print(f"steps={steps:3d} {wtg:9s} bias={(mean-cm)/cm*1e4:+7.2f}bp "
                  f"(se {se/cm*1e4:.2f}bp)")


if __name__ == "__main__":
    main()
