"""Experiment: forward- vs reverse-mode 7-param greek vector on the
conditional (Romano-Touzi mixing) estimator — VERDICT r2 item 2.

The mixing payoff is closed-form in (IV, J); the variance scan is the only
AD-carried part.  Hypothesis: forward mode (7 tangents pushed through the
scan, no remat/backward pass) beats reverse mode on ratio-to-price.

Run from the repo root:  python benchmarks/greek_mode_experiment.py
"""

import datetime as dt
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

import hedgehog_tpu as hh

REF = dt.date(2024, 1, 1)
EXPIRY = dt.date(2025, 1, 1)
R, SPOT, STRIKE = 0.03, 100.0, 100.0
HESTON = dict(V0=0.04, kappa=2.0, theta=0.04, sigma=0.3, rho=-0.7)


def build_price(n_pairs, steps):
    cfg = hh.SimulationConfig(
        trajectories=n_pairs, steps=steps, variance_reduction=hh.Antithetic(), seed=0
    )
    method = hh.MonteCarlo(hh.HestonDynamics(), hh.HestonQE(conditional=True), cfg)
    payoff = hh.VanillaOption(STRIKE, EXPIRY, hh.European(), hh.Call(), hh.Spot())

    def price(params):
        spot, v0, kappa, theta, sigma, rho, r = params
        market = hh.HestonInputs(REF, r, spot, v0, kappa, theta, sigma, rho)
        return hh.solve(hh.PricingProblem(payoff, market), method).price

    return price


def best_of(fn, args, reps=6, outer=3):
    jax.block_until_ready(fn(args))
    times = []
    for _ in range(outer):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(args)
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) / reps)
    return min(times)


def main():
    n_pairs, steps = (2**19, 12) if jax.default_backend() == "gpu" else (2**13, 12)
    price = build_price(n_pairs, steps)
    params = jnp.array(
        [SPOT, HESTON["V0"], HESTON["kappa"], HESTON["theta"],
         HESTON["sigma"], HESTON["rho"], R],
        dtype=jnp.float64,
    )
    params_t = tuple(params)

    price_vec = lambda p: price(tuple(p))

    from hedgehog_tpu.methods.mixing_greeks import GREEK_ORDER, heston_mixing_price_and_greeks

    cfg = hh.SimulationConfig(
        trajectories=n_pairs, steps=steps, variance_reduction=hh.Antithetic(), seed=0
    )
    method = hh.MonteCarlo(hh.HestonDynamics(), hh.HestonQE(conditional=True), cfg)
    payoff = hh.VanillaOption(STRIKE, EXPIRY, hh.European(), hh.Call(), hh.Spot())

    def hand(p):
        spot, v0, kappa, theta, sigma, rho, r = tuple(p)
        market = hh.HestonInputs(REF, r, spot, v0, kappa, theta, sigma, rho)
        pr, g = heston_mixing_price_and_greeks(hh.PricingProblem(payoff, market), method)
        return pr, jnp.stack([g[k] for k in GREEK_ORDER])

    f_price = jax.jit(price_vec)
    f_rev = jax.jit(jax.value_and_grad(price_vec))
    f_fwd = jax.jit(jax.jacfwd(price_vec))
    f_hand = jax.jit(hand)

    t_price = best_of(f_price, params)
    t_rev = best_of(f_rev, params)
    t_fwd = best_of(f_fwd, params)
    t_hand = best_of(f_hand, params)

    g_rev = f_rev(params)[1]
    g_fwd = f_fwd(params)
    g_hand = f_hand(params)[1]
    import numpy as np

    rel = np.max(np.abs(np.asarray(g_rev) - np.asarray(g_fwd)) / (np.abs(np.asarray(g_rev)) + 1e-12))
    rel_h = np.max(np.abs(np.asarray(g_rev) - np.asarray(g_hand)) / (np.abs(np.asarray(g_rev)) + 1e-12))
    print(f"backend={jax.default_backend()} pairs={n_pairs} steps={steps}")
    print(f"price:        {t_price*1e3:8.1f} ms")
    print(f"reverse:      {t_rev*1e3:8.1f} ms  ratio={t_rev/t_price:.2f}")
    print(f"jacfwd:       {t_fwd*1e3:8.1f} ms  ratio={t_fwd/t_price:.2f}")
    print(f"hand-forward: {t_hand*1e3:8.1f} ms  ratio={t_hand/t_price:.2f}  (price+7 greeks)")
    print(f"max rel diff jacfwd vs rev: {rel:.2e}; hand vs rev: {rel_h:.2e}")
    print("grads:", np.asarray(g_hand))


if __name__ == "__main__":
    main()
