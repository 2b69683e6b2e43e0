"""Broadie-Kaya stress grid: κ∈{0.5,2,5} × σ∈{0.1,0.3,0.8} × T∈{0.25,1,2}
vs the Carr-Madan oracle (VERDICT r1 item 4: extreme-but-legal Heston params
must not silently corrupt the BK sampler — this grid spans Bessel orders
ν = 2κθ/σ² − 1 from −0.94 to 39 and both Feller regimes).

Also pins that the sampler composes with jit: one device program, the same
numbers as eager execution.
"""

import datetime as dt
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import hedgehog_tpu as hh
from hedgehog_tpu.distributions.broadie_kaya import _bk_terminal_from_params

SPOT, STRIKE, RATE = 100.0, 100.0, 0.05
V0, THETA_LT, RHO = 0.04, 0.04, -0.6
KAPPAS = (0.5, 2.0, 5.0)
SIGMAS = (0.1, 0.3, 0.8)
TS = (0.25, 1.0, 2.0)
N_PATHS = 2048  # tolerance below scales with the measured MC standard error


def _cm_price(kappa, sigma, T):
    ref = dt.date(2024, 1, 1)
    expiry = hh.add_yearfrac(hh.to_ticks(ref), T)
    market = hh.HestonInputs(ref, RATE, SPOT, V0, kappa, THETA_LT, sigma, RHO)
    payoff = hh.VanillaOption(STRIKE, expiry, hh.European(), hh.Call(), hh.Spot())
    return float(hh.solve(hh.PricingProblem(payoff, market), hh.CarrMadan(1.0, 32.0, hh.HestonDynamics())).price)


@partial(jax.jit, static_argnames=("n",))
def _bk_price_grid(kappas, sigmas, Ts, n):
    """(combo,) BK prices + standard errors, one vmapped compile."""

    def one(i, kappa, sigma, T):
        key = jax.random.fold_in(jax.random.PRNGKey(2024), i)
        prices = _bk_terminal_from_params(
            key, SPOT, V0, kappa, THETA_LT, sigma, RHO, RATE, T,
            n=n, antithetic=True, cf_terms=160, iters=64,
        )
        payoffs = jnp.mean(jnp.maximum(prices - STRIKE, 0.0), axis=0)  # pair means
        disc = jnp.exp(-RATE * T)
        price = disc * jnp.mean(payoffs)
        se = disc * jnp.std(payoffs) / jnp.sqrt(1.0 * n)
        return price, se

    idx = jnp.arange(kappas.shape[0])
    return jax.vmap(one)(idx, kappas, sigmas, Ts)


def test_bk_stress_grid_vs_carr_madan():
    combos = [(k, s, t) for k in KAPPAS for s in SIGMAS for t in TS]
    kappas = jnp.array([c[0] for c in combos])
    sigmas = jnp.array([c[1] for c in combos])
    Ts = jnp.array([c[2] for c in combos])
    bk, se = _bk_price_grid(kappas, sigmas, Ts, N_PATHS)
    bk, se = np.asarray(bk), np.asarray(se)
    failures = []
    for i, (k, s, t) in enumerate(combos):
        cm = _cm_price(k, s, t)
        tol = max(2e-2 * cm, 3.5 * se[i])
        if not np.isfinite(bk[i]) or abs(bk[i] - cm) > tol:
            failures.append(f"κ={k} σ={s} T={t}: bk={bk[i]:.4f} cm={cm:.4f} se={se[i]:.4f}")
    assert not failures, "BK vs Carr-Madan stress failures:\n" + "\n".join(failures)


def test_bk_sampler_under_jit_matches_eager():
    """The whole complex128 sampler compiles into one jitted program and
    reproduces eager execution — same program, same RNG."""
    key = jax.random.PRNGKey(7)
    params = (100.0, 0.04, 1.5, 0.04, 0.3, -0.6, 0.05, 1.0)
    sample = partial(_bk_terminal_from_params, n=512, antithetic=True, cf_terms=96, iters=48)
    eager = sample(key, *params)
    jitted = jax.jit(sample)(key, *(jnp.float64(p) for p in params))
    np.testing.assert_allclose(np.asarray(jitted), np.asarray(eager), rtol=1e-9)
