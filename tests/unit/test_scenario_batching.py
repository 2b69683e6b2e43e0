"""Scenario-batch pricing (production risk-run shape): vmap over whole
market-input pytrees — spot ladders, vol shocks, curve shifts — with one
compiled program. The batched counterpart of the reference's serial
per-scenario loops."""

import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hedgehog_tpu import (
    BlackScholesAnalytic,
    BlackScholesInputs,
    Call,
    CarrMadan,
    European,
    HestonDynamics,
    HestonInputs,
    PricingProblem,
    Spot,
    SpotLens,
    VanillaOption,
    solve,
)

REF = dt.date(2024, 1, 1)
EXPIRY = dt.date(2025, 1, 1)
OPT = VanillaOption(100.0, EXPIRY, European(), Call(), Spot())


def test_spot_ladder_vmap():
    market = BlackScholesInputs(REF, 0.05, 100.0, 0.2)
    prob = PricingProblem(OPT, market)
    spots = jnp.linspace(50.0, 150.0, 101)
    ladder = jax.vmap(lambda s: solve(SpotLens().set(prob, s), BlackScholesAnalytic()).price)(
        spots
    )
    assert ladder.shape == (101,)
    assert bool(jnp.all(jnp.diff(ladder) > 0))  # call increases in spot
    # convexity
    assert bool(jnp.all(jnp.diff(ladder, 2) > -1e-9))


def test_heston_scenario_grid_vmap():
    """vmap Carr-Madan over a (V0, rho) scenario grid — one XLA program for a
    full stress matrix."""
    v0s = jnp.asarray([0.02, 0.04, 0.09])
    rhos = jnp.asarray([-0.9, -0.5, 0.0])

    def price(v0, rho):
        market = HestonInputs(REF, 0.03, 100.0, v0, 2.0, 0.04, 0.3, rho)
        return solve(PricingProblem(OPT, market), CarrMadan(1.0, 32.0, HestonDynamics())).price

    grid = jax.vmap(lambda v: jax.vmap(lambda r: price(v, r))(rhos))(v0s)
    assert grid.shape == (3, 3)
    # higher V0 → higher ATM price, every rho column
    assert bool(jnp.all(jnp.diff(grid, axis=0) > 0))


def test_jit_cache_stability():
    """Same treedef must not retrace: markers/static fields hash equal."""
    market = BlackScholesInputs(REF, 0.05, 100.0, 0.2)
    prob = PricingProblem(OPT, market)
    f = jax.jit(lambda p: solve(p, BlackScholesAnalytic()).price)
    f(prob)
    n0 = f._cache_size()
    f(PricingProblem(VanillaOption(110.0, EXPIRY, European(), Call(), Spot()), market))
    assert f._cache_size() == n0  # only leaf values changed
