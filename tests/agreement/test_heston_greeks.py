"""Heston pathwise MC greeks vs AD-through-Carr-Madan greeks.

A batched extension of the reference's MC-vs-analytic greek agreement
(greeks_agreement.jl:170-241): for Heston there is no closed form, so the
Fourier pricer differentiated with jax.grad is the oracle.  Also guards the
double-where sqrt fix (NaN-free gradients through full-truncation Euler)."""

import datetime as dt

import numpy as np
import pytest

from hedgehog_tpu import (
    Antithetic,
    BatchGreekProblem,
    Call,
    CarrMadan,
    EulerMaruyama,
    European,
    FieldLens,
    HestonDynamics,
    HestonInputs,
    MonteCarlo,
    PricingProblem,
    ReverseAD,
    SimulationConfig,
    Spot,
    SpotLens,
    VanillaOption,
    solve,
)

REF = dt.date(2020, 1, 1)
MARKET = HestonInputs(REF, 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
PAYOFF = VanillaOption(100.0, dt.date(2021, 1, 1), European(), Call(), Spot())
PROB = PricingProblem(PAYOFF, MARKET)

LENSES = (
    SpotLens(),
    FieldLens("market_inputs.V0"),
    FieldLens("market_inputs.theta"),
    FieldLens("market_inputs.sigma"),
    FieldLens("market_inputs.rho"),
)


def test_heston_mc_greeks_vs_carr_madan():
    cm = CarrMadan(1.0, 32.0, HestonDynamics())
    mc = MonteCarlo(
        HestonDynamics(),
        EulerMaruyama(),
        SimulationConfig(trajectories=60_000, steps=64, variance_reduction=Antithetic(), seed=3),
    )
    g_cm = solve(BatchGreekProblem(PROB, LENSES), ReverseAD(), cm)
    g_mc = solve(BatchGreekProblem(PROB, LENSES), ReverseAD(), mc)
    for lens in LENSES:
        a, b = float(g_cm[lens]), float(g_mc[lens])
        assert np.isfinite(b), f"NaN/inf MC greek for {lens}"
        # pathwise MC + discretization: generous tolerances, scale-aware
        assert b == pytest.approx(a, rel=0.15, abs=0.05), f"{lens}: cm={a} mc={b}"
