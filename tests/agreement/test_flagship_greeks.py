"""Flagship greek-vector contract (BASELINE.json north star #2):
the full 7-parameter Heston gradient (spot, V0, κ, θ, σ, ρ, r) through the
pure-JAX QE-M Monte Carlo path — correct values (vs Carr-Madan finite
differences) and a sane greek/price cost ratio (bench.py reports the GPU
ratio every run)."""

import datetime as dt
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import hedgehog_tpu as hh

# bench.py lives at the repo root (two levels up from this test file)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

REF, EXPIRY = dt.date(2024, 1, 1), dt.date(2025, 1, 1)
SPOT, STRIKE, R = 100.0, 100.0, 0.03
HESTON = (0.04, 2.0, 0.04, 0.3, -0.7)  # V0, kappa, theta, sigma, rho
PAYOFF = hh.VanillaOption(STRIKE, EXPIRY, hh.European(), hh.Call(), hh.Spot())


def _qe_price(params, n_pairs=2**15, steps=12):
    spot, v0, kappa, theta, sigma, rho, r = params
    market = hh.HestonInputs(REF, r, spot, v0, kappa, theta, sigma, rho)
    cfg = hh.SimulationConfig(
        trajectories=n_pairs, steps=steps, variance_reduction=hh.Antithetic(), seed=3
    )
    method = hh.MonteCarlo(hh.HestonDynamics(), hh.HestonQE(), cfg)
    return hh.solve(hh.PricingProblem(PAYOFF, market), method).price


def _cm_price(params):
    spot, v0, kappa, theta, sigma, rho, r = params
    market = hh.HestonInputs(REF, r, spot, v0, kappa, theta, sigma, rho)
    return float(hh.solve(hh.PricingProblem(PAYOFF, market), hh.CarrMadan(1.0, 32.0, hh.HestonDynamics())).price)


def test_flagship_greek_vector_values():
    """Pathwise QE gradient vs Carr-Madan central differences
    (greeks_agreement.jl:170-241 tolerances: delta 3e-2, vega-analog 1e-1,
    rho 1e-2 — MC at 32k antithetic pairs)."""
    params = tuple(jnp.float64(x) for x in (SPOT, *HESTON, R))
    value, grads = jax.jit(jax.value_and_grad(_qe_price))(params)
    grads = [float(g) for g in grads]
    assert all(np.isfinite(g) for g in grads), grads

    cm0 = _cm_price(params)
    assert float(value) == pytest.approx(cm0, rel=2e-2)

    def cm_fd(i, h):
        up = list(params); dn = list(params)
        up[i] = params[i] + h
        dn[i] = params[i] - h
        return (_cm_price(tuple(up)) - _cm_price(tuple(dn))) / (2 * h)

    # delta (spot), vol-of-vol greek (sigma), rho-rate greek (r)
    assert grads[0] == pytest.approx(cm_fd(0, 0.5), rel=3e-2)
    assert grads[4] == pytest.approx(cm_fd(4, 1e-3), rel=1.5e-1, abs=5e-2)
    assert grads[6] == pytest.approx(cm_fd(6, 1e-4), rel=1e-2)
    # V0 / theta greeks: positive for an ATM call
    assert grads[1] > 0 and grads[2] > 0


def test_flagship_greek_ratio_contract():
    """time(7-greek vector)/time(price) for the QE pair: finite and
    bounded-sane on the CPU (reverse AD + remat through the QE scan).  The
    GPU ratio is measured by bench.py, not asserted here."""
    import bench

    ratio, t_price, t_grad = bench.flagship_greek_ratio(n_pairs=2**13, steps=10)
    assert np.isfinite(ratio) and ratio > 0
    assert ratio < 10.0, f"greek-vector ratio {ratio:.2f} pathological on CPU"
