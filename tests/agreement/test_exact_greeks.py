"""Unbiased greeks on the exact-transition mixing flagship.

The exact scheme's Poisson count is a step function of the parameters, so
plain pathwise AD drops the rate dependence of the count distribution and
the V-leg greeks are badly biased.  heston_exact_price_and_greeks adds the
frozen-count Poisson score (likelihood-ratio term) — these tests pin every
greek of the 7-param vector against the Carr-Madan parameter Jacobian
(reference greeks_agreement.jl:170-241 pattern: seeded MC greeks vs an
independent method) and prove the plain pathwise gradient is NOT usable.
"""

import datetime as dt

import jax
import jax.numpy as jnp
import pytest

import hedgehog_tpu as hh
from hedgehog_tpu.methods.mixing_greeks import (
    GREEK_ORDER,
    heston_exact_price_and_greeks,
)

REF, EXPIRY = dt.date(2024, 1, 1), dt.date(2025, 1, 1)
R, SPOT, STRIKE = 0.03, 100.0, 100.0
HESTON = dict(V0=0.04, kappa=2.0, theta=0.04, sigma=0.3, rho=-0.7)
SEGMENTS = 2


def _mkprob(params):
    spot, v0, kappa, theta, sigma, rho, r = params
    market = hh.HestonInputs(REF, r, spot, v0, kappa, theta, sigma, rho)
    payoff = hh.VanillaOption(STRIKE, EXPIRY, hh.European(), hh.Call(), hh.Spot())
    return hh.PricingProblem(payoff, market)


_P0 = jnp.array(
    [SPOT, HESTON["V0"], HESTON["kappa"], HESTON["theta"], HESTON["sigma"],
     HESTON["rho"], R], jnp.float64,
)


def _method(trajectories=1 << 16, seed=3):
    cfg = hh.SimulationConfig(
        trajectories=trajectories, steps=SEGMENTS,
        variance_reduction=hh.Antithetic(), seed=seed, qmc=True,
    )
    return hh.MonteCarlo(hh.HestonDynamics(), hh.HestonExactMixing(), cfg)


def test_exact_greeks_match_carr_madan_jacobian():
    def cm_price(p):
        return hh.solve(
            _mkprob(tuple(p)), hh.CarrMadan(1.0, 32.0, hh.HestonDynamics())
        ).price

    cm_grad = jax.grad(cm_price)(_P0)
    _, greeks = heston_exact_price_and_greeks(_mkprob(tuple(_P0)), _method())
    # V0/κ/θ/σ carry the likelihood-ratio term; spot/ρ/rate are pathwise.
    # rel 5e-2 with an absolute floor for the small greeks (κ ≈ 0.08,
    # ρ ≈ 0.03 on this market) — QMC 2^16 mirrored pairs.
    for i, name in enumerate(GREEK_ORDER):
        want = float(cm_grad[i])
        got = float(greeks[name])
        assert got == pytest.approx(want, rel=5e-2, abs=2e-2), (name, want, got)


def test_grad_through_solve_is_unbiased_and_raw_pathwise_is_not():
    """The per-path values carry the likelihood-ratio surrogate, so plain
    jax.grad through the seeded solve matches Carr-Madan (the reference's
    differentiate-through-solve contract, greeks_problem.jl:249-262) — while
    the RAW pathwise gradient (score term dropped) misses the σ-greek by
    many times.  Documents WHY the surrogate is baked in."""
    from hedgehog_tpu.methods.montecarlo import _heston_exact_mixing_values

    def mc_price(p):
        return hh.solve(_mkprob(tuple(p)), _method()).price

    def cm_price(p):
        return hh.solve(
            _mkprob(tuple(p)), hh.CarrMadan(1.0, 32.0, hh.HestonDynamics())
        ).price

    def raw_pathwise_price(p):
        prob = _mkprob(tuple(p))
        vals, _ = _heston_exact_mixing_values(
            prob, _method().config, None, with_score=True
        )
        T = hh.yearfrac(prob.market_inputs.reference_date, prob.payoff.expiry)
        return jnp.exp(-p[6] * T) * jnp.mean(vals)

    i_sigma = GREEK_ORDER.index("sigma")
    g_solve = float(jax.grad(mc_price)(_P0)[i_sigma])
    g_true = float(jax.grad(cm_price)(_P0)[i_sigma])
    g_raw = float(jax.grad(raw_pathwise_price)(_P0)[i_sigma])
    assert g_solve == pytest.approx(g_true, rel=8e-2)
    assert abs(g_raw - g_true) > 5.0 * abs(g_true)


def test_exact_greeks_price_equals_seeded_solve():
    prob = _mkprob(tuple(_P0))
    method = _method(trajectories=4096)
    price, _ = heston_exact_price_and_greeks(prob, method)
    want = hh.solve(prob, method).price
    assert float(price) == pytest.approx(float(want), rel=1e-12)


def test_exact_greeks_finite_when_wh_cube_clamps_to_zero():
    """Regression: at large path counts some path's Wilson-Hilferty cube
    clamps V to exactly 0; sqrt(x·y) in the conditional moments then has an
    infinite derivative against a zero cotangent and AD produced NaN greeks
    (the positive floor in iv_cond_moments zeroes the branch derivative)."""
    _, greeks = heston_exact_price_and_greeks(
        _mkprob(tuple(_P0)), _method(trajectories=1 << 17, seed=7)
    )
    for name, g in greeks.items():
        assert bool(jnp.isfinite(g)), name


def test_exact_greeks_rejects_wrong_method():
    prob = _mkprob(tuple(_P0))
    cfg = hh.SimulationConfig(trajectories=1024, steps=2, seed=0)
    qe = hh.MonteCarlo(hh.HestonDynamics(), hh.HestonQE(conditional=True), cfg)
    with pytest.raises(TypeError, match="HestonExactMixing"):
        heston_exact_price_and_greeks(prob, qe)
