"""Digital (cash-or-nothing) options — a payoff family beyond the
reference's vanilla-only taxonomy (src/payoffs/payoffs.jl), priced by every
applicable method:

- BlackScholesAnalytic: closed form D·cash·Φ(cp·d2)
- CarrMadan: Gil-Pelaez inversion on the panel nodes (both engines)
- MonteCarlo: terminal samplers (indicator payoff) AND the conditional
  mixing estimator (smooth per-path Φ(d2) close — pathwise AD greeks
  survive, where the raw indicator differentiates to zero)
- CRR / LSM: generic payoff callable through the trees and grids

Cross-method agreement mirrors the reference's test strategy
(test/agreement/): independent methods must agree on the same price.
"""

import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.stats import norm

import hedgehog_tpu as hh

REF = dt.date(2024, 1, 1)
EXPIRY = dt.date(2024, 12, 31)  # T = 1.0 under ACT/365
R, SPOT, K, SIGMA, CASH = 0.05, 100.0, 105.0, 0.2, 10.0
T = 1.0
H = dict(V0=0.04, kappa=2.0, theta=0.04, sigma=0.3, rho=-0.7)


def _bs_market():
    return hh.BlackScholesInputs(REF, R, SPOT, SIGMA)


def _heston_market():
    return hh.HestonInputs(REF, 0.03, SPOT, *H.values())


def _digital(cp=None, style=None, cash=CASH, strike=K):
    return hh.DigitalOption(
        strike, EXPIRY, style or hh.European(), cp or hh.Call(), hh.Spot(), cash
    )


def _closed_form(cp_sign):
    D = np.exp(-R * T)
    F = SPOT / D
    d2 = (np.log(F / K) - 0.5 * SIGMA**2 * T) / (SIGMA * np.sqrt(T))
    return D * CASH * norm.cdf(cp_sign * d2)


def test_analytic_digital_closed_form():
    prob_c = hh.PricingProblem(_digital(hh.Call()), _bs_market())
    prob_p = hh.PricingProblem(_digital(hh.Put()), _bs_market())
    pc = float(hh.solve(prob_c, hh.BlackScholesAnalytic()).price)
    pp = float(hh.solve(prob_p, hh.BlackScholesAnalytic()).price)
    np.testing.assert_allclose(pc, _closed_form(1.0), rtol=1e-12)
    np.testing.assert_allclose(pp, _closed_form(-1.0), rtol=1e-12)
    # cash parity: call + put = D·cash
    np.testing.assert_allclose(pc + pp, np.exp(-R * T) * CASH, rtol=1e-12)


def test_analytic_digital_zero_vol_intrinsic():
    mkt = hh.BlackScholesInputs(REF, R, SPOT, 0.0)
    # forward = S/D > K → ITM digital call pays discounted cash
    p = float(hh.solve(hh.PricingProblem(_digital(), mkt), hh.BlackScholesAnalytic()).price)
    np.testing.assert_allclose(p, np.exp(-R * T) * CASH, rtol=1e-12)


def test_analytic_digital_delta_via_ad():
    # delta = D·cash·φ(d2)/(S·σ√T) for a digital call
    prob = hh.PricingProblem(_digital(), _bs_market())
    delta = float(jax.grad(
        lambda s: hh.solve(hh.SpotLens().set(prob, s), hh.BlackScholesAnalytic()).price
    )(SPOT))
    D = np.exp(-R * T)
    F = SPOT / D
    d2 = (np.log(F / K) - 0.5 * SIGMA**2 * T) / (SIGMA * np.sqrt(T))
    np.testing.assert_allclose(delta, D * CASH * norm.pdf(d2) / (SPOT * SIGMA * np.sqrt(T)), rtol=1e-10)


def test_carr_madan_digital_vs_analytic_both_engines():
    for cp in (hh.Call(), hh.Put()):
        prob = hh.PricingProblem(_digital(cp), _bs_market())
        ref = float(hh.solve(prob, hh.BlackScholesAnalytic()).price)
        for engine in ("complex", "pair"):
            cm = float(hh.solve(
                prob, hh.CarrMadan(1.0, "auto", hh.LognormalDynamics(), engine=engine)
            ).price)
            np.testing.assert_allclose(cm, ref, atol=1e-8)


def test_carr_madan_digital_strike_grid():
    strikes = jnp.array([85.0, 100.0, 115.0])
    prob = hh.PricingProblem(_digital(strike=strikes), _bs_market())
    grid = np.asarray(hh.solve(prob, hh.CarrMadan(1.0, "auto", hh.LognormalDynamics())).price)
    singles = [float(hh.solve(hh.PricingProblem(_digital(strike=float(k)), _bs_market()),
                              hh.BlackScholesAnalytic()).price) for k in strikes]
    np.testing.assert_allclose(grid, singles, atol=1e-8)


def test_carr_madan_digital_odd_nodes_raises():
    prob = hh.PricingProblem(_digital(), _bs_market())
    with pytest.raises(ValueError, match="even node count"):
        hh.solve(prob, hh.CarrMadan(1.0, 64.0, hh.LognormalDynamics(), nodes=255))


def test_terminal_mc_digital_vs_analytic():
    prob = hh.PricingProblem(_digital(), _bs_market())
    ref = float(hh.solve(prob, hh.BlackScholesAnalytic()).price)
    cfg = hh.SimulationConfig(trajectories=1 << 15, steps=1,
                              variance_reduction=hh.Antithetic(), seed=0)
    mc = float(hh.solve(prob, hh.MonteCarlo(
        hh.LognormalDynamics(), hh.BlackScholesExact(), cfg)).price)
    np.testing.assert_allclose(mc, ref, rtol=2e-2)


def test_conditional_mc_digital_vs_carr_madan():
    prob = hh.PricingProblem(_digital(), _heston_market())
    cm = float(hh.solve(prob, hh.CarrMadan(
        1.0, "auto", hh.HestonDynamics())).price)
    cfg = hh.SimulationConfig(trajectories=1 << 14, steps=12,
                              variance_reduction=hh.Antithetic(), seed=0)
    for strat in (hh.HestonQE(conditional=True), hh.HestonExactMixing()):
        steps = 12 if isinstance(strat, hh.HestonQE) else 2
        cfg_s = hh.SimulationConfig(trajectories=1 << 14, steps=steps,
                                    variance_reduction=hh.Antithetic(), seed=0)
        mc = float(hh.solve(prob, hh.MonteCarlo(
            hh.HestonDynamics(), strat, cfg_s)).price)
        np.testing.assert_allclose(mc, cm, rtol=2e-2)


def test_conditional_digital_delta_is_smooth_where_pathwise_dies():
    """The motivation for digitals-on-the-mixing-estimator: raw pathwise AD
    of an indicator payoff is zero a.s., the conditional Φ(d2) close is
    smooth and matches the Fourier delta."""
    market = _heston_market()
    payoff = _digital(cash=1.0)

    def mc_price(spot, strat, steps):
        m = hh.HestonInputs(REF, 0.03, spot, *H.values())
        cfg = hh.SimulationConfig(trajectories=1 << 14, steps=steps,
                                  variance_reduction=hh.Antithetic(), seed=0)
        return hh.solve(hh.PricingProblem(payoff, m),
                        hh.MonteCarlo(hh.HestonDynamics(), strat, cfg)).price

    # raw terminal-sample estimator: indicator payoff → zero gradient
    d_raw = float(jax.grad(mc_price)(jnp.float64(SPOT), hh.HestonQE(), 12))
    assert d_raw == 0.0

    # conditional estimator: smooth, matches Carr-Madan central difference
    d_cond = float(jax.grad(mc_price)(jnp.float64(SPOT), hh.HestonQE(conditional=True), 12))
    eps = 0.5
    cm = lambda s: float(hh.solve(
        hh.PricingProblem(payoff, hh.HestonInputs(REF, 0.03, s, *H.values())),
        hh.CarrMadan(1.0, "auto", hh.HestonDynamics())).price)
    d_cm = (cm(SPOT + eps) - cm(SPOT - eps)) / (2 * eps)
    np.testing.assert_allclose(d_cond, d_cm, rtol=5e-2)


def test_crr_digital_european_vs_analytic():
    prob = hh.PricingProblem(_digital(), _bs_market())
    ref = float(hh.solve(prob, hh.BlackScholesAnalytic()).price)
    # digital trees converge O(1/√n) with oscillation; average adjacent
    # step counts to cancel the leading oscillation term
    p1 = float(hh.solve(prob, hh.CoxRossRubinsteinMethod(800)).price)
    p2 = float(hh.solve(prob, hh.CoxRossRubinsteinMethod(801)).price)
    np.testing.assert_allclose(0.5 * (p1 + p2), ref, rtol=1e-2)


def test_lsm_american_digital_runs_and_dominates_european():
    prob = hh.PricingProblem(_digital(style=hh.American(), cp=hh.Put()), _heston_market())
    cfg = hh.SimulationConfig(trajectories=1 << 13, steps=16,
                              variance_reduction=hh.Antithetic(), seed=0)
    mc = hh.MonteCarlo(hh.HestonDynamics(), hh.HestonQE(conditional=True), cfg)
    p_am = float(hh.solve(prob, hh.LSM(mc, 3)).price)
    p_eu = float(hh.solve(hh.PricingProblem(_digital(cp=hh.Put()), _heston_market()),
                          hh.CarrMadan(1.0, "auto", hh.HestonDynamics())).price)
    assert p_am >= p_eu - 0.05


def test_analytic_greek_rejects_digital():
    prob = hh.PricingProblem(_digital(), _bs_market())
    with pytest.raises(TypeError, match="VANILLA"):
        hh.solve(hh.GreekProblem(prob, hh.SpotLens()), hh.AnalyticGreek(),
                 hh.BlackScholesAnalytic())


def test_american_digital_into_european_method_raises():
    prob = hh.PricingProblem(_digital(style=hh.American()), _bs_market())
    with pytest.raises(TypeError):
        hh.solve(prob, hh.BlackScholesAnalytic())
    with pytest.raises(TypeError):
        hh.solve(prob, hh.CarrMadan(1.0, 32.0, hh.LognormalDynamics()))
