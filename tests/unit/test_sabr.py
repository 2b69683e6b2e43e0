"""SABR model family (beyond-reference: the reference covers BS and Heston
— src/market_inputs/market_inputs.jl).  Hagan et al. (2002) implied-vol
expansion + Euler MC on the T-forward, agreement-matrix style
(test/agreement/) plus a smile-calibration round-trip."""

import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import hedgehog_tpu as hh
from hedgehog_tpu.methods.sabr import hagan_vol

REF, EXPIRY = dt.date(2024, 1, 1), dt.date(2024, 12, 31)  # T = 1 (ACT/365)


def _market(alpha=0.2, beta=0.7, rho=-0.3, nu=0.4):
    return hh.SABRInputs(REF, 0.03, 100.0, alpha, beta, rho, nu)


def _opt(strike=100.0):
    return hh.VanillaOption(strike, EXPIRY, hh.European(), hh.Call(), hh.Spot())


def test_lognormal_corner_is_exact():
    """β = 1, ν = 0 is exactly GBM with σ = α — pinned to the BS closed
    form at 1e-12 (Hagan's expansion is exact there)."""
    p_sabr = float(hh.solve(
        hh.PricingProblem(_opt(), _market(0.2, 1.0, 0.0, 0.0)),
        hh.SABRAnalytic()).price)
    p_bs = float(hh.solve(
        hh.PricingProblem(_opt(), hh.BlackScholesInputs(REF, 0.03, 100.0, 0.2)),
        hh.BlackScholesAnalytic()).price)
    assert p_sabr == pytest.approx(p_bs, rel=1e-12)


def test_hagan_atm_continuity():
    """z/x(z) crosses its series window smoothly: the vol is continuous and
    smooth through K = F (where z = 0 exactly)."""
    F, T = 100.0, 1.0
    ks = jnp.asarray([F - 1e-3, F - 1e-7, F, F + 1e-7, F + 1e-3])
    vols = np.asarray(hagan_vol(F, ks, T, 0.2, 0.7, -0.3, 0.4))
    assert np.all(np.isfinite(vols))
    assert abs(vols[1] - vols[2]) < 1e-8 and abs(vols[3] - vols[2]) < 1e-8
    # AD at the exact ATM point (the 0/0 ratio is guarded)
    g = float(jax.grad(lambda k: hagan_vol(F, k, T, 0.2, 0.7, -0.3, 0.4))(F))
    assert np.isfinite(g)


def test_negative_rho_skews_the_smile():
    vols = np.asarray(hagan_vol(100.0, jnp.asarray([85.0, 100.0, 115.0]),
                                1.0, 0.2, 0.7, -0.5, 0.5))
    assert vols[0] > vols[1]  # downside vol above ATM under ρ < 0


def test_euler_mc_agreement():
    """Euler MC vs Hagan at moderate smile parameters: the ATM disagreement
    bounds BOTH the O(ν²T) expansion error and the O(dt) Euler bias."""
    mkt = _market()
    cfg = hh.SimulationConfig(trajectories=1 << 16, steps=64,
                              variance_reduction=hh.Antithetic(), seed=0, qmc=True)
    for K, tol in ((85.0, 2e-3), (100.0, 5e-3)):
        ph = float(hh.solve(hh.PricingProblem(_opt(K), mkt), hh.SABRAnalytic()).price)
        pm = float(hh.solve(
            hh.PricingProblem(_opt(K), mkt),
            hh.MonteCarlo(hh.SABRDynamics(), hh.EulerMaruyama(), cfg)).price)
        assert pm == pytest.approx(ph, rel=tol), K


def test_strike_grid_and_greeks():
    mkt = _market()
    ks = jnp.asarray([85.0, 95.0, 105.0, 120.0])
    grid = hh.solve(
        hh.PricingProblem(hh.VanillaOption(ks, EXPIRY, hh.European(), hh.Call(), hh.Spot()), mkt),
        hh.SABRAnalytic()).price
    assert np.all(np.diff(np.asarray(grid)) < 0)
    for field, x0 in (("alpha", 0.2), ("rho", -0.3), ("nu", 0.4)):
        def price(x):
            m = _market(**{field: x})
            return hh.solve(hh.PricingProblem(_opt(), m), hh.SABRAnalytic()).price
        g = float(jax.grad(price)(x0))
        h = 1e-5
        fd = (float(price(x0 + h)) - float(price(x0 - h))) / (2 * h)
        assert g == pytest.approx(fd, rel=1e-5), field


def test_smile_calibration_roundtrip():
    """Recover (α, ρ, ν) at fixed β from Hagan smile prices — the
    reference's calibration pattern (test/unit/calibration.jl) on the new
    family."""
    true = _market(0.25, 0.7, -0.4, 0.6)
    strikes = [80.0, 90.0, 100.0, 110.0, 125.0]
    payoffs = [_opt(k) for k in strikes]
    quotes = jnp.asarray([
        float(hh.solve(hh.PricingProblem(p, true), hh.SABRAnalytic()).price)
        for p in payoffs
    ])
    guess = _market(0.15, 0.7, -0.1, 0.3)
    calib = hh.CalibrationProblem(
        hh.BasketPricingProblem(payoffs, guess), quotes,
        jnp.asarray([0.15, -0.1, 0.3]),
        pricing_method=hh.SABRAnalytic(),
        accessors=(hh.FieldLens("market_inputs.alpha"),
                   hh.FieldLens("market_inputs.rho"),
                   hh.FieldLens("market_inputs.nu")),
    )
    sol = hh.solve(calib, hh.OptimizerAlgo(max_iters=300),
                   lb=jnp.asarray([0.01, -0.95, 0.01]),
                   ub=jnp.asarray([2.0, 0.95, 3.0]))
    assert bool(sol.converged)
    a, r_, n_ = (float(x) for x in sol.u)
    assert a == pytest.approx(0.25, rel=3e-2)
    assert r_ == pytest.approx(-0.4, rel=5e-2)
    assert n_ == pytest.approx(0.6, rel=5e-2)


def test_sabr_unsupported_routes_raise():
    mkt = _market()
    with pytest.raises(TypeError, match="no terminal law"):
        hh.solve(hh.PricingProblem(_opt(), mkt),
                 hh.CarrMadan(1.0, 32.0, hh.SABRDynamics()))
    with pytest.raises(TypeError, match="European-only"):
        hh.solve(hh.PricingProblem(
            hh.VanillaOption(100.0, EXPIRY, hh.American(), hh.Put(), hh.Spot()), mkt),
            hh.SABRAnalytic())


def test_sabr_composes_with_lsm_and_asians():
    """The SABR grid (forward-ratio converted to spot prices) composes with
    the existing grid consumers: American LSM agrees with the CRR oracle at
    the degenerate β=1, ν=0 (= GBM) corner, a smiley American dominates its
    European, and arithmetic Asians price."""
    cfg = hh.SimulationConfig(trajectories=1 << 14, steps=50,
                              variance_reduction=hh.Antithetic(), seed=0, qmc=True)
    am = hh.VanillaOption(105.0, EXPIRY, hh.American(), hh.Put(), hh.Spot())
    lsm = hh.LSM(hh.MonteCarlo(hh.SABRDynamics(), hh.EulerMaruyama(), cfg), 4)
    p_lsm = float(hh.solve(
        hh.PricingProblem(am, _market(0.2, 1.0, 0.0, 0.0)), lsm).price)
    crr = float(hh.solve(
        hh.PricingProblem(am, hh.BlackScholesInputs(REF, 0.03, 100.0, 0.2)),
        hh.CoxRossRubinsteinMethod(500)).price)
    assert p_lsm == pytest.approx(crr, rel=2e-2)  # american_options.jl:51 tol

    mkt = _market()
    p_am = float(hh.solve(hh.PricingProblem(am, mkt), lsm).price)
    p_eu = float(hh.solve(
        hh.PricingProblem(hh.VanillaOption(105.0, EXPIRY, hh.European(), hh.Put(), hh.Spot()), mkt),
        hh.SABRAnalytic()).price)
    assert p_am > p_eu

    asian = hh.AsianOption(100.0, EXPIRY, 50, hh.European(), hh.Call(),
                           hh.Spot(), hh.ArithmeticAverage())
    pa = float(hh.solve(
        hh.PricingProblem(asian, mkt),
        hh.MonteCarlo(hh.SABRDynamics(), hh.EulerMaruyama(), cfg)).price)
    assert 0.0 < pa < p_eu + 10.0  # sane magnitude
