"""Bates (1996) model family — Heston stochastic variance + Merton jumps
(models/dynamics.py::BatesDynamics, BatesInputs), the production equity
smile model, beyond the reference's BS + Heston.

Pins: the λ = 0 corner equals the Heston CF exactly and the σ_vol → 0,
V0 = θ corner converges to Merton; both Carr-Madan engines agree; the
extended Romano-Touzi mixing estimator (conditional on V-path AND jump
count) agrees with the CF at bp level with smooth pathwise greeks; the
jump-augmented Euler grid serves LSM and Asians; dividend identity.
"""

import datetime as dt
import math

import jax
import pytest

import hedgehog_tpu as hh

REF = dt.date(2024, 1, 1)
EXPIRY = dt.date(2024, 12, 31)


def _market(**kw):
    kw.setdefault("jump_intensity", 0.5)
    kw.setdefault("jump_mean", -0.1)
    kw.setdefault("jump_std", 0.15)
    return hh.BatesInputs(REF, 0.05, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7, **kw)


def _opt(strike=100.0, cp=None, style=None):
    return hh.VanillaOption(strike, EXPIRY, style or hh.European(),
                            cp or hh.Call(), hh.Spot())


def _cm(**kw):
    return hh.CarrMadan(1.0, "auto", hh.BatesDynamics(), **kw)


def test_cm_engines_and_model_corners():
    prob = hh.PricingProblem(_opt(), _market())
    pc = float(hh.solve(prob, _cm(engine="complex")).price)
    pp = float(hh.solve(prob, _cm(engine="pair")).price)
    assert pc == pytest.approx(pp, abs=1e-7)
    # λ = 0 → Heston exactly
    h = hh.HestonInputs(REF, 0.05, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
    ph = float(hh.solve(hh.PricingProblem(_opt(), h),
                        hh.CarrMadan(1.0, "auto", hh.HestonDynamics())).price)
    p0 = float(hh.solve(hh.PricingProblem(_opt(), _market(jump_intensity=0.0)),
                        _cm()).price)
    assert p0 == pytest.approx(ph, abs=1e-9)
    # σ_vol → 0, V0 = θ, ρ = 0 → Merton(√V0) (measured −0.12bp at σ_v=0.01)
    bm = hh.BatesInputs(REF, 0.05, 100.0, 0.04, 2.0, 0.04, 0.01, 0.0,
                        0.5, -0.1, 0.15)
    mm = hh.MertonInputs(REF, 0.05, 100.0, 0.2, 0.5, -0.1, 0.15)
    pbm = float(hh.solve(hh.PricingProblem(_opt(), bm), _cm()).price)
    pmm = float(hh.solve(hh.PricingProblem(_opt(), mm), hh.MertonAnalytic()).price)
    assert pbm == pytest.approx(pmm, rel=1e-4)
    assert pc > ph  # jumps add convexity value


def test_mixing_estimator_vs_cf():
    """The jump-extended Romano-Touzi mixing estimator: conditional on
    (V-path, N), logS_T is normal with the jump-shifted forward and
    variance — measured +1.9bp at 12 QE steps × 2^16 QMC pairs."""
    prob = hh.PricingProblem(_opt(), _market())
    cm = float(hh.solve(prob, _cm()).price)
    cfg = hh.SimulationConfig(trajectories=1 << 16, steps=12,
                              variance_reduction=hh.Antithetic(), seed=0,
                              qmc=True)
    p = float(hh.solve(prob, hh.MonteCarlo(hh.BatesDynamics(),
                                           hh.HestonQE(conditional=True),
                                           cfg)).price)
    assert p == pytest.approx(cm, rel=6e-3)
    # digitals close smoothly too
    dg = hh.DigitalOption(100.0, EXPIRY, hh.European(), hh.Call(), hh.Spot())
    pd_cm = float(hh.solve(hh.PricingProblem(dg, _market()), _cm()).price)
    pd_mx = float(hh.solve(hh.PricingProblem(dg, _market()),
                           hh.MonteCarlo(hh.BatesDynamics(),
                                         hh.HestonQE(conditional=True), cfg)).price)
    assert pd_mx == pytest.approx(pd_cm, rel=1e-2)


def test_mixing_pathwise_delta_matches_cf():
    prob = hh.PricingProblem(_opt(), _market())
    cfg = hh.SimulationConfig(trajectories=1 << 15, steps=12,
                              variance_reduction=hh.Antithetic(), seed=0,
                              qmc=True)
    d_mx = float(jax.grad(lambda s: hh.solve(
        hh.SpotLens().set(prob, s),
        hh.MonteCarlo(hh.BatesDynamics(), hh.HestonQE(conditional=True), cfg)
    ).price)(100.0))
    d_cm = float(jax.grad(lambda s: hh.solve(
        hh.SpotLens().set(prob, s), _cm()).price)(100.0))
    assert d_mx == pytest.approx(d_cm, rel=2e-2)


@pytest.mark.slow
def test_euler_grid_lsm_and_asian():
    prob = hh.PricingProblem(_opt(), _market())
    cm = float(hh.solve(prob, _cm()).price)
    cfg = hh.SimulationConfig(trajectories=1 << 15, steps=100,
                              variance_reduction=hh.Antithetic(), seed=0,
                              qmc=True)
    p_eu = float(hh.solve(prob, hh.MonteCarlo(hh.BatesDynamics(),
                                              hh.EulerMaruyama(), cfg)).price)
    assert p_eu == pytest.approx(cm, rel=2e-2)
    am = _opt(105.0, hh.Put(), hh.American())
    cfg_l = hh.SimulationConfig(trajectories=1 << 14, steps=50,
                                variance_reduction=hh.Antithetic(), seed=0,
                                qmc=True)
    p_am = float(hh.solve(hh.PricingProblem(am, _market()),
                          hh.LSM(hh.MonteCarlo(hh.BatesDynamics(),
                                               hh.EulerMaruyama(), cfg_l), 4)).price)
    p_eu_put = float(hh.solve(
        hh.PricingProblem(_opt(105.0, hh.Put()), _market()), _cm()).price)
    assert p_am > p_eu_put
    asian = hh.AsianOption(100.0, EXPIRY, 8, hh.European(), hh.Call(),
                           hh.Spot(), hh.ArithmeticAverage())
    cfg8 = hh.SimulationConfig(trajectories=1 << 15, steps=8,
                               variance_reduction=hh.Antithetic(), seed=0,
                               qmc=True)
    p_as = float(hh.solve(hh.PricingProblem(asian, _market()),
                          hh.MonteCarlo(hh.BatesDynamics(),
                                        hh.EulerMaruyama(), cfg8)).price)
    assert 0.0 < p_as < cm


def test_dividend_identity_and_guards():
    m_q = _market(dividend_yield=0.03)
    m_0 = hh.BatesInputs(REF, 0.05, 100.0 * math.exp(-0.03), 0.04, 2.0, 0.04,
                         0.3, -0.7, 0.5, -0.1, 0.15)
    pq = float(hh.solve(hh.PricingProblem(_opt(), m_q), _cm()).price)
    p0 = float(hh.solve(hh.PricingProblem(_opt(), m_0), _cm()).price)
    assert pq == pytest.approx(p0, abs=1e-9)
    cfg = hh.SimulationConfig(trajectories=256, steps=2, seed=0)
    with pytest.raises(TypeError, match="HestonQE\\(conditional=True\\)"):
        hh.solve(hh.PricingProblem(_opt(), _market()),
                 hh.MonteCarlo(hh.BatesDynamics(), hh.HestonExactMixing(), cfg))
