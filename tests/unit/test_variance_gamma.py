"""Variance Gamma family (Madan-Carr-Chang 1998) — beyond-reference
model family: pure-jump infinite-activity Lévy dynamics via gamma
subordination (models/dynamics.py::VarianceGammaDynamics).

Pins: both Carr-Madan engines agree; exact terminal MC (PRNG gamma and the
Sobol' quantile path) and per-step-exact grids agree with the CF route;
θ < 0 prices the put skew; AD greeks in (σ, ν, θ) through the smooth CF;
the boosting identity keeps fine-grid QMC sane (the raw saddlepoint
quantile at shape 0.08 was −77% price); martingale-margin guard.
"""

import datetime as dt
import math

import jax
import pytest

import hedgehog_tpu as hh

REF = dt.date(2024, 1, 1)
EXPIRY = dt.date(2024, 12, 31)


def _market(**kw):
    kw.setdefault("nu", 0.25)
    kw.setdefault("theta", -0.14)
    return hh.VarianceGammaInputs(REF, 0.05, 100.0, 0.18, **kw)


def _opt(strike=100.0, cp=None, style=None):
    return hh.VanillaOption(strike, EXPIRY, style or hh.European(),
                            cp or hh.Call(), hh.Spot())


def _cm(**kw):
    return hh.CarrMadan(1.0, "auto", hh.VarianceGammaDynamics(), **kw)


def test_cm_engines_agree():
    prob = hh.PricingProblem(_opt(), _market())
    pc = float(hh.solve(prob, _cm(engine="complex")).price)
    pp = float(hh.solve(prob, _cm(engine="pair")).price)
    assert pc == pytest.approx(pp, abs=1e-7)


def test_mc_exact_and_grids_vs_cf():
    prob = hh.PricingProblem(_opt(), _market())
    cm = float(hh.solve(prob, _cm()).price)
    # exact terminal: PRNG gamma draws and the Sobol' quantile path
    cfg_p = hh.SimulationConfig(trajectories=1 << 17, steps=1,
                                variance_reduction=hh.Antithetic(), seed=0)
    pe = float(hh.solve(prob, hh.MonteCarlo(hh.VarianceGammaDynamics(),
                                            hh.VarianceGammaExact(), cfg_p)).price)
    assert pe == pytest.approx(cm, rel=1e-2)
    cfg_q = hh.SimulationConfig(trajectories=1 << 16, steps=1,
                                variance_reduction=hh.Antithetic(), seed=0,
                                qmc=True)
    pq = float(hh.solve(prob, hh.MonteCarlo(hh.VarianceGammaDynamics(),
                                            hh.VarianceGammaExact(), cfg_q)).price)
    assert pq == pytest.approx(cm, rel=2e-3)
    # per-step-exact grid (shape dt/ν = 1 at 4 steps)
    cfg_g = hh.SimulationConfig(trajectories=1 << 16, steps=4,
                                variance_reduction=hh.Antithetic(), seed=0,
                                qmc=True)
    pg = float(hh.solve(prob, hh.MonteCarlo(hh.VarianceGammaDynamics(),
                                            hh.EulerMaruyama(), cfg_g)).price)
    assert pg == pytest.approx(cm, rel=3e-3)


@pytest.mark.slow
def test_fine_grid_boosting_identity():
    """50 steps → per-step shape α = 0.08: the boosted Sobol' draw
    G_α = G_{α+1}·U^{1/α} stays within ~30bp (measured −29bp) where the
    raw saddlepoint quantile was −77% price."""
    prob = hh.PricingProblem(_opt(), _market())
    cm = float(hh.solve(prob, _cm()).price)
    cfg = hh.SimulationConfig(trajectories=1 << 16, steps=50,
                              variance_reduction=hh.Antithetic(), seed=0,
                              qmc=True)
    p = float(hh.solve(prob, hh.MonteCarlo(hh.VarianceGammaDynamics(),
                                           hh.EulerMaruyama(), cfg)).price)
    assert p == pytest.approx(cm, rel=8e-3)


def test_theta_prices_the_skew():
    put = _opt(90.0, hh.Put())
    p_neg = float(hh.solve(hh.PricingProblem(put, _market(theta=-0.14)), _cm()).price)
    p_pos = float(hh.solve(hh.PricingProblem(put, _market(theta=0.14)), _cm()).price)
    assert p_neg > p_pos + 0.3


def test_cf_greeks_flow():
    def price(sig, nu_, th):
        m = hh.VarianceGammaInputs(REF, 0.05, 100.0, sig, nu_, th)
        return hh.solve(hh.PricingProblem(_opt(), m), _cm()).price

    args = (0.18, 0.25, -0.14)
    grads = jax.grad(price, argnums=(0, 1, 2))(*args)
    for i, g in enumerate(grads):
        h = 1e-5
        up_args = list(args); up_args[i] += h
        dn_args = list(args); dn_args[i] -= h
        fd = (float(price(*up_args)) - float(price(*dn_args))) / (2 * h)
        assert float(g) == pytest.approx(fd, rel=1e-4)


@pytest.mark.slow
def test_american_and_asian_on_the_vg_grid():
    m = _market()
    cfg = hh.SimulationConfig(trajectories=1 << 14, steps=48,
                              variance_reduction=hh.Antithetic(), seed=0,
                              qmc=True)
    mc = hh.MonteCarlo(hh.VarianceGammaDynamics(), hh.EulerMaruyama(), cfg)
    am = float(hh.solve(hh.PricingProblem(_opt(105.0, hh.Put(), hh.American()), m),
                        hh.LSM(mc, 4)).price)
    eu = float(hh.solve(hh.PricingProblem(_opt(105.0, hh.Put()), m), _cm()).price)
    assert am > eu
    cfg8 = hh.SimulationConfig(trajectories=1 << 15, steps=8,
                               variance_reduction=hh.Antithetic(), seed=0,
                               qmc=True)
    asian = hh.AsianOption(100.0, EXPIRY, 8, hh.European(), hh.Call(),
                           hh.Spot(), hh.ArithmeticAverage())
    vanilla = float(hh.solve(hh.PricingProblem(_opt(), m), _cm()).price)
    p_as = float(hh.solve(hh.PricingProblem(asian, m),
                          hh.MonteCarlo(hh.VarianceGammaDynamics(),
                                        hh.EulerMaruyama(), cfg8)).price)
    assert 0.0 < p_as < vanilla


def test_dividend_identity_and_guard():
    m_q = _market(dividend_yield=0.03)
    m_0 = hh.VarianceGammaInputs(REF, 0.05, 100.0 * math.exp(-0.03), 0.18,
                                 0.25, -0.14)
    vo = _opt()
    pq = float(hh.solve(hh.PricingProblem(vo, m_q), _cm()).price)
    p0 = float(hh.solve(hh.PricingProblem(vo, m_0), _cm()).price)
    assert pq == pytest.approx(p0, abs=1e-9)
    with pytest.raises(ValueError, match="finite forward"):
        hh.VarianceGammaInputs(REF, 0.05, 100.0, 0.5, 2.0, 0.5)
