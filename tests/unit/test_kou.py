"""Kou (2002) double-exponential jump-diffusion family — beyond-reference
model family (models/dynamics.py::KouJumpDynamics, KouInputs).

Pins: both Carr-Madan engines agree to 1e-8; the λ = 0 corner equals
Black-Scholes exactly; exact and per-step-exact grid MC agree with the CF
route; the asymmetry direction (more down-jumps → richer OTM puts); AD
greeks in the jump parameters via the smooth CF; grid composability
(American LSM, Asians); dividend identity; calibration round-trip.
"""

import datetime as dt
import math

import jax
import jax.numpy as jnp
import pytest

import hedgehog_tpu as hh

REF = dt.date(2024, 1, 1)
EXPIRY = dt.date(2024, 12, 31)


def _market(**kw):
    kw.setdefault("jump_intensity", 1.0)
    kw.setdefault("p_up", 0.4)
    kw.setdefault("eta_up", 10.0)
    kw.setdefault("eta_down", 5.0)
    return hh.KouInputs(REF, 0.05, 100.0, 0.16, **kw)


def _opt(strike=100.0, cp=None, style=None):
    return hh.VanillaOption(strike, EXPIRY, style or hh.European(),
                            cp or hh.Call(), hh.Spot())


def _cm(**kw):
    return hh.CarrMadan(1.0, "auto", hh.KouJumpDynamics(), **kw)


def test_cm_engines_agree_and_bs_corner():
    prob = hh.PricingProblem(_opt(), _market())
    pc = float(hh.solve(prob, _cm(engine="complex")).price)
    pp = float(hh.solve(prob, _cm(engine="pair")).price)
    assert pc == pytest.approx(pp, abs=1e-8)
    bs = float(hh.solve(
        hh.PricingProblem(_opt(), hh.BlackScholesInputs(REF, 0.05, 100.0, 0.16)),
        hh.BlackScholesAnalytic()).price)
    p0 = float(hh.solve(
        hh.PricingProblem(_opt(), _market(jump_intensity=0.0)), _cm()).price)
    assert p0 == pytest.approx(bs, abs=1e-6)
    assert pc > bs  # jumps add convexity value


def test_mc_exact_and_grid_vs_cf():
    """The exact terminal sampler and the per-step-exact grid agree with
    Carr-Madan on the Kou CF (grid increments are iid compound-Poisson →
    terminal exact at any step count)."""
    prob = hh.PricingProblem(_opt(), _market())
    cm = float(hh.solve(prob, _cm()).price)
    cfg = hh.SimulationConfig(trajectories=1 << 16, steps=4,
                              variance_reduction=hh.Antithetic(), seed=0,
                              qmc=True)
    pe = float(hh.solve(prob, hh.MonteCarlo(hh.KouJumpDynamics(),
                                            hh.KouExact(), cfg)).price)
    pg = float(hh.solve(prob, hh.MonteCarlo(hh.KouJumpDynamics(),
                                            hh.EulerMaruyama(), cfg)).price)
    assert pe == pytest.approx(cm, rel=5e-3)
    assert pg == pytest.approx(cm, rel=5e-3)
    # PRNG stream too
    cfg_p = hh.SimulationConfig(trajectories=1 << 17, steps=1,
                                variance_reduction=hh.Antithetic(), seed=0)
    pp = float(hh.solve(prob, hh.MonteCarlo(hh.KouJumpDynamics(),
                                            hh.KouExact(), cfg_p)).price)
    assert pp == pytest.approx(cm, rel=1.5e-2)


def test_digitals_via_gil_pelaez():
    dg = hh.DigitalOption(100.0, EXPIRY, hh.European(), hh.Call(), hh.Spot())
    cm = float(hh.solve(hh.PricingProblem(dg, _market()), _cm()).price)
    cfg = hh.SimulationConfig(trajectories=1 << 16, steps=1,
                              variance_reduction=hh.Antithetic(), seed=0,
                              qmc=True)
    mc = float(hh.solve(hh.PricingProblem(dg, _market()),
                        hh.MonteCarlo(hh.KouJumpDynamics(), hh.KouExact(), cfg)).price)
    assert mc == pytest.approx(cm, rel=1e-2)


def test_asymmetry_prices_the_skew():
    """More downward jump probability must make OTM puts richer."""
    put = _opt(90.0, hh.Put())
    p_dn = float(hh.solve(hh.PricingProblem(put, _market(p_up=0.2)), _cm()).price)
    p_up = float(hh.solve(hh.PricingProblem(put, _market(p_up=0.8)), _cm()).price)
    assert p_dn > p_up + 0.5


def test_cf_greeks_flow_in_jump_parameters():
    """The CF is smooth in all five (σ, λ, p, η₁, η₂) — AD gradients flow
    and match central FD at 1e-5 relative."""
    def price(lam, p, e1, e2):
        m = hh.KouInputs(REF, 0.05, 100.0, 0.16, lam, p, e1, e2)
        return hh.solve(hh.PricingProblem(_opt(), m), _cm()).price

    args = (1.0, 0.4, 10.0, 5.0)
    grads = jax.grad(price, argnums=(0, 1, 2, 3))(*args)
    for i, g in enumerate(grads):
        bumped = list(args)
        h = 1e-4 * max(1.0, abs(args[i]))
        bumped[i] = args[i] + h
        up = float(price(*bumped))
        bumped[i] = args[i] - h
        dn = float(price(*bumped))
        assert float(g) == pytest.approx((up - dn) / (2 * h), rel=1e-4)


@pytest.mark.slow
def test_american_and_asian_on_the_kou_grid():
    m = _market()
    cfg = hh.SimulationConfig(trajectories=1 << 14, steps=50,
                              variance_reduction=hh.Antithetic(), seed=0,
                              qmc=True)
    mc = hh.MonteCarlo(hh.KouJumpDynamics(), hh.EulerMaruyama(), cfg)
    am = float(hh.solve(hh.PricingProblem(_opt(105.0, hh.Put(), hh.American()), m),
                        hh.LSM(mc, 4)).price)
    eu = float(hh.solve(hh.PricingProblem(_opt(105.0, hh.Put()), m), _cm()).price)
    assert am > eu  # early exercise priced
    cfg8 = hh.SimulationConfig(trajectories=1 << 15, steps=8,
                               variance_reduction=hh.Antithetic(), seed=0,
                               qmc=True)
    asian = hh.AsianOption(100.0, EXPIRY, 8, hh.European(), hh.Call(),
                           hh.Spot(), hh.ArithmeticAverage())
    vanilla = float(hh.solve(hh.PricingProblem(_opt(), m), _cm()).price)
    p_as = float(hh.solve(hh.PricingProblem(asian, m),
                          hh.MonteCarlo(hh.KouJumpDynamics(), hh.EulerMaruyama(),
                                        cfg8)).price)
    assert 0.0 < p_as < vanilla


def test_dividend_identity():
    m_q = _market(dividend_yield=0.03)
    m_0 = hh.KouInputs(REF, 0.05, 100.0 * math.exp(-0.03), 0.16, 1.0, 0.4,
                       10.0, 5.0)
    pq = float(hh.solve(hh.PricingProblem(_opt(), m_q), _cm()).price)
    p0 = float(hh.solve(hh.PricingProblem(_opt(), m_0), _cm()).price)
    assert pq == pytest.approx(p0, abs=1e-10)


@pytest.mark.slow
def test_calibration_recovers_jump_parameters():
    """CM + lenses recover (λ, p, η₁, η₂) from a 7-strike smile (σ known —
    the diffusion/jump split is the classically ill-posed direction)."""
    true_m = _market(jump_intensity=1.2, p_up=0.35, eta_up=12.0, eta_down=6.0)
    strikes = (80.0, 90.0, 95.0, 100.0, 105.0, 110.0, 120.0)
    payoffs = [_opt(k) for k in strikes]
    quotes = jnp.asarray([
        float(hh.solve(hh.PricingProblem(p, true_m), _cm()).price)
        for p in payoffs
    ])
    guess = _market(jump_intensity=0.8, p_up=0.5, eta_up=9.0, eta_down=4.0)
    calib = hh.CalibrationProblem(
        hh.BasketPricingProblem(payoffs, guess), quotes,
        jnp.asarray([0.8, 0.5, 9.0, 4.0]),
        pricing_method=_cm(),
        accessors=(hh.FieldLens("market_inputs.jump_intensity"),
                   hh.FieldLens("market_inputs.p_up"),
                   hh.FieldLens("market_inputs.eta_up"),
                   hh.FieldLens("market_inputs.eta_down")),
    )
    sol = hh.solve(calib, hh.OptimizerAlgo(max_iters=400),
                   lb=jnp.asarray([0.1, 0.05, 2.0, 1.5]),
                   ub=jnp.asarray([5.0, 0.95, 30.0, 20.0]))
    assert bool(sol.converged)
    lam, p, e1, e2 = (float(x) for x in sol.u)
    assert lam == pytest.approx(1.2, rel=1e-1)
    assert p == pytest.approx(0.35, rel=1e-1)
    assert e1 == pytest.approx(12.0, rel=2e-1)
    assert e2 == pytest.approx(6.0, rel=2e-1)


def test_guards():
    with pytest.raises(ValueError, match="eta_up must exceed 1"):
        hh.KouInputs(REF, 0.05, 100.0, 0.16, 1.0, 0.4, 0.9, 5.0)
    # barrier grids reject jump dynamics (no Brownian-bridge correction)
    doc = hh.BarrierOption(100.0, EXPIRY, 80.0)
    with pytest.raises(TypeError, match="barrier grids need"):
        hh.solve(hh.PricingProblem(doc, _market()),
                 hh.MonteCarlo(hh.KouJumpDynamics(), hh.EulerMaruyama(),
                               hh.SimulationConfig(trajectories=256, steps=4, seed=0)))
