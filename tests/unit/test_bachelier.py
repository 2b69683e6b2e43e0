"""Bachelier (normal) model family — methods/bachelier.py.

Beyond-reference model family: closed forms on the T-forward, exact and
Euler MC (the Euler increments ARE exact arithmetic-BM transitions), normal
implied vol with IFT gradients, grid composability (Asians, American LSM),
AD greeks.  The r = 0 American-put = European-put identity and the ATM
σ√T·φ(0) value pin the numerics exactly.
"""

import datetime as dt
import math

import jax
import jax.numpy as jnp
import pytest

import hedgehog_tpu as hh

REF = dt.date(2024, 1, 1)
EXPIRY = dt.date(2024, 12, 31)  # T = 1 under ACT/365
R, SPOT, SIGMA_N = 0.05, 100.0, 20.0
D = math.exp(-R)
F = SPOT / D


def _market(rate=R, sigma=SIGMA_N):
    return hh.BachelierInputs(REF, rate, SPOT, sigma)


def _opt(strike=95.0, cp=None, style=None):
    return hh.VanillaOption(strike, EXPIRY, style or hh.European(),
                            cp or hh.Call(), hh.Spot())


def _cfg(paths=1 << 15, steps=4):
    return hh.SimulationConfig(trajectories=paths, steps=steps,
                               variance_reduction=hh.Antithetic(), seed=0,
                               qmc=True)


def test_atm_closed_form():
    """ATM (K = F): price = D·σ_N√T·φ(0) exactly."""
    p = float(hh.solve(hh.PricingProblem(_opt(F), _market()),
                       hh.BachelierAnalytic()).price)
    assert p == pytest.approx(D * SIGMA_N / math.sqrt(2 * math.pi), abs=1e-12)


def test_put_call_parity():
    c = float(hh.solve(hh.PricingProblem(_opt(95.0), _market()),
                       hh.BachelierAnalytic()).price)
    p = float(hh.solve(hh.PricingProblem(_opt(95.0, hh.Put()), _market()),
                       hh.BachelierAnalytic()).price)
    assert c - p == pytest.approx(D * (F - 95.0), abs=1e-12)


def test_zero_vol_is_discounted_intrinsic():
    p = float(hh.solve(hh.PricingProblem(_opt(95.0), _market(sigma=0.0)),
                       hh.BachelierAnalytic()).price)
    assert p == pytest.approx(D * (F - 95.0), abs=1e-12)


def test_negative_forward_prices():
    """The point of the normal model: a negative underlying still prices
    (lognormal machinery would NaN)."""
    m = hh.BachelierInputs(REF, 0.0, -5.0, 10.0)  # negative spot (e.g. WTI 2020)
    c = float(hh.solve(hh.PricingProblem(_opt(0.0), m),
                       hh.BachelierAnalytic()).price)
    p = float(hh.solve(hh.PricingProblem(_opt(0.0, hh.Put()), m),
                       hh.BachelierAnalytic()).price)
    assert math.isfinite(c) and c > 0.0
    assert p - c == pytest.approx(5.0, abs=1e-12)  # parity at F = −5


def test_digital_closed_form():
    d = (F - 95.0) / SIGMA_N
    dg = hh.DigitalOption(95.0, EXPIRY, hh.European(), hh.Call(), hh.Spot(),
                          cash=1.0)
    p = float(hh.solve(hh.PricingProblem(dg, _market()),
                       hh.BachelierAnalytic()).price)
    assert p == pytest.approx(D * 0.5 * (1 + math.erf(d / math.sqrt(2))),
                              abs=1e-12)


def test_implied_normal_vol_roundtrip_and_ift_gradient():
    c = float(hh.solve(hh.PricingProblem(_opt(95.0), _market()),
                       hh.BachelierAnalytic()).price)
    iv = float(hh.implied_normal_vol(c, F, 95.0, 1.0, D, 1.0))
    assert iv == pytest.approx(SIGMA_N, abs=1e-8)
    # dσ/dprice = 1/vega with vega = D√T·φ(d)
    g = float(jax.grad(
        lambda pr: hh.implied_normal_vol(pr, F, 95.0, 1.0, D, 1.0))(jnp.float64(c)))
    d = (F - 95.0) / SIGMA_N
    vega = D * math.exp(-0.5 * d * d) / math.sqrt(2 * math.pi)
    assert g == pytest.approx(1.0 / vega, rel=1e-6)


def test_mc_exact_and_euler_match_analytic():
    prob = hh.PricingProblem(_opt(95.0), _market())
    ana = float(hh.solve(prob, hh.BachelierAnalytic()).price)
    pe = float(hh.solve(prob, hh.MonteCarlo(hh.NormalDynamics(),
                                            hh.BachelierExact(), _cfg())).price)
    pu = float(hh.solve(prob, hh.MonteCarlo(hh.NormalDynamics(),
                                            hh.EulerMaruyama(), _cfg())).price)
    assert pe == pytest.approx(ana, rel=3e-3)
    # Euler increments are exact, and the bridge-ordered Sobol' terminal
    # dimension makes the 4-step grid's terminal draw IDENTICAL to the
    # one-shot exact sampler's
    assert pu == pytest.approx(pe, rel=1e-12)


def test_ad_delta_and_vega_match_closed_forms():
    d = (F - 95.0) / SIGMA_N

    def price(spot, sigma):
        m = hh.BachelierInputs(REF, R, spot, sigma)
        return hh.solve(hh.PricingProblem(_opt(95.0), m),
                        hh.BachelierAnalytic()).price

    delta = float(jax.grad(price, 0)(jnp.float64(SPOT), jnp.float64(SIGMA_N)))
    vega = float(jax.grad(price, 1)(jnp.float64(SPOT), jnp.float64(SIGMA_N)))
    # delta = D·Φ(d)·dF/dS = Φ(d); vega_N = D·√T·φ(d)
    assert delta == pytest.approx(0.5 * (1 + math.erf(d / math.sqrt(2))),
                                  rel=1e-10)
    assert vega == pytest.approx(D * math.exp(-0.5 * d * d)
                                 / math.sqrt(2 * math.pi), rel=1e-10)


def test_asian_under_bachelier():
    asian = hh.AsianOption(95.0, EXPIRY, 4, hh.European(), hh.Call(),
                           hh.Spot(), hh.ArithmeticAverage())
    c = float(hh.solve(hh.PricingProblem(_opt(95.0), _market()),
                       hh.BachelierAnalytic()).price)
    pas = float(hh.solve(
        hh.PricingProblem(asian, _market()),
        hh.MonteCarlo(hh.NormalDynamics(), hh.EulerMaruyama(), _cfg())).price)
    assert 0.0 < pas < c  # averaging reduces optionality
    geo = hh.AsianOption(95.0, EXPIRY, 4, hh.European(), hh.Call(),
                         hh.Spot(), hh.GeometricAverage())
    with pytest.raises(TypeError, match="geometric averaging is undefined"):
        hh.solve(hh.PricingProblem(geo, _market()),
                 hh.MonteCarlo(hh.NormalDynamics(), hh.EulerMaruyama(), _cfg()))


@pytest.mark.slow
def test_american_lsm_r0_equals_european():
    """At r = 0 the spot is a martingale and cash earns nothing, so early
    exercise has no value: American put = European put (both call and put)."""
    m0 = _market(rate=0.0)
    am = hh.VanillaOption(100.0, EXPIRY, hh.American(), hh.Put(), hh.Spot())
    cfg = hh.SimulationConfig(trajectories=1 << 14, steps=50,
                              variance_reduction=hh.Antithetic(), seed=0,
                              qmc=True)
    pl = float(hh.solve(
        hh.PricingProblem(am, m0),
        hh.LSM(hh.MonteCarlo(hh.NormalDynamics(), hh.EulerMaruyama(), cfg), 4)).price)
    pe = float(hh.solve(hh.PricingProblem(_opt(100.0, hh.Put()), m0),
                        hh.BachelierAnalytic()).price)
    assert pl == pytest.approx(pe, rel=2e-2)


@pytest.mark.slow
def test_american_lsm_positive_rates_put_premium():
    """r > 0: the American put on the Bachelier grid carries a genuine
    early-exercise premium over the European closed form."""
    am = hh.VanillaOption(115.0, EXPIRY, hh.American(), hh.Put(), hh.Spot())
    cfg = hh.SimulationConfig(trajectories=1 << 14, steps=50,
                              variance_reduction=hh.Antithetic(), seed=0,
                              qmc=True)
    pl = float(hh.solve(
        hh.PricingProblem(am, _market()),
        hh.LSM(hh.MonteCarlo(hh.NormalDynamics(), hh.EulerMaruyama(), cfg), 4)).price)
    pe = float(hh.solve(hh.PricingProblem(_opt(115.0, hh.Put()), _market()),
                        hh.BachelierAnalytic()).price)
    assert pl > pe + 0.1


def test_barrier_image_method_r0():
    """r = 0 Bachelier down-and-out call has the EXACT image-method price
    DOC = C(F₀) − C(2H − F₀) (reflection of driftless BM at the barrier) —
    pins the price-space bridge factors (measured −1.6bp at 2^16 QMC
    pairs × 32 steps)."""
    m0 = _market(rate=0.0)
    H, K = 85.0, 90.0
    doc = hh.BarrierOption(K, EXPIRY, H, hh.European(), hh.Call(), hh.Spot(),
                           hh.Down(), hh.KnockOut())
    cfg = hh.SimulationConfig(trajectories=1 << 16, steps=32,
                              variance_reduction=hh.Antithetic(), seed=0,
                              qmc=True)
    p_mc = float(hh.solve(hh.PricingProblem(doc, m0),
                          hh.MonteCarlo(hh.NormalDynamics(),
                                        hh.EulerMaruyama(), cfg)).price)
    c = float(hh.solve(hh.PricingProblem(_opt(K), m0),
                       hh.BachelierAnalytic()).price)
    m_img = hh.BachelierInputs(REF, 0.0, 2 * H - SPOT, SIGMA_N)
    c_img = float(hh.solve(hh.PricingProblem(_opt(K), m_img),
                           hh.BachelierAnalytic()).price)
    assert p_mc == pytest.approx(c - c_img, rel=2e-3)


@pytest.mark.slow
def test_barrier_refinement_consistency_with_rates():
    """r ≠ 0 maps the barrier to the per-segment-linear boundary H/c(t);
    the residual within-segment curvature is O((rΔt)²) — 8 vs 64 steps must
    agree to ~1bp (measured 0.9bp)."""
    doc = hh.BarrierOption(90.0, EXPIRY, 85.0, hh.European(), hh.Call(),
                           hh.Spot(), hh.Down(), hh.KnockOut())
    prices = []
    for steps in (8, 64):
        cfg = hh.SimulationConfig(trajectories=1 << 16, steps=steps,
                                  variance_reduction=hh.Antithetic(), seed=0,
                                  qmc=True)
        prices.append(float(hh.solve(
            hh.PricingProblem(doc, _market()),
            hh.MonteCarlo(hh.NormalDynamics(), hh.EulerMaruyama(), cfg)).price))
    assert prices[0] == pytest.approx(prices[1], rel=1e-3)


@pytest.mark.slow
def test_american_barrier_ordering():
    """American KO under Bachelier via barrier LSM: within
    [European KO, American vanilla]."""
    am = hh.BarrierOption(110.0, EXPIRY, 80.0, hh.American(), hh.Put(),
                          hh.Spot(), hh.Down(), hh.KnockOut())
    eu = hh.BarrierOption(110.0, EXPIRY, 80.0, hh.European(), hh.Put(),
                          hh.Spot(), hh.Down(), hh.KnockOut())
    van = hh.VanillaOption(110.0, EXPIRY, hh.American(), hh.Put(), hh.Spot())
    cfg = hh.SimulationConfig(trajectories=1 << 14, steps=50,
                              variance_reduction=hh.Antithetic(), seed=0,
                              qmc=True)
    mc = hh.MonteCarlo(hh.NormalDynamics(), hh.EulerMaruyama(), cfg)
    p_am = float(hh.solve(hh.PricingProblem(am, _market()), hh.LSM(mc, 4)).price)
    p_eu = float(hh.solve(hh.PricingProblem(eu, _market()), mc).price)
    p_van = float(hh.solve(hh.PricingProblem(van, _market()), hh.LSM(mc, 4)).price)
    assert p_eu - 0.05 <= p_am <= p_van + 0.05
    assert p_am > p_eu + 1.0


def test_guards():
    with pytest.raises(TypeError, match="European-only"):
        hh.solve(hh.PricingProblem(
            hh.VanillaOption(95.0, EXPIRY, hh.American(), hh.Put(), hh.Spot()),
            _market()), hh.BachelierAnalytic())
    with pytest.raises(TypeError, match="normal-model closed form"):
        hh.solve(hh.PricingProblem(
            hh.BarrierOption(95.0, EXPIRY, 80.0), _market()), hh.BachelierAnalytic())


def test_calibration_recovers_sigma():
    """Lens-driven calibration through the Bachelier pricer (the same
    machinery as BS sigma recovery, calibration.jl:7-29)."""
    true_m = _market(sigma=17.5)
    payoffs = [_opt(k) for k in (90.0, 100.0, 110.0)]
    quotes = jnp.asarray([
        float(hh.solve(hh.PricingProblem(p, true_m), hh.BachelierAnalytic()).price)
        for p in payoffs
    ])
    calib = hh.CalibrationProblem(
        hh.BasketPricingProblem(payoffs, _market(sigma=10.0)), quotes,
        jnp.asarray([10.0]),
        pricing_method=hh.BachelierAnalytic(),
        accessors=(hh.FieldLens("market_inputs.sigma"),),
    )
    sol = hh.solve(calib, hh.OptimizerAlgo(),
                   lb=jnp.asarray([1.0]), ub=jnp.asarray([50.0]))
    assert bool(sol.converged)
    assert float(sol.u[0]) == pytest.approx(17.5, abs=1e-4)
