"""Cross-method price agreement mirroring reference
test/agreement/price_agreement.jl: CRR vs BS (atol 1e-3), Carr-Madan vs BS
(atol 1e-6) — plus maturities ≠ 1 (which the reference never exercised)."""

import datetime as dt

import pytest

from hedgehog_tpu import (
    BlackScholesAnalytic,
    BlackScholesInputs,
    Call,
    CarrMadan,
    CoxRossRubinsteinMethod,
    European,
    LognormalDynamics,
    PricingProblem,
    Put,
    Spot,
    VanillaOption,
    solve,
)

REF = dt.date(2020, 1, 1)


def test_crr_vs_analytic():
    payoff = VanillaOption(1.1, dt.date(2021, 1, 1), European(), Put(), Spot())
    market = BlackScholesInputs(REF, 0.2, 1.0, 0.4)
    prob = PricingProblem(payoff, market)
    bs = float(solve(prob, BlackScholesAnalytic()).price)
    crr = float(solve(prob, CoxRossRubinsteinMethod(100)).price)
    assert crr == pytest.approx(bs, abs=1e-3)


def test_carr_madan_vs_analytic():
    market = BlackScholesInputs(REF, 0.2, 100.0, 0.4)
    payoff = VanillaOption(100.0, dt.date(2020, 12, 31), European(), Call(), Spot())
    prob = PricingProblem(payoff, market)
    cm = float(solve(prob, CarrMadan(1.0, 16.0, LognormalDynamics())).price)
    bs = float(solve(prob, BlackScholesAnalytic()).price)
    assert cm == pytest.approx(bs, abs=1e-6)


@pytest.mark.parametrize("T_days", [30, 91, 365, 730])
@pytest.mark.parametrize("cp", [Call(), Put()])
def test_carr_madan_vs_analytic_maturity_grid(T_days, cp):
    """Maturity sweep — catches the √α-vs-α drift bug the reference's T=1-only
    test could not see (montecarlo.jl:302)."""
    market = BlackScholesInputs(REF, 0.05, 100.0, 0.25)
    expiry = REF + dt.timedelta(days=T_days)
    payoff = VanillaOption(95.0, expiry, European(), cp, Spot())
    prob = PricingProblem(payoff, market)
    cm = float(solve(prob, CarrMadan(1.5, 64.0, LognormalDynamics(), nodes=512)).price)
    bs = float(solve(prob, BlackScholesAnalytic()).price)
    assert cm == pytest.approx(bs, abs=1e-6)


def test_carr_madan_pair_engine_matches_complex():
    """Split-complex ("pair") CM engine vs native complex128 — must agree
    to f64 roundoff."""
    from hedgehog_tpu import HestonDynamics, HestonInputs

    market = HestonInputs(REF, 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
    payoff = VanillaOption(100.0, dt.date(2021, 1, 1), European(), Call(), Spot())
    prob = PricingProblem(payoff, market)
    pc = float(solve(prob, CarrMadan(1.0, 32.0, HestonDynamics(), engine="complex")).price)
    pp = float(solve(prob, CarrMadan(1.0, 32.0, HestonDynamics(), engine="pair")).price)
    assert pp == pytest.approx(pc, abs=1e-12)

    bs_market = BlackScholesInputs(REF, 0.05, 100.0, 0.2)
    prob2 = PricingProblem(payoff, bs_market)
    pc2 = float(solve(prob2, CarrMadan(1.0, 16.0, LognormalDynamics(), engine="complex")).price)
    pp2 = float(solve(prob2, CarrMadan(1.0, 16.0, LognormalDynamics(), engine="pair")).price)
    assert pp2 == pytest.approx(pc2, abs=1e-12)
