"""Conditional (Romano-Touzi mixing) Monte Carlo agreement tier.

The mixing estimator (HestonQE(conditional=True)) simulates only the variance
path and finishes each path with the conditional Black-Scholes closed form —
logS_T given the V path is exactly normal via the CIR integral identity
(methods/montecarlo.py _heston_qe_mixing_values).  Beyond-reference capability
layered on the reference's MC engine semantics (montecarlo.jl:478-493:
price = df · mean(per-path values)).
"""

import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hedgehog_tpu import (
    Antithetic,
    Call,
    CarrMadan,
    European,
    HestonDynamics,
    HestonExactMixing,
    HestonInputs,
    HestonQE,
    LognormalDynamics,
    MonteCarlo,
    NoVarianceReduction,
    PricingProblem,
    Put,
    SimulationConfig,
    Spot,
    VanillaOption,
    mc_path_values,
    simulate_price_grid,
    simulate_terminal_prices,
    solve,
)

REF = dt.date(2020, 1, 1)
EXPIRY = dt.date(2021, 1, 1)
MARKET = HestonInputs(REF, 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)


def _prob(cp):
    return PricingProblem(VanillaOption(100.0, EXPIRY, European(), cp, Spot()), MARKET)


def _cm_price(prob):
    return float(solve(prob, CarrMadan(1.0, 64.0, HestonDynamics(), nodes=1024)).price)


@pytest.mark.parametrize("cp", [Call(), Put()])
def test_mixing_vs_carr_madan(cp):
    prob = _prob(cp)
    cfg = SimulationConfig(
        trajectories=40_000, steps=24, variance_reduction=Antithetic(), seed=3
    )
    sol = solve(prob, MonteCarlo(HestonDynamics(), HestonQE(conditional=True), cfg))
    cm = _cm_price(prob)
    assert float(sol.price) == pytest.approx(cm, rel=2e-2)
    # ensemble payload = per-path conditional values, (2 groups, paths)
    assert sol.ensemble.shape == (2, 40_000)


@pytest.mark.parametrize("cp", [Call(), Put()])
def test_mixing_qmc_tight(cp):
    """Sobol'-driven mixing converges far inside the plain-MC tolerance."""
    prob = _prob(cp)
    cfg = SimulationConfig(
        trajectories=40_000, steps=24, variance_reduction=Antithetic(), seed=3, qmc=True
    )
    sol = solve(prob, MonteCarlo(HestonDynamics(), HestonQE(conditional=True), cfg))
    assert float(sol.price) == pytest.approx(_cm_price(prob), rel=2e-3)


def test_mixing_variance_reduction_vs_terminal_qe():
    """Conditioning integrates the price Brownian out analytically — the
    per-path value variance must drop by a large factor (measured ~12× at
    ρ=−0.7)."""
    prob = _prob(Call())
    cfg = SimulationConfig(
        trajectories=20_000, steps=12, variance_reduction=Antithetic(), seed=11
    )
    vals_mix = mc_path_values(prob, MonteCarlo(HestonDynamics(), HestonQE(conditional=True), cfg))
    vals_qe = mc_path_values(prob, MonteCarlo(HestonDynamics(), HestonQE(), cfg))
    ratio = float(jnp.var(vals_qe) / jnp.var(vals_mix))
    assert ratio > 3.0


def test_mixing_price_matches_terminal_qe():
    prob = _prob(Call())
    cfg = SimulationConfig(
        trajectories=50_000, steps=16, variance_reduction=Antithetic(), seed=5
    )
    p_mix = solve(prob, MonteCarlo(HestonDynamics(), HestonQE(conditional=True), cfg)).price
    p_qe = solve(prob, MonteCarlo(HestonDynamics(), HestonQE(), cfg)).price
    assert float(p_mix) == pytest.approx(float(p_qe), rel=2e-2)


def test_conditional_guards():
    prob = _prob(Call())
    cfg = SimulationConfig(trajectories=64, steps=2)
    m = MonteCarlo(HestonDynamics(), HestonQE(conditional=True), cfg)
    with pytest.raises(TypeError, match="terminal samples"):
        simulate_terminal_prices(prob, m)
    # round 3: conditional strategies now HAVE a price grid (the conditional
    # lognormal bridge, simulate_conditional_grid) — the grid routes there
    grid = simulate_price_grid(prob, m)
    assert grid.shape == (1, 3, 64)
    bad = MonteCarlo(LognormalDynamics(), HestonQE(conditional=True), cfg)
    with pytest.raises(TypeError, match="conditional Monte Carlo requires"):
        solve(prob, bad)


def test_mixing_sharded_matches_unsharded_qmc():
    """Under QMC the devices take disjoint slices of ONE Sobol' sequence, so
    the sharded price must equal the unsharded price to summation order."""
    from hedgehog_tpu.parallel.sharding import make_paths_mesh, sharded_mc_price

    prob = _prob(Call())
    cfg = SimulationConfig(
        trajectories=16_384, steps=8, variance_reduction=Antithetic(), seed=7, qmc=True
    )
    method = MonteCarlo(HestonDynamics(), HestonQE(conditional=True), cfg)
    p_single = float(solve(prob, method).price)
    mesh = make_paths_mesh()
    p_sharded = float(sharded_mc_price(prob, method, mesh))
    assert p_sharded == pytest.approx(p_single, rel=1e-9)


def test_mixing_pathwise_delta_vs_carr_madan():
    """The conditional estimator is SMOOTH (no payoff kink), so the pathwise
    AD delta converges cleanly; cross-check against a Carr-Madan FD delta."""
    cfg = SimulationConfig(
        trajectories=40_000, steps=16, variance_reduction=Antithetic(), seed=9, qmc=True
    )
    method = MonteCarlo(HestonDynamics(), HestonQE(conditional=True), cfg)
    payoff = VanillaOption(100.0, EXPIRY, European(), Call(), Spot())

    def price(spot):
        market = HestonInputs(REF, 0.03, spot, 0.04, 2.0, 0.04, 0.3, -0.7)
        return solve(PricingProblem(payoff, market), method).price

    delta_ad = float(jax.grad(price)(jnp.float64(100.0)))

    def cm_price(spot):
        market = HestonInputs(REF, 0.03, spot, 0.04, 2.0, 0.04, 0.3, -0.7)
        return float(
            solve(
                PricingProblem(payoff, market),
                CarrMadan(1.0, 64.0, HestonDynamics(), nodes=1024),
            ).price
        )

    h = 0.05
    delta_fd = (cm_price(100.0 + h) - cm_price(100.0 - h)) / (2 * h)
    assert delta_ad == pytest.approx(delta_fd, rel=2e-2)


def test_mixing_strike_grid_matches_scalar_solves():
    """An array-strike payoff prices the whole grid from ONE simulated
    V-path set; per strike it must equal the scalar solve exactly (same
    seed → same paths → same conditional factors)."""
    strikes = jnp.array([80.0, 90.0, 100.0, 110.0, 125.0])
    cfg = SimulationConfig(
        trajectories=8_000, steps=12, variance_reduction=Antithetic(), seed=4
    )
    method = MonteCarlo(HestonDynamics(), HestonQE(conditional=True), cfg)
    grid_payoff = VanillaOption(strikes, EXPIRY, European(), Call(), Spot())
    sol = solve(PricingProblem(grid_payoff, MARKET), method)
    assert sol.price.shape == (5,)
    assert sol.ensemble.shape == (2, 5, 8_000)
    for i, k in enumerate(strikes):
        p_i = float(solve(_prob_k(float(k)), method).price)
        assert float(sol.price[i]) == pytest.approx(p_i, rel=1e-12)


def _prob_k(k):
    return PricingProblem(VanillaOption(k, EXPIRY, European(), Call(), Spot()), MARKET)


def test_mixing_strike_grid_vs_carr_madan_qmc():
    strikes = jnp.array([85.0, 95.0, 100.0, 105.0, 120.0])
    cfg = SimulationConfig(
        trajectories=40_000, steps=24, variance_reduction=Antithetic(), seed=6, qmc=True
    )
    method = MonteCarlo(HestonDynamics(), HestonQE(conditional=True), cfg)
    grid_payoff = VanillaOption(strikes, EXPIRY, European(), Call(), Spot())
    grid = solve(PricingProblem(grid_payoff, MARKET), method).price
    for i, k in enumerate(strikes):
        cm = _cm_price(_prob_k(float(k)))
        assert float(grid[i]) == pytest.approx(cm, rel=5e-3), float(k)


def test_mixing_strike_grid_sharded():
    from hedgehog_tpu.parallel.sharding import make_paths_mesh, sharded_mc_price

    strikes = jnp.array([90.0, 100.0, 110.0])
    cfg = SimulationConfig(
        trajectories=16_384, steps=8, variance_reduction=Antithetic(), seed=7, qmc=True
    )
    method = MonteCarlo(HestonDynamics(), HestonQE(conditional=True), cfg)
    prob = PricingProblem(VanillaOption(strikes, EXPIRY, European(), Call(), Spot()), MARKET)
    p_single = solve(prob, method).price
    p_sharded = sharded_mc_price(prob, method, make_paths_mesh())
    np.testing.assert_allclose(np.asarray(p_sharded), np.asarray(p_single), rtol=1e-9)


@pytest.mark.parametrize("antithetic", [True, False], ids=["antithetic", "plain"])
@pytest.mark.parametrize("strategy", [HestonQE(conditional=True), HestonExactMixing()],
                         ids=["qe_mixing", "exact_mixing"])
def test_mixing_strike_grid_path_values(strategy, antithetic):
    """Both mixing estimators price a strike grid from ONE V-path set:
    mc_path_values is (strikes, paths) with the path axis last, and each
    row equals the scalar-strike values of the same seed."""
    strikes = jnp.array([90.0, 100.0, 110.0])
    cfg = SimulationConfig(trajectories=256, steps=2, seed=3,
                           variance_reduction=Antithetic() if antithetic else NoVarianceReduction())
    method = MonteCarlo(HestonDynamics(), strategy, cfg)
    grid = mc_path_values(
        PricingProblem(VanillaOption(strikes, EXPIRY, European(), Call(), Spot()), MARKET), method)
    assert grid.shape == (3, 256)
    for i, k in enumerate(strikes):
        row = mc_path_values(_prob_k(float(k)), method)
        np.testing.assert_allclose(np.asarray(grid[i]), np.asarray(row), rtol=1e-12)


def test_qe_gradient_finite_in_high_psi_regime():
    """Regression: lanes with ψ ≥ 2 select the exponential branch, but the
    unselected quadratic branch's sqrt(0) used to poison reverse-mode
    gradients with NaN (double-where guard in models/heston_qe._qe_v_draw).
    V0=0.09, σ=0.6 pushes many lanes past ψ=2."""
    cfg = SimulationConfig(
        trajectories=4_000, steps=12, variance_reduction=Antithetic(), seed=0, qmc=True
    )
    payoff = VanillaOption(100.0, EXPIRY, European(), Call(), Spot())

    for strat in (HestonQE(conditional=True), HestonQE()):
        def price(params, strat=strat):
            v0, sigma = params
            market = HestonInputs(REF, 0.03, 100.0, v0, 2.0, 0.04, sigma, -0.7)
            return solve(
                PricingProblem(payoff, market),
                MonteCarlo(HestonDynamics(), strat, cfg),
            ).price

        g = jax.grad(price)(jnp.array([0.09, 0.6]))
        assert bool(jnp.all(jnp.isfinite(g))), (type(strat).__name__, g)


def test_mixing_mc_calibration_recovery():
    """Differentiable calibration THROUGH the Monte Carlo pricer: recover
    (V0, σ) from Carr-Madan quotes by L-BFGS on the QMC mixing strike-grid
    price — the gradient is the pathwise derivative of the smooth
    conditional estimator (no Fourier pricer in the loop)."""
    from hedgehog_tpu.math.optimize import minimize_lbfgs

    strikes = jnp.array([85.0, 95.0, 100.0, 105.0, 120.0])
    quotes = jnp.array([_cm_price(_prob_k(float(k))) for k in strikes])
    cfg = SimulationConfig(
        trajectories=20_000, steps=12, variance_reduction=Antithetic(), seed=0, qmc=True
    )
    mc = MonteCarlo(HestonDynamics(), HestonQE(conditional=True), cfg)
    grid_payoff = VanillaOption(strikes, EXPIRY, European(), Call(), Spot())

    def objective(params):
        v0, sigma = params
        market = HestonInputs(REF, 0.03, 100.0, v0, 2.0, 0.04, sigma, -0.7)
        prices = solve(PricingProblem(grid_payoff, market), mc).price
        return jnp.sum((prices - quotes) ** 2)

    res = minimize_lbfgs(
        objective, jnp.array([0.09, 0.6]),
        jnp.array([1e-3, 0.05]), jnp.array([0.5, 1.5]), max_iters=80,
    )
    assert bool(res.converged)
    assert float(res.x[0]) == pytest.approx(0.04, rel=5e-2)
    assert float(res.x[1]) == pytest.approx(0.30, rel=5e-2)


def test_heston_surface_mc_vs_carr_madan():
    """One V-path simulation prices a whole (expiry × strike) surface:
    every point must match Carr-Madan, and the surface must satisfy basic
    no-arbitrage shape (calls decreasing in K, increasing in T)."""
    from hedgehog_tpu import CarrMadan, heston_surface_mc

    expiries = [dt.date(2020, 7, 1), dt.date(2021, 1, 1), dt.date(2022, 1, 1)]
    strikes = jnp.array([85.0, 95.0, 100.0, 105.0, 120.0])
    cfg = SimulationConfig(
        trajectories=40_000, steps=32, variance_reduction=Antithetic(), seed=1, qmc=True
    )
    surf = heston_surface_mc(MARKET, expiries, strikes, cfg)
    assert surf.shape == (3, 5)
    for i, e in enumerate(expiries):
        for jx, k in enumerate(strikes):
            p = VanillaOption(float(k), e, European(), Call(), Spot())
            cm = float(
                solve(PricingProblem(p, MARKET), CarrMadan(1.0, "auto", HestonDynamics())).price
            )
            assert float(surf[i, jx]) == pytest.approx(cm, rel=5e-3), (e, float(k))
    assert bool(jnp.all(jnp.diff(surf, axis=1) < 0))  # decreasing in strike
    assert bool(jnp.all(jnp.diff(surf, axis=0) > 0))  # increasing in expiry


def test_sharded_surface_matches_unsharded_qmc():
    """QMC devices slice ONE Sobol' sequence disjointly — the sharded
    surface equals the unsharded one to summation order."""
    from hedgehog_tpu import heston_surface_mc
    from hedgehog_tpu.parallel.sharding import make_paths_mesh, sharded_surface_fn

    expiries = [dt.date(2020, 7, 1), dt.date(2021, 1, 1)]
    strikes = jnp.array([90.0, 100.0, 110.0])
    cfg = SimulationConfig(
        trajectories=16_384, steps=12, variance_reduction=Antithetic(), seed=3, qmc=True
    )
    method = MonteCarlo(HestonDynamics(), HestonQE(conditional=True), cfg)
    single = heston_surface_mc(MARKET, expiries, strikes, cfg)
    surface = sharded_surface_fn(method, make_paths_mesh())
    sharded = surface(MARKET, expiries, strikes)
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(single), rtol=1e-9)


def test_heston_surface_mc_validation_and_grad():
    from hedgehog_tpu import heston_surface_mc

    cfg = SimulationConfig(trajectories=2_000, steps=8, seed=0)
    strikes = jnp.array([95.0, 105.0])
    with pytest.raises(ValueError, match="strictly increasing"):
        heston_surface_mc(MARKET, [dt.date(2021, 1, 1), dt.date(2020, 7, 1)], strikes, cfg)
    with pytest.raises(ValueError, match="strictly increasing"):
        heston_surface_mc(MARKET, [REF], strikes, cfg)

    expiries = [dt.date(2020, 7, 1), dt.date(2021, 1, 1)]

    def loss(params):
        v0, sigma = params
        m = HestonInputs(REF, 0.03, 100.0, v0, 2.0, 0.04, sigma, -0.7)
        return jnp.sum(heston_surface_mc(m, expiries, strikes, cfg) ** 2)

    g = jax.grad(loss)(jnp.array([0.04, 0.3]))
    assert bool(jnp.all(jnp.isfinite(g)))


def test_conditional_basket_fast_path():
    """solve(BasketPricingProblem, MonteCarlo(conditional)) prices every
    vanilla (mixed calls/puts, mixed expiries) from ONE simulation; each
    price must match Carr-Madan, and non-qualifying baskets fall back to
    the generic per-payoff loop."""
    from hedgehog_tpu import BasketPricingProblem, CarrMadan

    payoffs = []
    for e in (dt.date(2020, 7, 1), EXPIRY):
        for k, cp in ((90.0, Call()), (100.0, Put()), (110.0, Call())):
            payoffs.append(VanillaOption(k, e, European(), cp, Spot()))
    basket = BasketPricingProblem(tuple(payoffs), MARKET)
    cfg = SimulationConfig(
        trajectories=40_000, steps=24, variance_reduction=Antithetic(), seed=3, qmc=True
    )
    method = MonteCarlo(HestonDynamics(), HestonQE(conditional=True), cfg)
    sol = solve(basket, method)
    assert len(sol.solutions) == 6
    for p, s in zip(payoffs, sol.solutions):
        cm = float(
            solve(PricingProblem(p, MARKET), CarrMadan(1.0, "auto", HestonDynamics())).price
        )
        assert float(s.price) == pytest.approx(cm, rel=8e-3), float(p.strike)

    # non-conditional method → generic loop still used and works
    s2 = solve(BasketPricingProblem((payoffs[0],), MARKET),
               MonteCarlo(HestonDynamics(), HestonQE(), cfg))
    assert jnp.isfinite(s2.solutions[0].price)


def test_calibration_through_conditional_mc_public_api():
    """CalibrationProblem + OptimizerAlgo with the conditional MC method:
    the reference-parity public API calibrates THROUGH the Monte Carlo
    pricer (basket fast path: one simulation per objective evaluation)."""
    from hedgehog_tpu import (
        BasketPricingProblem,
        CalibrationProblem,
        FieldLens,
        OptimizerAlgo,
    )

    strikes = [85.0, 95.0, 100.0, 105.0, 120.0]
    payoffs = tuple(
        VanillaOption(k, EXPIRY, European(), Call(), Spot()) for k in strikes
    )
    quotes = jnp.asarray([_cm_price(_prob_k(k)) for k in strikes])
    cfg = SimulationConfig(
        trajectories=20_000, steps=12, variance_reduction=Antithetic(), seed=0, qmc=True
    )
    method = MonteCarlo(HestonDynamics(), HestonQE(conditional=True), cfg)

    guess_market = HestonInputs(REF, 0.03, 100.0, 0.09, 2.0, 0.04, 0.6, -0.7)
    calib = CalibrationProblem(
        BasketPricingProblem(payoffs, guess_market),
        quotes,
        jnp.asarray([0.09, 0.6]),
        method,
        (FieldLens("market_inputs.V0"), FieldLens("market_inputs.sigma")),
    )
    res = solve(
        calib, OptimizerAlgo(), lb=jnp.asarray([1e-3, 0.05]), ub=jnp.asarray([0.5, 1.5])
    )
    assert float(res.u[0]) == pytest.approx(0.04, rel=5e-2)
    assert float(res.u[1]) == pytest.approx(0.30, rel=5e-2)
