"""Multi-chip sharding tier (SURVEY §4): path-sharded MC on the virtual
8-device CPU mesh, RNG stream independence, and gradients through psum."""

import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hedgehog_tpu import (
    Antithetic,
    BlackScholesAnalytic,
    BlackScholesExact,
    BlackScholesInputs,
    Call,
    European,
    EulerMaruyama,
    HestonDynamics,
    HestonInputs,
    LognormalDynamics,
    MonteCarlo,
    PricingProblem,
    SimulationConfig,
    Spot,
    SpotLens,
    VanillaOption,
    solve,
)
from hedgehog_tpu.parallel.sharding import make_paths_mesh, sharded_mc_price, sharded_mc_price_fn

REF = dt.date(2020, 1, 1)
EXPIRY = dt.date(2021, 1, 1)
PAYOFF = VanillaOption(100.0, EXPIRY, European(), Call(), Spot())
BS_MARKET = BlackScholesInputs(REF, 0.05, 100.0, 0.20)
BS_PROB = PricingProblem(PAYOFF, BS_MARKET)


def test_eight_devices_available():
    assert len(jax.devices()) == 8  # conftest forces the virtual CPU mesh


def test_sharded_bs_mc_price():
    mesh = make_paths_mesh()
    cfg = SimulationConfig(trajectories=80_000, steps=1, seed=0)
    method = MonteCarlo(LognormalDynamics(), BlackScholesExact(), cfg)
    p_sharded = float(sharded_mc_price(BS_PROB, method, mesh))
    p_analytic = float(solve(BS_PROB, BlackScholesAnalytic()).price)
    assert p_sharded == pytest.approx(p_analytic, rel=2e-2)
    # determinism: same config → same price
    assert float(sharded_mc_price(BS_PROB, method, mesh)) == p_sharded


def test_sharded_heston_mc_price():
    mesh = make_paths_mesh()
    market = HestonInputs(REF, 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
    prob = PricingProblem(PAYOFF, market)
    cfg = SimulationConfig(
        trajectories=40_000, steps=50, seed=1, variance_reduction=Antithetic()
    )
    method = MonteCarlo(HestonDynamics(), EulerMaruyama(), cfg)
    from hedgehog_tpu import CarrMadan

    p_sharded = float(sharded_mc_price(prob, method, mesh))
    p_cm = float(solve(prob, CarrMadan(1.0, 32.0, HestonDynamics())).price)
    assert p_sharded == pytest.approx(p_cm, rel=5e-2)


def test_sharded_gradient_through_psum():
    mesh = make_paths_mesh()
    cfg = SimulationConfig(trajectories=80_000, steps=1, seed=0)
    method = MonteCarlo(LognormalDynamics(), BlackScholesExact(), cfg)
    price_fn = sharded_mc_price_fn(method, mesh)
    delta = jax.grad(lambda s: price_fn(SpotLens().set(BS_PROB, s)))(100.0)
    from hedgehog_tpu import AnalyticGreek, GreekProblem

    delta_an = float(
        solve(GreekProblem(BS_PROB, SpotLens()), AnalyticGreek(), BlackScholesAnalytic()).greek
    )
    assert float(delta) == pytest.approx(delta_an, rel=3e-2)


def test_per_device_stream_independence():
    """Per-device normal blocks derived by fold_in(axis_index) must be
    uncorrelated — the RNG stream discipline of SURVEY §2c."""
    key = jax.random.PRNGKey(0)
    blocks = [jax.random.normal(jax.random.fold_in(key, i), (20_000,)) for i in range(8)]
    for i in range(8):
        for j in range(i + 1, 8):
            corr = float(jnp.corrcoef(blocks[i], blocks[j])[0, 1])
            assert abs(corr) < 0.03


def test_uneven_paths_rejected():
    mesh = make_paths_mesh()
    cfg = SimulationConfig(trajectories=1001, steps=1, seed=0)
    method = MonteCarlo(LognormalDynamics(), BlackScholesExact(), cfg)
    with pytest.raises(ValueError, match="divide evenly"):
        sharded_mc_price(BS_PROB, method, mesh)


def test_sharded_lsm_vs_crr():
    """Path-sharded LSM with psum'ed global regression vs CRR (the
    communicating-algorithm tier of SURVEY §5)."""
    from hedgehog_tpu import American, CoxRossRubinsteinMethod, LSM, Put
    from hedgehog_tpu.parallel.sharding import sharded_lsm_price

    mesh = make_paths_mesh()
    payoff = VanillaOption(100.0, EXPIRY, American(), Put(), Spot())
    prob = PricingProblem(payoff, BS_MARKET)
    cfg = SimulationConfig(
        trajectories=16_000, steps=50, seed=0, variance_reduction=Antithetic()
    )
    lsm = LSM(MonteCarlo(LognormalDynamics(), BlackScholesExact(), cfg), 4)
    p_sharded = float(sharded_lsm_price(prob, lsm, mesh))
    p_crr = float(solve(prob, CoxRossRubinsteinMethod(500)).price)
    assert p_sharded == pytest.approx(p_crr, rel=2.5e-2)
    # determinism across calls
    assert float(sharded_lsm_price(prob, lsm, mesh)) == p_sharded


def test_sharded_new_model_families():
    """The path-sharded pricer composes with the round-3 model families
    (Merton exact terminal draws, SABR forward-measure Euler) unchanged —
    mc_path_values is the one interface, per-device streams fold in the
    device index, one psum reduces."""
    import datetime as dt

    import hedgehog_tpu as hh

    ref, exp = dt.date(2024, 1, 1), dt.date(2024, 12, 31)
    opt = hh.VanillaOption(100.0, exp, hh.European(), hh.Call(), hh.Spot())
    mesh = make_paths_mesh()
    cases = [
        (hh.MertonInputs(ref, 0.03, 100.0, 0.2, 0.5, -0.1, 0.15),
         hh.MonteCarlo(hh.MertonJumpDynamics(), hh.MertonExact(),
                       hh.SimulationConfig(trajectories=1 << 13, steps=1,
                                           variance_reduction=hh.Antithetic(), seed=0))),
        (hh.SABRInputs(ref, 0.03, 100.0, 0.2, 0.7, -0.3, 0.4),
         hh.MonteCarlo(hh.SABRDynamics(), hh.EulerMaruyama(),
                       hh.SimulationConfig(trajectories=1 << 12, steps=16,
                                           variance_reduction=hh.Antithetic(), seed=0))),
        (hh.BachelierInputs(ref, 0.03, 100.0, 20.0),
         hh.MonteCarlo(hh.NormalDynamics(), hh.BachelierExact(),
                       hh.SimulationConfig(trajectories=1 << 13, steps=1,
                                           variance_reduction=hh.Antithetic(), seed=0))),
        (hh.RoughBergomiInputs(ref, 0.03, 100.0, 0.04, 1.5, 0.1, -0.7),
         hh.MonteCarlo(hh.RoughBergomiDynamics(), hh.RoughBergomiMixing(),
                       hh.SimulationConfig(trajectories=1 << 12, steps=16,
                                           variance_reduction=hh.Antithetic(), seed=0))),
        (hh.HestonHullWhiteInputs(ref, 0.03, 100.0, 0.04, 2.0, 0.04, 0.3,
                                  -0.6, 0.1, 0.012, -0.3),
         hh.MonteCarlo(hh.HestonHullWhiteDynamics(), hh.HestonQE(conditional=True),
                       hh.SimulationConfig(trajectories=1 << 12, steps=12,
                                           variance_reduction=hh.Antithetic(), seed=0))),
    ]
    for mkt, method in cases:
        prob = hh.PricingProblem(opt, mkt)
        p_sh = float(sharded_mc_price(prob, method, mesh))
        p_1 = float(hh.solve(prob, method).price)
        # independent per-device streams: statistical, not bitwise, agreement
        assert p_sh == pytest.approx(p_1, rel=4e-2)
