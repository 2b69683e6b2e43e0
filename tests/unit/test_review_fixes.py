"""Regression tests for code-review findings: LU-free solvers, array-strike
vectorization, QE kernel RNG independence (pure-JAX mirror)."""

import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hedgehog_tpu import (
    BlackScholesAnalytic,
    BlackScholesInputs,
    Call,
    CarrMadan,
    European,
    HestonDynamics,
    HestonInputs,
    LognormalDynamics,
    PricingProblem,
    RectVolSurface,
    Spot,
    VanillaOption,
    get_vol_yf,
    solve,
)
from hedgehog_tpu.math.linalg import cholesky_solve_small, tridiag_solve

REF = dt.date(2024, 1, 1)
EXPIRY = dt.date(2025, 1, 1)


def test_cholesky_solve_small_matches_numpy():
    rng = np.random.default_rng(0)
    for n in (2, 5, 8):
        M = rng.normal(size=(n, n))
        A = M @ M.T + 0.1 * np.eye(n)
        b = rng.normal(size=n)
        x = np.asarray(cholesky_solve_small(jnp.asarray(A), jnp.asarray(b)))
        np.testing.assert_allclose(x, np.linalg.solve(A, b), rtol=1e-10)


def test_tridiag_solve_matches_numpy():
    rng = np.random.default_rng(1)
    n = 12
    d = rng.uniform(2.0, 3.0, n)
    dl = rng.uniform(0.1, 0.5, n)
    du = rng.uniform(0.1, 0.5, n)
    b = rng.normal(size=n)
    A = np.diag(d) + np.diag(dl[1:], -1) + np.diag(du[:-1], 1)
    x = np.asarray(tridiag_solve(jnp.asarray(dl), jnp.asarray(d), jnp.asarray(du), jnp.asarray(b)))
    np.testing.assert_allclose(x, np.linalg.solve(A, b), rtol=1e-10)


def make_surface():
    tenors = jnp.array([0.25, 0.5, 1.0])
    strikes = jnp.array([80.0, 100.0, 120.0])
    vols = jnp.array([[0.30, 0.25, 0.28], [0.32, 0.26, 0.29], [0.34, 0.27, 0.30]])
    return RectVolSurface(REF, tenors, strikes, vols)


def test_rect_surface_array_strike_lookup():
    surf = make_surface()
    ks = jnp.array([80.0, 90.0, 100.0])
    vols = get_vol_yf(surf, 0.25, ks)
    assert vols.shape == (3,)
    np.testing.assert_allclose(np.asarray(vols), [0.30, 0.275, 0.25], atol=1e-12)
    # 2-D query grids too
    grid = get_vol_yf(surf, jnp.array([[0.25], [0.5]]), ks[None, :])
    assert grid.shape == (2, 3)


def test_bs_price_strike_grid_with_rect_surface():
    """The advertised strike-grid vectorization with a NON-flat vol surface."""
    surf = make_surface()
    market = BlackScholesInputs(REF, 0.03, 100.0, surf)
    ks = jnp.array([80.0, 100.0, 120.0])
    payoff = VanillaOption(ks, EXPIRY, European(), Call(), Spot())
    prices = solve(PricingProblem(payoff, market), BlackScholesAnalytic()).price
    assert prices.shape == (3,)
    for i, k in enumerate([80.0, 100.0, 120.0]):
        p1 = float(
            solve(
                PricingProblem(VanillaOption(k, EXPIRY, European(), Call(), Spot()), market),
                BlackScholesAnalytic(),
            ).price
        )
        assert float(prices[i]) == pytest.approx(p1, rel=1e-12)


@pytest.mark.parametrize("engine", ["complex", "pair"])
def test_carr_madan_strike_grid(engine):
    market = HestonInputs(REF, 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
    ks = jnp.array([80.0, 100.0, 120.0])
    payoff = VanillaOption(ks, EXPIRY, European(), Call(), Spot())
    method = CarrMadan(1.0, 32.0, HestonDynamics(), engine=engine)
    prices = solve(PricingProblem(payoff, market), method).price
    assert prices.shape == (3,)
    for i, k in enumerate([80.0, 100.0, 120.0]):
        single = float(
            solve(
                PricingProblem(VanillaOption(k, EXPIRY, European(), Call(), Spot()), market),
                method,
            ).price
        )
        assert float(prices[i]) == pytest.approx(single, rel=1e-12)


def test_cubic_curve_still_correct_after_thomas():
    from hedgehog_tpu import RateCurve, df_yf

    tenors = np.array([0.5, 1.0, 2.0, 5.0, 10.0])
    dfs = np.exp(-0.02 * tenors**1.1)
    curve = RateCurve.from_dfs(REF, tenors, dfs, interp="cubic")
    for tau, d in zip(tenors, dfs):
        assert float(df_yf(curve, tau)) == pytest.approx(float(d), abs=1e-12)
    # interior smoothness: value between knots is between neighbors' ballpark
    z = float(df_yf(curve, 1.5))
    assert 0.9 < z < 1.0


def test_qe_exponential_branch_martingale():
    """Pure-JAX mirror of the kernel RNG-independence fix: one QE-M step from
    a psi>1.5 state must preserve E[S'/S] = e^{rΔ} (was −3.6e-4 off with the
    correlated-uniform scheme)."""
    from hedgehog_tpu.models.heston_qe import qe_constants, qe_step

    key = jax.random.PRNGKey(0)
    n = 2_000_000
    k1, k2, k3 = jax.random.split(key, 3)
    z_v = jax.random.normal(k1, (n,))
    z_x = jax.random.normal(k2, (n,))
    u = jax.random.uniform(k3, (n,))
    c = qe_constants(2.0, 0.04, 0.3, -0.7, 0.0, 1.0 / 12)  # r=0 → martingale
    x0 = jnp.zeros((n,))
    v0 = jnp.full((n,), 0.005)  # psi ≈ 2 → exponential branch
    x1, _ = qe_step(x0, v0, z_v, z_x, u, c)
    growth = float(jnp.mean(jnp.exp(x1)))
    se = float(jnp.std(jnp.exp(x1))) / np.sqrt(n)
    assert abs(growth - 1.0) < 4 * se + 1e-5


def test_qe_kernel_martingale_flag_cpu_path():
    """HestonQE(martingale_correction=False) honors the flag."""
    import datetime as dt

    from hedgehog_tpu import HestonQE, MonteCarlo, SimulationConfig, solve

    market = HestonInputs(REF, 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
    prob = PricingProblem(VanillaOption(100.0, EXPIRY, European(), Call(), Spot()), market)
    cfg = SimulationConfig(trajectories=50_000, steps=8, seed=0)
    p_m = float(solve(prob, MonteCarlo(HestonDynamics(), HestonQE(martingale_correction=True), cfg)).price)
    p_nm = float(solve(prob, MonteCarlo(HestonDynamics(), HestonQE(martingale_correction=False), cfg)).price)
    assert p_m != p_nm  # the flag changes the scheme
    cm = float(solve(prob, CarrMadan(1.0, 32.0, HestonDynamics())).price)
    assert abs(p_m - cm) / cm < 2e-2 and abs(p_nm - cm) / cm < 2e-2


def test_sobol_wraparound_guard():
    with pytest.raises(ValueError, match="period"):
        from hedgehog_tpu.math.sobol import sobol_uniforms

        sobol_uniforms(jax.random.PRNGKey(0), 8, 2, skip=2**30 - 4)


def test_sharded_qmc_disjoint_points():
    """Sharded QMC devices take disjoint Sobol' slices: the D-device estimate
    must equal the single-device estimate with the same total paths (same
    sequence, same randomization key, just partitioned)."""
    from hedgehog_tpu import (
        BlackScholesExact,
        BlackScholesInputs,
        LognormalDynamics,
        MonteCarlo,
        SimulationConfig,
        solve,
    )
    from hedgehog_tpu.parallel.sharding import make_paths_mesh, sharded_mc_price

    market = BlackScholesInputs(REF, 0.05, 100.0, 0.2)
    prob = PricingProblem(VanillaOption(100.0, EXPIRY, European(), Call(), Spot()), market)
    n = 32_768
    cfg = SimulationConfig(trajectories=n, steps=1, seed=3, qmc=True)
    m = MonteCarlo(LognormalDynamics(), BlackScholesExact(), cfg)
    p_single = float(solve(prob, m).price)
    p_sharded = float(sharded_mc_price(prob, m, make_paths_mesh()))
    assert p_sharded == pytest.approx(p_single, rel=1e-12)


def test_interp2d_cubic_precompute_consistency():
    """Hoisted cubic row coefficients must give identical results to the
    generic per-query path."""
    import jax.numpy as jnp

    from hedgehog_tpu.math.interpolation import interp1d, interp2d_nested

    x_vals = jnp.array([0.25, 0.5, 1.0, 2.0])
    y_vals = jnp.array([80.0, 95.0, 105.0, 120.0])
    rng = np.random.default_rng(0)
    values = jnp.asarray(rng.uniform(0.1, 0.4, (4, 4)))
    xq = jnp.asarray(rng.uniform(0.2, 2.1, 16))
    yq = jnp.asarray(rng.uniform(75.0, 125.0, 16))
    fast = interp2d_nested(xq, yq, x_vals, y_vals, values, "linear", "cubic")
    slow = jnp.stack(
        [
            interp1d(
                xq[i],
                x_vals,
                jnp.stack([interp1d(yq[i], y_vals, values[r], "cubic") for r in range(4)]),
                "linear",
            )
            for i in range(16)
        ]
    )
    np.testing.assert_allclose(np.asarray(fast), np.asarray(slow), atol=1e-13)


def test_third_review_round_fixes():
    """Round-3 review findings: analytic greeks consistent with the pricer's
    vol lookup, batch AnalyticGreek, FD at x0=0, mixed-type forward_rate,
    zero-tenor rejection, vol FieldLens in AnalyticGreek."""
    import datetime as dt

    from hedgehog_tpu import (
        AnalyticGreek,
        BatchGreekProblem,
        FieldLens,
        FiniteDifference,
        ForwardAD,
        GreekProblem,
        RateCurve,
        ReverseAD,
        SpotLens,
        VolLens,
        ZeroRateSpineLens,
        forward_rate,
        solve,
    )

    # 1: analytic delta == AD delta even when surface ref date != market ref date
    surf = RectVolSurface(dt.date(2023, 7, 1), jnp.array([0.5, 2.0]), jnp.array([80.0, 120.0]),
                          jnp.full((2, 2), 0.2))
    market = BlackScholesInputs(REF, 0.05, 100.0, surf)
    prob = PricingProblem(VanillaOption(100.0, EXPIRY, European(), Call(), Spot()), market)
    d_ad = float(solve(GreekProblem(prob, SpotLens()), ForwardAD(), BlackScholesAnalytic()).greek)
    d_an = float(solve(GreekProblem(prob, SpotLens()), AnalyticGreek(), BlackScholesAnalytic()).greek)
    assert d_an == pytest.approx(d_ad, rel=1e-10)

    # 2: batch AnalyticGreek works
    flat = BlackScholesInputs(REF, 0.05, 100.0, 0.2)
    prob2 = PricingProblem(VanillaOption(100.0, EXPIRY, European(), Call(), Spot()), flat)
    batch = solve(BatchGreekProblem(prob2, (SpotLens(), VolLens(1, 1))), AnalyticGreek(),
                  BlackScholesAnalytic())
    assert set(batch) == {SpotLens(), VolLens(1, 1)}

    # 3: FD at x0 == 0 gives the derivative, not NaN
    zero_rate_mkt = BlackScholesInputs(REF, 0.0, 100.0, 0.2)
    prob3 = PricingProblem(VanillaOption(100.0, EXPIRY, European(), Call(), Spot()), zero_rate_mkt)
    fd = float(solve(GreekProblem(prob3, ZeroRateSpineLens(0)), FiniteDifference(1e-5),
                     BlackScholesAnalytic()).greek)
    ad = float(solve(GreekProblem(prob3, ZeroRateSpineLens(0)), ReverseAD(),
                     BlackScholesAnalytic()).greek)
    assert np.isfinite(fd) and fd == pytest.approx(ad, rel=1e-4)

    # 4: mixed-type forward_rate
    curve = RateCurve.from_dfs(REF, [0.5, 1.0, 2.0], [0.99, 0.975, 0.95])
    fr = float(forward_rate(curve, 0.5, dt.date(2025, 1, 1)))
    assert np.isfinite(fr)

    # 5: zero first tenor rejected
    with pytest.raises(ValueError, match="positive"):
        RateCurve.from_dfs(REF, [0.0, 1.0], [1.0, 0.97])

    # 6: vol FieldLens accepted by AnalyticGreek
    vega = float(solve(GreekProblem(prob2, FieldLens("market_inputs.sigma.sigma")),
                       AnalyticGreek(), BlackScholesAnalytic()).greek)
    vega_ad = float(solve(GreekProblem(prob2, FieldLens("market_inputs.sigma.sigma")),
                          ForwardAD(), BlackScholesAnalytic()).greek)
    assert vega == pytest.approx(vega_ad, rel=1e-10)
