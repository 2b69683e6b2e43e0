"""Regression tests for round-3 ADVICE/VERDICT fixes: RootFinderAlgo
diagnostics, LU-free argmin_ift Hessian solve (incl. batched cotangents),
basket fast-path dynamics guard, gl+auto-bound rejection, explicit-key reseeding.
"""

import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import hedgehog_tpu as hh
from hedgehog_tpu.math.optimize import argmin_ift, minimize_lbfgs
from hedgehog_tpu.math.rootfind import implicit_root_full

REF = dt.date(2024, 1, 1)
EXPIRY = dt.date(2025, 1, 1)


# ---- RootFinderAlgo diagnostics (VERDICT weakness W6) ----


def _iv_calibration(target_price):
    market = hh.BlackScholesInputs(REF, 0.03, 100.0, 0.5)  # wrong guess vol
    payoff = hh.VanillaOption(100.0, EXPIRY, hh.European(), hh.Call())
    basket = hh.BasketPricingProblem((payoff,), market)
    return hh.CalibrationProblem(
        basket,
        quotes=jnp.asarray([target_price]),
        initial_guess=jnp.asarray([0.5]),
        pricing_method=hh.BlackScholesAnalytic(),
        accessors=(hh.VolLens(),),
    )


def test_rootfinder_reports_convergence_and_residual():
    market = hh.BlackScholesInputs(REF, 0.03, 100.0, 0.2)
    payoff = hh.VanillaOption(100.0, EXPIRY, hh.European(), hh.Call())
    target = float(hh.solve(hh.PricingProblem(payoff, market), hh.BlackScholesAnalytic()).price)
    sol = hh.solve(_iv_calibration(target), hh.RootFinderAlgo())
    np.testing.assert_allclose(float(sol.u), 0.2, atol=1e-8)
    assert bool(sol.converged)
    assert float(sol.loss) < 1e-12  # squared residual at the bisection root
    assert int(sol.iterations) == hh.RootFinderAlgo().iters


def test_rootfinder_flags_unbracketed_quote():
    # a price above the attainable range on (1e-6, 5.0) cannot bracket
    sol = hh.solve(_iv_calibration(1e4), hh.RootFinderAlgo())
    assert not bool(sol.converged)
    assert float(sol.loss) > 1.0


def test_implicit_root_full_gradients_match_ift():
    # root of x**3 - a = 0 → x = a^(1/3); d(root)/da = a^(-2/3)/3
    a = jnp.float64(8.0)

    def root_of(a):
        return implicit_root_full(lambda x: x**3 - a, 0.1, 5.0).root

    g = jax.grad(root_of)(a)
    np.testing.assert_allclose(float(g), (8.0 ** (-2.0 / 3.0)) / 3.0, rtol=1e-10)


# ---- argmin_ift without LU custom calls (ADVICE medium) ----


def _quad_loss(x, args):
    A = jnp.array([[3.0, 0.5], [0.5, 2.0]])
    return 0.5 * x @ A @ x - x @ args


def test_argmin_ift_gradient_matches_closed_form():
    A = np.array([[3.0, 0.5], [0.5, 2.0]])
    args = jnp.array([1.0, 2.0])
    x_star = jnp.asarray(np.linalg.solve(A, np.asarray(args)))

    def downstream(a):
        return jnp.sum(argmin_ift(_quad_loss, x_star, a) ** 2)

    g = jax.grad(downstream)(args)
    # x* = A⁻¹a → d(Σx*²)/da = 2 A⁻¹ x*
    expect = 2.0 * np.linalg.solve(A, np.asarray(x_star))
    np.testing.assert_allclose(np.asarray(g), expect, rtol=1e-10)


def test_argmin_ift_batched_cotangents():
    # jax.jacobian of a vector-valued function of the optimum vmaps the
    # cotangent through _bwd (the Hessian solve is the small Cholesky of
    # math/linalg.py, not an LU custom call)
    A = np.array([[3.0, 0.5], [0.5, 2.0]])
    args = jnp.array([1.0, 2.0])
    x_star = jnp.asarray(np.linalg.solve(A, np.asarray(args)))

    J = jax.jacobian(lambda a: argmin_ift(_quad_loss, x_star, a))(args)
    np.testing.assert_allclose(np.asarray(J), np.linalg.inv(A), rtol=1e-8)


def test_argmin_ift_after_lbfgs():
    args = jnp.array([1.0, 2.0])
    res = minimize_lbfgs(lambda x: _quad_loss(x, args), jnp.zeros(2))
    assert bool(res.converged)
    x_d = argmin_ift(_quad_loss, res.x, args)
    np.testing.assert_allclose(
        np.asarray(x_d), np.linalg.solve(np.array([[3.0, 0.5], [0.5, 2.0]]), np.asarray(args)),
        rtol=1e-6,
    )


# ---- basket fast path dynamics guard (ADVICE low) ----


def test_basket_fast_path_rejects_wrong_dynamics():
    heston = hh.HestonInputs(REF, 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
    payoffs = (hh.VanillaOption(100.0, EXPIRY, hh.European(), hh.Call()),)
    basket = hh.BasketPricingProblem(payoffs, heston)
    bad = hh.MonteCarlo(  # default LognormalDynamics with a conditional QE strategy
        strategy=hh.HestonQE(conditional=True),
        config=hh.SimulationConfig(trajectories=64, steps=2),
    )
    with pytest.raises(TypeError):
        hh.solve(basket, bad)  # must match per-payoff dispatch, not fast-path it


# ---- Carr-Madan gl + auto bound rejection (ADVICE low) ----


def test_carr_madan_gl_auto_bound_rejected():
    market = hh.BlackScholesInputs(REF, 0.03, 100.0, 0.2)
    payoff = hh.VanillaOption(100.0, EXPIRY, hh.European(), hh.Call())
    prob = hh.PricingProblem(payoff, market)
    with pytest.raises(ValueError, match="panel"):
        hh.solve(prob, hh.CarrMadan(1.0, "auto", hh.LognormalDynamics(), quadrature="gl"))
    # fixed bound with gl is still accepted (accuracy is the caller's call)
    p = hh.solve(prob, hh.CarrMadan(1.0, 64.0, hh.LognormalDynamics(), quadrature="gl")).price
    ref = hh.solve(prob, hh.BlackScholesAnalytic()).price
    np.testing.assert_allclose(float(p), float(ref), rtol=1e-2)


# ---- explicit keys reseed the exact-mixing streams (ADVICE low) ----


def test_exact_mixing_explicit_keys_give_distinct_streams():
    """key=None draws from the config's seed; an explicit key reseeds the
    stream (the contract the sharded pricer's per-device keys rely on)."""
    market = hh.HestonInputs(REF, 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
    prob = hh.PricingProblem(hh.VanillaOption(100.0, EXPIRY, hh.European(), hh.Call()), market)
    cfg = hh.SimulationConfig(trajectories=256, steps=2, seed=42)
    method = hh.MonteCarlo(hh.HestonDynamics(), hh.HestonExactMixing(), cfg)

    def values(key):
        return np.asarray(hh.mc_path_values(prob, method, key=key))

    np.testing.assert_array_equal(values(None), values(jax.random.PRNGKey(42)))
    v1, v2 = values(jax.random.PRNGKey(1)), values(jax.random.PRNGKey(2))
    np.testing.assert_array_equal(v1, values(jax.random.PRNGKey(1)))
    assert not np.any(v1 == v2)
