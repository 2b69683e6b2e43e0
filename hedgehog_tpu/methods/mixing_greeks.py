"""Forward-mode greeks for the conditional (Romano-Touzi mixing) estimator.

The mixing estimator's per-path value is a closed-form Black-Scholes function
of the two variance-path functionals (IV = ∫V dt, J = ∫√V dW_v); only the
QE variance scan carries parameter dependence that needs AD.  Reverse mode
re-walks that scan backwards (rematerializing every QE step);  forward mode
pushes a handful of tangents through the SAME forward scan:

- Up to 5 tangent directions ride the scan: (V0, κ, θ, σ[, T]) — the
  parameters the V path depends on.  Each step computes two hand-derived
  coefficient arrays (∂vn = CM·∂m + CS·∂s2) ONCE and applies them to every
  direction with broadcast FMAs (models/heston_qe.qe_v_step_with_coeffs).
- (S0, ρ, r) never touch the scan: the conditional BS value's partials in
  them are closed-form in (IV, J) (``cond_bs_value_and_partials``), as are
  ∂Y/∂IV and ∂Y/∂J which chain the scan tangents into value tangents.

This makes the full 7-parameter greek vector a single forward pass at a
small multiple of the price cost — the "<2× price" contract of BASELINE.md
north star #2 (reference: ForwardDiff Duals through a re-solve,
greeks_problem.jl:249-262), on the serving estimator.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.dates import yearfrac
from ..core.payoffs import require_european
from ..market.rate_curve import df_yf, zero_rate_yf
from ..market.inputs import carry_yield, market_yearfrac
from ..models.heston_qe import qe_constants

__all__ = [
    "heston_mixing_price_and_greeks",
    "heston_exact_price_and_greeks",
    "greek_tables",
    "cond_bs_value_and_partials",
    "GREEK_ORDER",
]

# the flagship 7-parameter order (bench.py, BASELINE.md north star #2)
GREEK_ORDER = ("spot", "V0", "kappa", "theta", "sigma", "rho", "rate")

# scan-carried tangent directions (the V path depends on exactly these)
_SCAN_DIRS = ("V0", "kappa", "theta", "sigma", "T")


def cond_bs_value_and_partials(iv, j, *, f0, log_f0_over_k, strike, rho, cp):
    """Undiscounted conditional BS vanilla value Y(IV, J) and its partials.

        e_arg = ρJ − ρ²IV/2,  F = F0·e^{e_arg},  var = (1−ρ²)·IV
        Y = cp·(F·Φ(cp·d1) − K·Φ(cp·d2))

    Returns (Y, Y_iv, Y_j, Y_rho, Y_f0) where Y_f0 = ∂Y/∂F0·F0/F0… kept as
    ∂Y/∂F0 (chainable into spot, rate and explicit-T greeks: F0 = S0·e^{rT}).
    All formulas are the standard identities ∂Y/∂F = cp·Φ(cp·d1) and
    ∂Y/∂sd = F·φ(d1) chained through (IV, J, ρ, F0).
    """
    e_arg = rho * j - 0.5 * rho**2 * iv
    f_eff = f0 * jnp.exp(e_arg)
    rho_bar2 = 1.0 - rho**2
    var = jnp.maximum(rho_bar2 * iv, 1e-18)
    sd = jnp.sqrt(var)
    d1 = (log_f0_over_k + e_arg + 0.5 * var) / sd
    d2 = d1 - sd
    ncdf = jax.scipy.stats.norm.cdf
    npdf = jax.scipy.stats.norm.pdf
    y = cp * (f_eff * ncdf(cp * d1) - strike * ncdf(cp * d2))

    y_f = cp * ncdf(cp * d1)  # ∂Y/∂F (forward delta)
    vega_sd = f_eff * npdf(d1)  # ∂Y/∂sd at fixed F (total-dev vega)
    y_iv = y_f * f_eff * (-0.5 * rho**2) + vega_sd * rho_bar2 / (2.0 * sd)
    y_j = y_f * f_eff * rho
    y_rho = y_f * f_eff * (j - rho * iv) + vega_sd * (-rho * iv / sd)
    y_f0 = y_f * f_eff / f0
    return y, y_iv, y_j, y_rho, y_f0


def greek_tables(kappa, theta, sigma, T, steps: int):
    """Per-direction tangent tables for (V0, κ, θ, σ, T):

    - ``dc`` (5, 5): tangents of the V-draw/IV constants
      [θc, e, c_s2_v, c_s2_c, half_dt];
    - ``djc`` (5, 3): the (α, β, γ) closing the telescoped J chain
      J = (V_T − V0 − κθT + κ·IV)/σ at the end of the path:
      dJ_d = (1/σ)·dV_T + (κ/σ)·dIV + α_d·IV + β_d + γ_d·J.
    """
    pvec = jnp.stack([jnp.zeros_like(jnp.asarray(kappa)), jnp.asarray(kappa),
                      jnp.asarray(theta), jnp.asarray(sigma), jnp.asarray(T)])

    def cols(p):
        _v0, k_, th_, s_, t_ = p
        dt_ = t_ / steps
        e = jnp.exp(-k_ * dt_)
        c1 = s_**2 * e * (1.0 - e) / k_
        c2 = th_ * s_**2 * (1.0 - e) ** 2 / (2.0 * k_)
        return jnp.stack([th_, e, c1, c2, 0.5 * dt_])

    dc = jax.jacfwd(cols)(pvec).T  # (5 dirs, 5 cols); V0 row is zeros

    def jparts(p):
        v0_, k_, th_, s_, t_ = p
        return jnp.stack([v0_, k_, k_ * th_ * t_, 1.0 / s_])

    dj = jax.jacfwd(jparts)(pvec).T  # (5, 4): dV0, dκ, d(κθT), d(1/σ)
    inv_s = 1.0 / sigma
    alpha = inv_s * dj[:, 1]
    beta = -inv_s * (dj[:, 0] + dj[:, 2])
    gamma = sigma * dj[:, 3]
    return dc, jnp.stack([alpha, beta, gamma], axis=1)


def _scan_with_tangents(v0_val, zs, us, c, dc):
    """Run the mixing scan carrying 5 forward-tangent directions
    (V0, κ, θ, σ, T) via the hand-derived coefficient step
    (models/heston_qe.qe_v_step_with_coeffs): the per-step derivative
    collapses onto two coefficient arrays shared by ALL directions, so the
    tangent cost is a few broadcast FMAs per direction — no per-direction
    re-walk of the sqrt/log/div chain.

    ``zs``/``us``: (steps, ...) draw arrays.  Returns
    (v_T, iv, j, dv (5, ...), div (5, ...)).
    """
    from ..models.heston_qe import qe_v_step_with_coeffs

    shape = zs.shape[1:]
    dtype = zs.dtype
    v = jnp.full(shape, v0_val, dtype)
    zero = jnp.zeros(shape, dtype)
    n_dirs = dc.shape[0]
    dv0 = jnp.zeros((n_dirs,) + shape, dtype).at[0].set(1.0)  # ∂V/∂V0 = 1
    dz0 = jnp.zeros((n_dirs,) + shape, dtype)

    c_th, c_e, c_c1 = c["theta"], c["e"], c["c_s2_v"]
    half_dt, inv_sigma = c["half_dt"], c["inv_sigma"]
    k_over, ktd = c["k_over_sigma"], c["ktd_over_sigma"]
    bshape = (n_dirs,) + (1,) * len(shape)
    d_th, d_e = dc[:, 0].reshape(bshape), dc[:, 1].reshape(bshape)
    d_c1, d_c2 = dc[:, 2].reshape(bshape), dc[:, 3].reshape(bshape)
    d_hdt = dc[:, 4].reshape(bshape)

    def step(carry, inp):
        v, iv, j, dv, div = carry
        z, u = inp
        vn, cm, cs = qe_v_step_with_coeffs(v, z, u, c)
        a_coef = cm * c_e + cs * c_c1
        src = cm[None] * (d_th * (1.0 - c_e) + d_e * (v - c_th)[None]) + cs[None] * (
            d_c1 * v[None] + d_c2
        )
        dvn = a_coef[None] * dv + src
        v_sum = v + vn
        iv_step = half_dt * v_sum
        jn = j + (vn - v) * inv_sigma + iv_step * k_over - ktd
        divn = div + half_dt * (dv + dvn) + d_hdt * v_sum[None]
        return (vn, iv + iv_step, jn, dvn, divn), None

    (v, iv, j, dv, div), _ = jax.lax.scan(step, (v, zero, zero, dv0, dz0), (zs, us))
    return v, iv, j, dv, div


def heston_mixing_price_and_greeks(prob, method, key=None):
    """Price + full 7-param greek dict for a European vanilla under
    MonteCarlo(HestonDynamics, HestonQE(conditional=True)) in ONE forward
    pass (no reverse sweep over the scan).

    Returns ``(price, greeks)`` with ``greeks`` keyed by :data:`GREEK_ORDER`
    — sensitivities to (spot, V0, kappa, theta, sigma, rho, flat rate), the
    flat-rate greek including the discount-factor term.  Gradients equal
    ``jax.grad`` of the seeded ``solve`` (same draws, same estimator) to
    numerical-roundoff accuracy; cost is a small multiple of the price
    (target <2×, BASELINE.md north star #2).

    The rate greek assumes a flat short rate (HestonInputs' scalar-rate
    auto-wrap); per-pillar curve risk goes through ``jax.grad`` +
    ``ZeroRateSpineLens`` instead.
    """
    from .montecarlo import (
        Antithetic,
        HestonQE,
        MonteCarlo,
        _base_key,
        _normals,
        _qmc_normals_and_uniforms,
    )
    from ..models.dynamics import HestonDynamics

    if not (
        isinstance(method, MonteCarlo)
        and isinstance(method.dynamics, HestonDynamics)
        and isinstance(method.strategy, HestonQE)
        and method.strategy.conditional
    ):
        raise TypeError(
            "heston_mixing_price_and_greeks requires MonteCarlo(HestonDynamics, "
            "HestonQE(conditional=True))"
        )
    require_european(prob.payoff, "heston_mixing_price_and_greeks", spot_only=True)
    if jnp.ndim(prob.payoff.strike) > 0:
        raise TypeError("scalar strike only (vmap externally for grids)")

    market = prob.market_inputs
    config = method.config
    T = market_yearfrac(market, prob.payoff.expiry)
    # drift rate is r − q; the rho greek stays d/dr (∂(r−q)/∂r = 1)
    r0 = zero_rate_yf(market.rate, 0.0) - carry_yield(market)
    steps = config.steps

    # draws: identical streams to _heston_qe_mixing_values (same seed ⇒ same
    # paths ⇒ greeks consistent with the seeded price)
    anti = isinstance(config.variance_reduction, Antithetic)
    base = _base_key(config, key)
    if config.qmc:
        zb, ub = _qmc_normals_and_uniforms(base, steps, 1, config.trajectories)
        zb = zb[:, 0, :]
        z = jnp.stack([zb, -zb]) if anti else zb[None]
        us = jnp.stack([ub, 1.0 - ub]) if anti else ub[None]
    else:
        k_z, k_u = jax.random.split(base)
        z = _normals(k_z, (steps, config.trajectories), anti)
        u = jax.random.uniform(k_u, (steps, config.trajectories), dtype=jnp.float64)
        us = jnp.stack([u, 1.0 - u]) if anti else u[None]

    dt = T / steps
    c = qe_constants(market.kappa, market.theta, market.sigma, market.rho, r0, dt)
    c = dict(
        c,
        half_dt=0.5 * dt,
        inv_sigma=1.0 / market.sigma,
        k_over_sigma=market.kappa / market.sigma,
        ktd_over_sigma=market.kappa * market.theta * dt / market.sigma,
    )
    # 4 directions only: the T row (theta greek) is not in GREEK_ORDER —
    # carrying it would waste ~20% of the tangent FMAs
    dc, djc = greek_tables(market.kappa, market.theta, market.sigma, T, steps)
    dc, djc = dc[:4], djc[:4]
    zs = jnp.moveaxis(z, 1, 0)  # (steps, g, paths)
    us_s = jnp.moveaxis(us, 1, 0)
    v_t, iv, j, dv, div = _scan_with_tangents(market.V0, zs, us_s, c, dc)
    # close the telescoped J chain: dJ_d = dV_T/σ + κ/σ·dIV + α·IV + β + γ·J
    bshape = (djc.shape[0],) + (1,) * iv.ndim
    dj = (c["inv_sigma"] * dv + c["k_over_sigma"] * div
          + djc[:, 0].reshape(bshape) * iv[None]
          + djc[:, 1].reshape(bshape)
          + djc[:, 2].reshape(bshape) * j[None])

    spot, rho = market.spot, market.rho
    cp = prob.payoff.call_put()
    strike = prob.payoff.strike
    f0 = spot * jnp.exp(r0 * T)
    y, y_iv, y_j, y_rho, y_f0 = cond_bs_value_and_partials(
        iv, j, f0=f0, log_f0_over_k=jnp.log(f0 / strike), strike=strike, rho=rho, cp=cp
    )

    D = df_yf(market.rate, T)
    n = y.size
    price = D * jnp.sum(y) / n

    # scan-direction chain: dY_k = Y_iv·dIV_k + Y_j·dJ_k  (k: V0, κ, θ, σ, T)
    chain = (jnp.sum(y_iv * div, axis=tuple(range(1, div.ndim)))
             + jnp.sum(y_j * dj, axis=tuple(range(1, dj.ndim)))) / n
    m_y_f0 = jnp.sum(y_f0) / n
    m_y_rho = jnp.sum(y_rho) / n

    greeks = {
        "spot": D * m_y_f0 * f0 / spot,
        "V0": D * chain[0],
        "kappa": D * chain[1],
        "theta": D * chain[2],
        "sigma": D * chain[3],
        "rho": D * m_y_rho,
        # flat rate: F0 = S0·e^{rT} inside, e^{-rT} discount outside
        "rate": D * m_y_f0 * f0 * T - T * price,
    }
    return price, greeks


def heston_exact_price_and_greeks(prob, method, key=None):
    """Price + unbiased 7-param greek dict for a European vanilla under
    MonteCarlo(HestonDynamics, HestonExactMixing()) — the price flagship.

    (The same likelihood-ratio surrogate is baked into the estimator's
    per-path values, so plain ``jax.grad`` through ``solve`` is also
    unbiased; this function is the one-call price + dict convenience and
    the reference implementation of the estimator.)

    Raw pathwise AD through the exact scheme is biased: the Poisson count
    of the noncentral-χ² transition is a step function of the parameters, so
    ∂N = 0 drops the rate dependence of the count distribution (measured
    σ-greek off ~19×).  This estimator is the standard mixed
    pathwise/likelihood-ratio fix (Glasserman, ch. 7): freeze the counts,
    accumulate the per-path Poisson log-likelihood L = Σ_s (N_s·log λ_s −
    λ_s), and differentiate the surrogate

        value + sg(value − b)·(L − sg(L)),     b = sg(mean(value)),

    whose primal is the price and whose gradient adds the score term
    E[(f − b)·∂L] to the frozen-count pathwise gradient.  The batch-mean
    baseline b is a control variate (E[∂L] = 0, so any deterministic b is
    unbiased; the batch mean adds O(1/n_paths) correlation bias, negligible
    at MC scale, and cuts the score variance by orders of magnitude).

    Returns ``(price, greeks)`` keyed by :data:`GREEK_ORDER`; the price
    equals the seeded ``solve`` price exactly (same draws).  Validated vs
    the Carr-Madan parameter Jacobian in
    tests/agreement/test_exact_greeks.py (rel ≲3e-2 on V0/κ/θ/σ at 2^16
    QMC paths; spot/ρ/rate are pathwise-exact).  Flat-rate convention as
    :func:`heston_mixing_price_and_greeks`."""
    from ..market.inputs import HestonInputs
    from ..models.dynamics import HestonDynamics
    from .montecarlo import (
        HestonExactMixing,
        MonteCarlo,
        _heston_exact_mixing_values,
    )

    if not (
        isinstance(method, MonteCarlo)
        and isinstance(method.dynamics, HestonDynamics)
        and isinstance(method.strategy, HestonExactMixing)
    ):
        raise TypeError(
            "heston_exact_price_and_greeks requires MonteCarlo(HestonDynamics, "
            "HestonExactMixing())"
        )
    require_european(prob.payoff, "heston_exact_price_and_greeks", spot_only=True)
    if jnp.ndim(prob.payoff.strike) > 0:
        raise TypeError("scalar strike only (vmap externally for grids)")

    market = prob.market_inputs
    config = method.config
    T = market_yearfrac(market, prob.payoff.expiry)
    r0 = zero_rate_yf(market.rate, 0.0)
    params = jnp.stack(
        [jnp.asarray(x, jnp.float64) for x in (
            market.spot, market.V0, market.kappa, market.theta,
            market.sigma, market.rho, r0,
        )]
    )

    def surrogate(pvec):
        spot, v0, kappa, theta, sigma, rho, r = tuple(pvec)
        m2 = HestonInputs(
            market.reference_date, r, spot, v0, kappa, theta, sigma, rho,
            dividend_yield=carry_yield(market), daycount=market.daycount,
        )
        p2 = type(prob)(prob.payoff, m2)
        vals, logl = _heston_exact_mixing_values(p2, config, key, with_score=True)
        b = jax.lax.stop_gradient(jnp.mean(vals))
        surr = vals + jax.lax.stop_gradient(vals - b) * (
            logl - jax.lax.stop_gradient(logl)
        )
        return df_yf(m2.rate, T) * jnp.mean(surr)

    price, grad = jax.value_and_grad(surrogate)(params)
    return price, dict(zip(GREEK_ORDER, grad))
