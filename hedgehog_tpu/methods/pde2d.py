"""2-D Heston PDE pricing by ADI (Craig-Sneyd) — `PDEMethod(HestonDynamics())`.

Extends the 1-D finite-difference family (methods/pde.py) to stochastic
volatility: the Heston backward PDE

    V_t + ½S²v·V_SS + ρσS v·V_Sv + ½σ²v·V_vv
        + (r−q)S·V_S + κ(θ−v)·V_v − r·V = 0

on a (spot × variance) grid, solved by Alternating-Direction-Implicit
splitting in the In 't Hout-Foulon (2010) style:

- **A1** = the S-direction operator (½S²v·V_SS + (r−q)S·V_S − ½rV),
  **A2** = the v-direction operator (½σ²v·V_vv + κ(θ−v)·V_v − ½rV), both
  built by the shared non-uniform convection-diffusion stencil of the 1-D
  engine (Péclet-limited upwinding → monotone rows; one-sided far-field
  boundaries, which at v=0 degenerate to exactly the CIR inflow form
  κθ·V_v − ½rV since the diffusion factor v vanishes there).
- **A0** = the mixed term ρσSv·V_Sv, explicit (central cross-stencil).
- Time stepping: the **Craig-Sneyd** scheme — a Douglas predictor (one
  batched tridiagonal solve per direction) plus a corrector stage that
  restores second order in time when A0 ≠ 0; Rannacher startup steps run
  the predictor fully implicit with the corrector off.

Shape: every implicit solve is a BATCH of tridiagonal systems (all
variance rows at once along S, then all spot columns along v), each solved
by parallel cyclic reduction (math/linalg.tridiag_solve_pcr) — wide
vectorized stages, no sequential sweeps — inside one `lax.scan` over time.

Supported payoffs: `VanillaOption`/`DigitalOption` (European / American /
Bermudan by projection) and single knock-out `BarrierOption`s (the barrier
is an S-grid endpoint with a Dirichlet rebate line across all variance
levels; European knock-ins by in-out parity).  Greeks are `jax.grad`
through the scan on a frozen grid with a C² bicubic (spot, V0) readout.

Oracles: Carr-Madan on the Heston CF (European), the conditional-MC /
LSM engines (American, barriers) — tests/unit/test_pde_heston.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.payoffs import (
    American,
    BarrierOption,
    Bermudan,
    DigitalOption,
    European,
    KnockIn,
    KnockOut,
    Spot,
    Up,
    VanillaOption,
    bermudan_step_mask,
)
from ..core.problems import PDESolution, PricingProblem
from ..market.inputs import carry_yield, market_yearfrac
from ..market.rate_curve import df, df_yf
from ..math.linalg import tridiag_solve_pcr

__all__ = ["solve_pde_heston"]


def _mean_variance(market, T):
    """E[(1/T)∫₀ᵀ v_t dt] — the CIR mean integrated variance (grid sizing)."""
    kt = jnp.maximum(market.kappa * T, 1e-12)
    w = (1.0 - jnp.exp(-kt)) / kt
    return market.theta + (market.V0 - market.theta) * w


def _heston_grids(market, payoff, method, s_lo=None, s_hi=None):
    """Frozen (stop_gradient) spot × variance grids."""
    from .pde import _grid_bounds, _sinh_grid

    T = market_yearfrac(market, payoff.expiry)
    sigma_ref = jnp.sqrt(_mean_variance(market, T))
    lo, hi = _grid_bounds(market, payoff, sigma_ref, T, method.n_std)
    if s_lo is not None:
        lo = s_lo
    if s_hi is not None:
        hi = s_hi
    k = jnp.asarray(payoff.strike, jnp.float64)
    center = jnp.clip(k, lo, hi)
    s_grid = jax.lax.stop_gradient(
        _sinh_grid(lo, hi, center, method.cluster * k, method.space_steps)
    )
    # variance axis: [0, v_max], sinh-clustered toward v = 0 (where the CIR
    # density piles up, especially under Feller violation).  v_max must
    # scale with the vol-of-vol: the CIR stationary std is σ√(θ/2κ), and
    # truncating the right tail biases high-σ (Feller-violating) markets —
    # cover the mean + 10 stationary stds as well as 5× the level marks.
    v_tail = market.theta + 10.0 * market.sigma * jnp.sqrt(
        market.theta / (2.0 * jnp.maximum(market.kappa, 1e-8))
    )
    v_max = jnp.maximum(
        jnp.maximum(5.0 * jnp.maximum(market.theta, market.V0), 0.5), v_tail
    )
    d = jnp.maximum(jnp.maximum(market.theta, market.V0), 5e-3) / 2.0
    u = jnp.linspace(0.0, 1.0, method.var_steps + 1)
    v_grid = jax.lax.stop_gradient(
        (d * jnp.sinh(u * jnp.arcsinh(v_max / d))).at[0].set(0.0)
    )
    return s_grid, v_grid


def _first_derivative_weights(x):
    """Non-uniform central first-derivative weights (w_m, w_0, w_p) for the
    interior nodes of grid ``x`` (used by the explicit mixed stencil)."""
    h = jnp.diff(x)
    h_m, h_p = h[:-1], h[1:]
    w_m = -h_p / (h_m * (h_m + h_p))
    w_p = h_m / (h_p * (h_m + h_p))
    return w_m, -(w_m + w_p), w_p


def _apply_tridiag(l, m, u, x):
    """(l, m, u)·x along the last axis (l[...,0], u[...,-1] ignored)."""
    x_lo = jnp.concatenate([jnp.zeros_like(x[..., :1]), x[..., :-1]], axis=-1)
    x_hi = jnp.concatenate([x[..., 1:], jnp.zeros_like(x[..., :1])], axis=-1)
    return l * x_lo + m * x + u * x_hi


def solve_pde_heston(prob: PricingProblem, method) -> PDESolution:
    payoff = prob.payoff
    market = prob.market_inputs

    if isinstance(payoff, BarrierOption):
        if isinstance(payoff.knock, KnockIn):
            if not isinstance(payoff.exercise_style, European):
                raise TypeError(
                    "early-exercise knock-ins have no in-out parity; price "
                    "them on the conditional-grid barrier LSM"
                )
            return _solve_heston_knock_in(prob, method)
        return _solve_heston_core(prob, method, barrier=True)
    return _solve_heston_core(prob, method, barrier=False)


def _solve_heston_core(prob, method, barrier: bool) -> PDESolution:
    payoff = prob.payoff
    market = prob.market_inputs
    if jnp.ndim(payoff.strike) > 0:
        raise TypeError(
            "PDEMethod prices one contract per solve; vmap over contracts"
        )

    T = market_yearfrac(market, payoff.expiry)
    M = method.time_steps
    dt = T / M
    q = carry_yield(market)
    kappa, theta, sig_v, rho = (
        market.kappa, market.theta, market.sigma, market.rho,
    )

    d_side = None
    s_lo = s_hi = None
    D_T = df(market.rate, payoff.expiry)
    if barrier:
        if jnp.ndim(payoff.barrier) > 0:
            raise TypeError("PDEMethod prices one (strike, barrier) pair per solve")
        H = jnp.asarray(payoff.barrier, jnp.float64)
        if isinstance(payoff.direction, Up):
            s_hi, d_side = H, -1
        else:
            s_lo, d_side = H, 0
    s_grid, v_grid = _heston_grids(market, payoff, method, s_lo, s_hi)

    # Dirichlet rebate line values per time index (barrier only)
    t_edges = jnp.arange(M + 1) * dt
    if barrier:
        R = payoff.rebate
        if payoff.rebate_at_hit:
            d_vals = jnp.broadcast_to(jnp.asarray(R, jnp.float64), (M + 1,))
        else:
            d_vals = R * D_T / df_yf(market.rate, t_edges)
    else:
        d_vals = jnp.zeros((M + 1,))

    # per-step curve-exact forward rates
    log_df = jnp.log(df_yf(market.rate, t_edges))
    r_steps = -(log_df[1:] - log_df[:-1]) / dt

    from .pde import _terminal_condition, convection_diffusion_operator

    # V is (n_v+1, n_s+1): one spot row per variance level
    v_col = v_grid[:, None]
    v_T_row = _terminal_condition(payoff, s_grid)
    U0 = jnp.broadcast_to(v_T_row, (v_grid.shape[0], s_grid.shape[0]))
    if barrier:
        U0 = U0.at[:, d_side].set(d_vals[-1])

    style = payoff.exercise_style
    is_american = isinstance(style, American)
    is_bermudan = isinstance(style, Bermudan)
    can_exercise = is_american or is_bermudan
    ex_mask = (
        bermudan_step_mask(style, market, payoff.expiry, M) if is_bermudan
        else jnp.ones((max(M, 1),), bool)
    )
    intrinsic = payoff(s_grid)[None, :] if can_exercise else None

    # mixed-term machinery (explicit): c·D_S D_v V with c = ρσ S v
    sw_m, sw_0, sw_p = _first_derivative_weights(s_grid)
    vw_m, vw_0, vw_p = _first_derivative_weights(v_grid)
    mix_c = rho * sig_v * s_grid[None, 1:-1] * v_grid[1:-1, None]

    def a0_apply(U):
        # D_v along axis 0 (interior variance rows), then D_S along axis 1
        dv = (vw_m[:, None] * U[:-2, :] + vw_0[:, None] * U[1:-1, :]
              + vw_p[:, None] * U[2:, :])
        dsdv = (sw_m[None, :] * dv[:, :-2] + sw_0[None, :] * dv[:, 1:-1]
                + sw_p[None, :] * dv[:, 2:])
        out = jnp.zeros_like(U)
        return out.at[1:-1, 1:-1].set(mix_c * dsdv)

    rann = min(method.rannacher, M)
    thetas = jnp.where(jnp.arange(M) >= M - rann, 1.0, method.theta)
    cs_on = jnp.where(jnp.arange(M) >= M - rann, 0.0, 1.0)

    def ops(r_k):
        # A1 rows (per variance level, along S) and A2 rows (along v)
        l1, m1, u1 = convection_diffusion_operator(
            s_grid,
            0.5 * v_col * s_grid[None, :] ** 2,
            jnp.broadcast_to((r_k - q) * s_grid, (v_grid.shape[0], s_grid.shape[0])),
            0.5 * r_k,
        )
        l2, m2, u2 = convection_diffusion_operator(
            v_grid, 0.5 * sig_v**2 * v_grid, kappa * (theta - v_grid), 0.5 * r_k
        )
        return (l1, m1, u1), (l2, m2, u2)

    def implicit_s(op1, rhs, th, d_val):
        l1, m1, u1 = op1
        a_l, a_m, a_u = -th * dt * l1, 1.0 - th * dt * m1, -th * dt * u1
        if d_side is not None:
            a_l = a_l.at[:, d_side].set(0.0)
            a_u = a_u.at[:, d_side].set(0.0)
            a_m = a_m.at[:, d_side].set(1.0)
            rhs = rhs.at[:, d_side].set(d_val)
        return tridiag_solve_pcr(a_l, a_m, a_u, rhs)

    def implicit_v(op2, rhs, th, d_val):
        l2, m2, u2 = op2
        a_l, a_m, a_u = -th * dt * l2, 1.0 - th * dt * m2, -th * dt * u2
        x = tridiag_solve_pcr(a_l, a_m, a_u, rhs.T).T
        if d_side is not None:  # the barrier line is constant in v: re-pin
            x = x.at[:, d_side].set(d_val)
        return x

    def step(U, xs):
        i, r_k, th, cs_k = xs
        op1, op2 = ops(r_k)
        d_val = d_vals[i]

        def a1(x):
            return _apply_tridiag(*op1, x)

        def a2(x):
            return _apply_tridiag(*op2, x.T).T

        FU = a0_apply(U) + a1(U) + a2(U)
        # Douglas predictor
        y0 = U + dt * FU
        y1 = implicit_s(op1, y0 - th * dt * a1(U), th, d_val)
        y2 = implicit_v(op2, y1 - th * dt * a2(U), th, d_val)
        # Craig-Sneyd corrector (restores 2nd order with the mixed term);
        # weighted by cs_k so Rannacher startup steps skip it branchlessly
        y0h = y0 + 0.5 * dt * (a0_apply(y2) - a0_apply(U))
        y1h = implicit_s(op1, y0h - th * dt * a1(U), th, d_val)
        y2h = implicit_v(op2, y1h - th * dt * a2(U), th, d_val)
        U_new = cs_k * y2h + (1.0 - cs_k) * y2

        if can_exercise:
            exercised = jnp.maximum(U_new, intrinsic)
            U_new = jnp.where(ex_mask[i], exercised, U_new)
            if d_side is not None:
                U_new = U_new.at[:, d_side].set(d_val)
        return U_new, None

    steps_rev = jnp.arange(M - 1, -1, -1)
    xs = (steps_rev, r_steps[steps_rev], thetas[steps_rev], cs_on[steps_rev])
    U, _ = jax.lax.scan(step, U0, xs)

    from ..math.interpolation import interp2d_nested

    price_live = interp2d_nested(
        market.V0, market.spot, v_grid, s_grid, U,
        kind_x="cubic", kind_y="cubic",
    )
    if barrier:
        H = jnp.asarray(payoff.barrier, jnp.float64)
        knocked0 = (
            (market.spot >= H) if isinstance(payoff.direction, Up)
            else (market.spot <= H)
        )
        price = jnp.where(knocked0, d_vals[0], price_live)
    else:
        price = price_live
    return PDESolution(prob, method, price, (s_grid, v_grid), U)


def _solve_heston_knock_in(prob, method) -> PDESolution:
    """European knock-in by in-out parity (same identity as crr.py:431)."""
    import dataclasses

    payoff = prob.payoff
    market = prob.market_inputs
    van = VanillaOption(
        payoff.strike, payoff.expiry, European(), payoff.call_put, Spot()
    )
    ko0 = dataclasses.replace(payoff, knock=KnockOut(), rebate=0.0)
    ko1e = dataclasses.replace(
        payoff, knock=KnockOut(), rebate=1.0, rebate_at_hit=False
    )
    p_van = _solve_heston_core(PricingProblem(van, market), method, barrier=False).price
    p_ko0 = _solve_heston_core(PricingProblem(ko0, market), method, barrier=True).price
    p_ko1e = _solve_heston_core(PricingProblem(ko1e, market), method, barrier=True).price
    no_touch = df(market.rate, payoff.expiry) - (p_ko1e - p_ko0)
    price = p_van - p_ko0 + payoff.rebate * no_touch
    return PDESolution(prob, method, price, None, None)
