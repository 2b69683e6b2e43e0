"""Andersen-Broadie primal-dual bounds for LSM American/Bermudan prices.

Beyond-reference capability (the reference's LSM — src/
pricing_methods/least_squares_montecarlo.jl:99-136 — reports only the primal
estimate and validates it against CRR; here the framework bounds its own
bias).  The LSM price is a LOWER bound in expectation when evaluated on
fresh paths (any concrete stopping rule is suboptimal); the Andersen-Broadie
(2004) dual turns the SAME frozen policy into an UPPER bound:

    price ≤ E[ max_t (h_t − M_t) ]        for ANY martingale M,

with the near-optimal choice M built from the policy's value process —
M_t − M_{t−1} = V̂_t − Ĉ_{t−1}, where V̂_t is h_t where the policy exercises
and the nested continuation estimate Ĉ_t where it continues.  Both bounds
hold in expectation at ANY regression quality; a tight [lower, upper]
interval certifies the policy, a wide one flags basis misspecification —
the estimator audits itself without an external oracle.

Shape: the classic formulation nests simulations per (outer path,
exercise date) — a triply-nested loop on CPUs.  Here ALL inner bundles run
in ONE lax.scan over calendar time on a (dates × outer × inner) lane tensor
(lanes activate when the clock passes their start date), so the whole dual
is a single fixed-shape XLA program; the O(n²·P·I) work is elementwise and
embarrassingly lane-parallel.

Scope — two Markov-state nested samplers:

* LognormalDynamics grids (exact per-step lognormal transitions, the same
  grid semantics as ``simulate_price_grid``), state = S.
* HestonDynamics with ``HestonQE(conditional=True)`` — the conditional-LSM
  policy on the (S, V) joint basis; the nested sampler replays the SAME
  QE variance step + exact conditional lognormal bridge the fit grid used
  (montecarlo.simulate_conditional_grid), state = (logS, V).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from ..core.payoffs import VanillaOption
from ..core.problems import PricingProblem
from ..market.vol_surface import FlatVolSurface, get_vol
from ..utils.pytree import pytree
from .lsm import (
    LSM,
    _exercise_mask,
    _flatten_grid,
    _is_conditional,
    _joint_basis,
    _lsm_setup,
    _poly_basis,
    lsm_backward_induction,
    rb_terminal_value,
)
from .montecarlo import (
    Antithetic,
    HestonDynamics,
    LognormalDynamics,
    _sim_params,
    simulate_conditional_grid,
    simulate_price_grid,
)

__all__ = ["DualBound", "lsm_dual_bound"]


@pytree
class DualBound:
    """Primal-dual interval for an LSM price.

    ``lower``/``upper``: out-of-sample policy value and Andersen-Broadie
    dual estimate (each unbiased-conservative in expectation);
    ``se_lower``/``se_upper``: standard errors over the outer paths;
    ``primal``: the in-sample LSM price (the number `solve` reports);
    ``gap``: upper − lower — the policy's certified suboptimality budget
    (includes the O(1/√n_inner) dual inflation)."""

    lower: Any
    upper: Any
    se_lower: Any
    se_upper: Any
    primal: Any
    gap: Any


def _replaced_config(method: LSM, trajectories: int, seed_tag: int):
    from ..utils.pytree import replace

    cfg = method.mc_method.config
    return replace(
        cfg,
        trajectories=trajectories,
        seed=cfg.seed + seed_tag,
        variance_reduction=Antithetic(),
        qmc=False,
    )


def lsm_dual_bound(
    prob: PricingProblem,
    method: LSM,
    n_outer: int = 2048,
    n_inner: int = 128,
    seed: int = 0x0AB1,
) -> DualBound:
    """Fit the LSM policy on the method's own config, then certify it:
    fresh-path lower bound + Andersen-Broadie dual upper bound.

    ``n_outer`` fresh outer paths (antithetic pairs; both bounds average
    over them), ``n_inner`` nested continuation samples per (outer path,
    date).  ``seed`` derives the outer/inner streams — independent of the
    fit stream by construction (distinct fold tags)."""
    payoff = prob.payoff
    if not isinstance(payoff, VanillaOption):
        raise TypeError(
            "lsm_dual_bound certifies plain-vanilla LSM policies; got "
            f"{type(payoff).__name__}"
        )
    conditional = _is_conditional(method.mc_method) and isinstance(
        method.mc_method.dynamics, HestonDynamics
    )
    if not conditional and not isinstance(
        method.mc_method.dynamics, LognormalDynamics
    ):
        raise TypeError(
            "lsm_dual_bound's nested samplers cover LognormalDynamics grids "
            "and HestonDynamics with HestonQE(conditional=True); other "
            "stochastic-vol policies validate against lattice oracles"
        )
    if jnp.ndim(payoff.strike) > 0:
        raise TypeError("lsm_dual_bound prices one contract; vmap for grids")

    log_disc, strike_scale = _lsm_setup(prob, method)
    ex_mask = _exercise_mask(prob, method)  # None = American
    nsteps = method.mc_method.config.steps
    degree = method.degree
    market, T, r0 = _sim_params(prob)
    dt = T / nsteps
    n_outer = 2 * (n_outer // 2)  # antithetic outer pairs

    # ---- 1. fit the policy on the method's own (training) stream ----
    if conditional:
        s_g, v_g = simulate_conditional_grid(prob, method.mc_method.config)
        spots, vols = _flatten_grid(s_g), _flatten_grid(v_g)
        terminal = rb_terminal_value(prob, spots, vols) if method.rao_blackwell else None
    else:
        grid = simulate_price_grid(prob, method.mc_method)
        spots, vols, terminal = _flatten_grid(grid), None, None
    tau_fit, val_fit, betas_scan = lsm_backward_induction(
        spots, payoff, log_disc, degree, strike_scale, vols=vols,
        terminal_value=terminal, exercise_mask=ex_mask, collect_betas=True,
    )
    primal = jnp.mean(jnp.exp(tau_fit * log_disc) * val_fit)
    betas_by_t = betas_scan[::-1]  # [t−1] is the policy at date t

    def exercises(t, s, v):
        """Frozen-policy exercise indicator at date t (1 ≤ t ≤ nsteps−1)."""
        pay = payoff(s)
        s_n = (s / strike_scale).reshape(-1)
        phi = (
            _joint_basis(s_n, v.reshape(-1), degree)
            if conditional
            else _poly_basis(s_n, degree)
        )
        fitted = phi @ betas_by_t[t - 1]
        ex = (pay > 0.0) & (pay > fitted.reshape(s.shape))
        if ex_mask is not None:
            ex = ex & ex_mask[t]
        return ex

    # ---- 2. outer fresh paths + per-state nested stepper ----
    base = jax.random.fold_in(
        jax.random.PRNGKey(method.mc_method.config.seed), seed
    )
    k_inner = jax.random.fold_in(base, 1)
    lane_shape = (nsteps, n_outer, n_inner)
    start_t = jnp.arange(nsteps)[:, None, None]

    if conditional:
        from ..models.heston_qe import qe_constants, qe_v_step

        kappa, sig_v, rho = market.kappa, market.sigma, market.rho
        qe_c = qe_constants(kappa, market.theta, sig_v, rho, r0, dt)
        ktd = kappa * market.theta * dt
        rho_bar2 = 1.0 - rho**2
        cfg_o = _replaced_config(method, n_outer // 2, seed)
        s_og, v_og = simulate_conditional_grid(prob, cfg_o)
        s_outer, v_outer = _flatten_grid(s_og), _flatten_grid(v_og)

        def lane_init():
            x0 = jnp.log(jnp.broadcast_to(s_outer[:nsteps, :, None], lane_shape))
            v0 = jnp.broadcast_to(v_outer[:nsteps, :, None], lane_shape)
            return (x0, v0)

        def lane_step(state, live, u):
            x, v = state
            ku = jax.random.fold_in(k_inner, u)
            z = jax.random.normal(ku, (2,) + lane_shape, dtype=jnp.float64)
            uu = jax.random.uniform(
                jax.random.fold_in(ku, 7), lane_shape, dtype=jnp.float64
            )
            v_new = qe_v_step(v, z[0], uu, qe_c)
            iv = 0.5 * dt * (v + v_new)
            j = (v_new - v - ktd + kappa * iv) / sig_v
            x_new = x + r0 * dt - 0.5 * iv + rho * j + jnp.sqrt(
                jnp.maximum(rho_bar2 * iv, 1e-18)
            ) * z[1]
            return (
                jnp.where(live, x_new, x),
                jnp.where(live, v_new, v),
            )

        def lane_spot(state):
            return jnp.exp(state[0])

        def lane_vol(state):
            return state[1]
    else:
        sigma = (
            market.sigma.sigma
            if isinstance(market.sigma, FlatVolSurface)
            else get_vol(market.sigma, payoff.expiry, market.spot)
        )
        drift = (r0 - 0.5 * sigma**2) * dt
        vol_dt = sigma * jnp.sqrt(dt)
        # outer paths through the SAME sampler as the fit grid — the bounds
        # are only valid if fresh paths follow exactly the fitted law
        from ..utils.pytree import replace as _rep

        cfg_o = _replaced_config(method, n_outer // 2, seed)
        grid_o = simulate_price_grid(prob, _rep(method.mc_method, config=cfg_o))
        s_outer = _flatten_grid(grid_o)  # antithetic pairs at (i, i + P)
        v_outer = None

        def lane_init():
            return (jnp.broadcast_to(s_outer[:nsteps, :, None], lane_shape),)

        def lane_step(state, live, u):
            (s,) = state
            z = jax.random.normal(
                jax.random.fold_in(k_inner, u), lane_shape, dtype=jnp.float64
            )
            return (jnp.where(live, s * jnp.exp(drift + vol_dt * z), s),)

        def lane_spot(state):
            return state[0]

        def lane_vol(state):
            return jnp.zeros(lane_shape)

    disc_t = jnp.exp(jnp.arange(nsteps + 1) * log_disc)
    h = disc_t[:, None] * payoff(s_outer)  # discounted-to-0 payoff

    def ex_at(t, s, v):
        return exercises(t, s, v if conditional else jnp.zeros_like(s))

    ex_outer = jnp.stack(
        [ex_at(t, s_outer[t], v_outer[t] if conditional else None)
         for t in range(1, nsteps)]
        + [jnp.ones((n_outer,), bool)]
    )  # (nsteps, n_outer), t = 1..nsteps (terminal always "exercises")

    # ---- 3. ALL nested continuation bundles in one scan over the clock ----
    def clock_step(carry, u):
        state, stopped, val = carry
        live = u > start_t  # lanes whose bundle has started
        state = lane_step(state, live, u)
        s = lane_spot(state)
        ex_u = jax.lax.cond(
            u < nsteps,
            lambda: exercises(u, s, lane_vol(state)),
            lambda: jnp.ones(lane_shape, bool),
        )
        stop_now = live & ~stopped & ex_u
        val = jnp.where(stop_now, jnp.exp(u * log_disc) * payoff(s), val)
        return (state, stopped | stop_now, val), None

    init = (lane_init(), jnp.zeros(lane_shape, bool), jnp.zeros(lane_shape))
    (_, _, val_inner), _ = jax.lax.scan(
        clock_step, init, jnp.arange(1, nsteps + 1)
    )
    c_hat = jnp.mean(val_inner, axis=-1)  # (nsteps, n_outer): Ĉ_0 .. Ĉ_{n−1}

    # ---- 4. lower bound: replay the policy on the outer paths ----
    first_ex = jnp.argmax(ex_outer, axis=0)  # index into t = 1..nsteps
    tau_out = first_ex + 1
    low_vals = jnp.exp(tau_out * log_disc) * payoff(
        jnp.take_along_axis(s_outer, tau_out[None, :], axis=0)[0]
    )
    pair_vals = 0.5 * (low_vals[: n_outer // 2] + low_vals[n_outer // 2 :])
    lower = jnp.mean(pair_vals)
    se_lower = jnp.std(pair_vals) / jnp.sqrt(n_outer // 2)

    # ---- 5. dual martingale and upper bound ----
    # V̂_t = h_t where the policy exercises at t, else Ĉ_t (t < n);
    # Δ_t = V̂_t − Ĉ_{t−1};  M_t = Σ_{s ≤ t} Δ_s;  U = max_t (h_t − M_t)
    c_cont = jnp.concatenate([c_hat[1:], jnp.zeros((1, n_outer))])  # Ĉ_t, t=1..n
    v_hat = jnp.where(ex_outer, h[1:], c_cont)
    deltas = v_hat - c_hat  # aligned: Δ_t = V̂_t − Ĉ_{t−1}, t = 1..n
    m = jnp.cumsum(deltas, axis=0)
    slack = h[1:] - m
    if ex_mask is not None:
        # mask slot t gates exercise at date t (1..nsteps−1); expiry always
        # pays the terminal intrinsic, so row t = nsteps stays allowed
        allowed_rows = jnp.concatenate(
            [jnp.asarray(ex_mask)[1:], jnp.ones((1,), bool)]
        )
        slack = jnp.where(allowed_rows[:, None], slack, -jnp.inf)
    up_vals = jnp.max(slack, axis=0)
    upper = jnp.mean(up_vals)
    se_upper = jnp.std(up_vals) / jnp.sqrt(n_outer)

    return DualBound(
        lower=lower, upper=upper, se_lower=se_lower, se_upper=se_upper,
        primal=primal, gap=upper - lower,
    )
