"""Longstaff-Schwartz LSM for American options as a backward `lax.scan`.

Parity target: reference src/pricing_methods/least_squares_montecarlo.jl.
Semantics preserved exactly:

- simulate a full (steps+1 × paths) price grid (antithetic doubles the path
  count, :70-85);
- stopping state per path = (exercise step τ, exercise value), initialized at
  the terminal payoff (:112);
- backward over t = nsteps−1 … 1: continuation[p] = disc^(τ_p − t)·value_p
  with the *single-step* discount factor disc = df(T/nsteps) (:110, :117-118),
  per-step polynomial regression of continuation on ITM spot levels (:121-126),
  exercise where immediate payoff exceeds fitted continuation (:156-165);
- price = mean(disc^τ·value) (:132-133).

Fixed-shape regression: the reference's ``Polynomials.fit`` on dynamically-
sized ITM subsets becomes a masked weighted least-squares via the
(degree+1)² normal equations — fixed shapes, one small `solve` per scan step.
When the path axis is sharded (``psum_axis``), the normal equations are the
only cross-device communication: two tiny psums per time step, making LSM the
single genuinely communicating algorithm in the framework (SURVEY §5) —
every device then regresses against the *global* continuation fit.
Regressors are normalized by the strike for conditioning (the reference fits
raw spot levels of order 1; at spot~100 a raw degree-5 Vandermonde would be
numerically singular — same math, stable basis).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..core.dates import yearfrac
from ..core.payoffs import American
from ..core.problems import LSMSolution, PricingProblem
from ..core.solve import AbstractPricingMethod, register_solver
from ..market.rate_curve import df
from ..market.inputs import market_yearfrac
from ..methods.montecarlo import MonteCarlo, simulate_price_grid
from ..utils.pytree import pytree, static_field

__all__ = ["LSM", "lsm_backward_induction"]


@pytree
class LSM(AbstractPricingMethod):
    """LSM method: Monte Carlo config + polynomial regression degree.

    ``rao_blackwell`` (conditional grids only, i.e.
    ``HestonQE(conditional=True)``): replace the terminal regression/stopping
    target max(S_T−K, 0) by its EXACT conditional expectation given
    (S_{n−1}, variance path) — the one-segment conditional Black-Scholes
    closed form.  Same mean by the tower property (the stopping decisions at
    t ≤ n−1 are measurable w.r.t. the conditioning σ-algebra), strictly lower
    variance of both the regression target and the never-exercised paths'
    price contribution (Rao-Blackwell).  Ignored on terminal-payoff grids
    (Euler/QE), where no conditional closed form is available.
    """

    mc_method: MonteCarlo = static_field(default=MonteCarlo())
    degree: int = static_field(default=4)
    rao_blackwell: bool = static_field(default=True)


def _masked_lstsq_beta(phi, y, w, psum_axis: Optional[str]):
    """Fit y ~ phi·β on rows where w==1; return β.

    Weighted normal equations with a tiny ridge: singular systems (e.g. no
    ITM paths) stay solvable and are masked out downstream.  Under path
    sharding the n_terms² system is psum'ed so the regression is global.
    """
    from ..math.linalg import cholesky_solve_small

    n_terms = phi.shape[1]
    phw = phi * w[:, None]
    A = phw.T @ phi  # (n_terms, n_terms)
    b = phw.T @ y  # (n_terms,)
    if psum_axis is not None:
        A = jax.lax.psum(A, psum_axis)
        b = jax.lax.psum(b, psum_axis)
    ridge = 1e-10 * jnp.eye(n_terms) * (1.0 + jnp.trace(A) / n_terms)
    # unrolled Cholesky (math/linalg.py) instead of an LU custom call
    return cholesky_solve_small(A + ridge, b)


def _masked_lstsq_eval(phi, y, w, psum_axis: Optional[str]):
    """Fitted values phi·β of the masked regression (see _masked_lstsq_beta)."""
    return phi @ _masked_lstsq_beta(phi, y, w, psum_axis)


def _poly_basis(x, degree: int):
    """(paths, degree+1) monomial basis — the reference's Polynomials.fit
    regressor set (least_squares_montecarlo.jl:126)."""
    powers = jnp.arange(degree + 1)
    return x[:, None] ** powers[None, :]


def _joint_basis(s, v, degree: int):
    """Bivariate monomials s^i·v^j with total degree i+j ≤ degree.

    V is part of Heston's Markov state: continuation values depend on
    (S_t, V_t), so the conditional-grid LSM regresses on both (a plain-S
    basis misspecifies the value function at high vol-of-vol)."""
    terms = [s**i * v**j for i in range(degree + 1) for j in range(degree + 1 - i)]
    return jnp.stack(terms, axis=1)


def lsm_backward_induction(
    spots, payoff, log_disc, degree: int, strike_scale,
    psum_axis: Optional[str] = None, vols=None, terminal_value=None,
    surv_factors=None, rebate_spec=None, exercise_mask=None,
    barrier_eval=None, collect_betas: bool = False,
    hit_exercise_value=None,
):
    """Backward stopping-rule induction over a (steps+1, paths) price grid.

    Returns (tau, value) per path.  ``psum_axis`` enables the sharded global
    regression (see module docstring).  With ``vols`` (a matching variance
    grid, e.g. from the conditional bridge), continuation regresses on the
    joint (S, V) monomial basis instead of S alone.  ``terminal_value``
    overrides the terminal payoff as the initial stopping value (the
    Rao-Blackwellized conditional-mean target; see :class:`LSM`).

    ``surv_factors`` (knock-out barriers): the (steps, paths) per-segment
    Brownian-bridge no-cross factors q_t
    (montecarlo.brownian_bridge_survival_factors).  The stopping state gains
    a future-survival carry fsurv = Π_{s=t}^{τ−1} q_s, so the regressed
    continuation is the KNOCK-ADJUSTED value E[disc^(τ−t)·value·survival] —
    exercising yields the intrinsic (alive-ness multiplies both sides
    equally, so the policy comparison is unweighted), while the regression
    is weighted by the PAST survival A_t = Π_{s<t} q_s (mostly-dead paths
    carry little value, so they should carry little fit weight).
    ``rebate_spec = (R, at_hit)`` additionally carries the knock-out
    rebate's hold-value leg R_t = (1−q_t)·rb_t + q_t·disc·R_{t+1} into the
    regression target, so the exercise policy sees the FULL hold value
    (rebate included), exactly as the lattice's bracket does — without it
    an option whose exercise region meets the barrier over-exercises when
    the rebate is worth holding for.
    ``hit_exercise_value`` (AMERICAN knock-outs, the r3-verdict item-6
    correction): the undiscounted intrinsic AT the barrier.  A continuously
    exercisable holder whose path is about to cross exercises at first
    passage — S = H exactly on a continuous path — collecting
    max(intrinsic(H), rebate) instead of forfeiting to the knock, so the
    per-segment hit leg becomes (1−q_t)·max(intrinsic(H)·disc^½, rb_t).
    This closes the O(√Δt) grid-date-exercise gap for boundary-hugging
    contracts (up-and-out calls, down-and-out puts); it must stay None for
    Bermudan/European knock-outs, whose holders genuinely cannot exercise
    between dates.  Returns ``(tau, value, fsurv)`` with
    fsurv = Π_{s=1}^{τ−1} q_s (the t=0 segment factor q_0 is the caller's,
    matching the t=0-excluded exercise grid).

    ``exercise_mask`` (Bermudan): a concrete (nsteps,) bool array gating
    exercise per grid time (core.payoffs.bermudan_step_mask); None =
    American (every grid date).

    ``collect_betas`` (plain vanilla grids only): additionally return the
    per-step regression coefficients, stacked in scan order t = nsteps−1 … 1
    — the frozen exercise POLICY the Andersen-Broadie dual bound replays on
    fresh paths (methods/duality.py).

    ``barrier_eval = (h_scaled, intrinsic_h)`` (American knock-INS): each
    step ALSO fits a SECOND, barrier-LOCALIZED regression (Gaussian kernel
    in log(S/H) — interpolation even when the barrier is OTM) of the same
    continuation targets and returns ``(tau, value, ys)`` with ys[i] the
    live option's value at the barrier at t = nsteps−1−i (max'ed with the
    intrinsic at exercise dates only), scalar per step on S-only grids and
    per-path in v on joint-basis grids — what the knock-in estimator
    integrates against the first-hit-segment distribution
    (_solve_lsm_knock_in).  Mutually exclusive with ``surv_factors`` (the
    live option is a plain vanilla).
    """
    if barrier_eval is not None and surv_factors is not None:
        raise TypeError("barrier_eval is for knock-ins; surv_factors for knock-outs")
    if collect_betas and (barrier_eval is not None or surv_factors is not None):
        raise TypeError("collect_betas supports plain vanilla grids only")
    nsteps = spots.shape[0] - 1
    tau0 = jnp.full((spots.shape[1],), nsteps, dtype=jnp.float64)
    value0 = payoff(spots[nsteps]) if terminal_value is None else terminal_value
    barrier = surv_factors is not None
    if barrier:
        # past survival A_t = Π_{s<t} q_s, shape (steps+1, paths), A_0 = 1
        past_surv = jnp.concatenate(
            [jnp.ones_like(surv_factors[:1]), jnp.cumprod(surv_factors, axis=0)]
        )
        fsurv0 = jnp.ones((spots.shape[1],), dtype=jnp.float64)
        rleg0 = jnp.zeros((spots.shape[1],), dtype=jnp.float64)
        rebate, rebate_at_hit = (
            rebate_spec if rebate_spec is not None else (0.0, False)
        )
    carry0 = (tau0, value0, fsurv0, rleg0) if barrier else (tau0, value0)

    def step(carry, t):
        if barrier:
            tau, value, fsurv, rleg = carry
            q_t = jax.lax.dynamic_index_in_dim(
                surv_factors, t, axis=0, keepdims=False
            )
            fsurv_cont = fsurv * q_t
            # rebate hold-value leg at t: a hit in [t, t+1) pays rb_t (at
            # the segment midpoint, or R discounted from expiry); a
            # surviving path carries the discounted downstream leg
            rb_t = (
                rebate * jnp.exp(0.5 * log_disc)
                if rebate_at_hit
                else rebate * jnp.exp((nsteps - t) * log_disc)
            )
            if hit_exercise_value is not None:
                # first-passage exercise: at the hit the holder collects
                # max(intrinsic(H) at the hit time, the rebate leg)
                rb_t = jnp.maximum(
                    hit_exercise_value * jnp.exp(0.5 * log_disc), rb_t
                )
            rleg_cont = (1.0 - q_t) * rb_t + q_t * jnp.exp(log_disc) * rleg
        else:
            tau, value = carry
            fsurv_cont, rleg_cont = 1.0, 0.0
        s_t = jax.lax.dynamic_index_in_dim(spots, t, axis=0, keepdims=False)
        continuation = (
            jnp.exp((tau - t) * log_disc) * value * fsurv_cont + rleg_cont
        )
        payoff_t = payoff(s_t)
        itm = payoff_t > 0.0
        w = itm.astype(jnp.float64)
        if barrier:
            w = w * jax.lax.dynamic_index_in_dim(
                past_surv, t, axis=0, keepdims=False
            )
        if vols is None:
            phi = _poly_basis(s_t / strike_scale, degree)
        else:
            v_t = jax.lax.dynamic_index_in_dim(vols, t, axis=0, keepdims=False)
            phi = _joint_basis(s_t / strike_scale, v_t, degree)
        if barrier:
            # barrier-aware regressors: near the barrier the continuation
            # value drops to the knocked value over a boundary layer the
            # monomials cannot represent; the next-segment no-cross factor
            # q_t(S) is exactly that layer's shape, so q_t, q_t², q_t·s
            # capture it (measured: −6% → −1% vs the lattice for the
            # up-and-out American call, whose exercise boundary hugs H)
            s_n = s_t / strike_scale
            phi = jnp.concatenate(
                [phi, q_t[:, None], (q_t * q_t)[:, None], (q_t * s_n)[:, None]],
                axis=1,
            )
        beta = _masked_lstsq_beta(phi, continuation, w, psum_axis)
        fitted = phi @ beta
        exercise = itm & (payoff_t > fitted)
        if exercise_mask is not None:
            exercise = exercise & exercise_mask[t]
        tau = jnp.where(exercise, t.astype(jnp.float64), tau)
        value = jnp.where(exercise, payoff_t, value)
        if barrier:
            fsurv = jnp.where(exercise, 1.0, fsurv_cont)
            rleg = jnp.where(exercise, 0.0, rleg_cont)
            return (tau, value, fsurv, rleg), None
        if barrier_eval is not None:
            h_scaled, intrinsic_h = barrier_eval
            # SECOND regression, localized at the barrier: the policy fit
            # above is ITM-only, so for contracts whose barrier sits in the
            # OTM region (down-in calls, up-in puts) evaluating it at H
            # would extrapolate outside the sample.  A Gaussian kernel in
            # log(S/H) re-fits the SAME continuation targets with weight
            # concentrated where the hit happens — interpolation for every
            # barrier placement.
            lx = jnp.log(s_t / (h_scaled * strike_scale))
            hw = jnp.maximum(0.5 * jnp.std(lx), 0.05)
            u = lx / hw
            w_h = jnp.exp(-0.5 * u * u)
            # basis CENTERED AND SCALED at the barrier (powers of u, u = 0
            # at H): the kernel-weighted normal equations stay
            # well-conditioned — raw s/K monomials on the narrow kernel
            # band are near-singular and can NaN the Cholesky — and the
            # barrier evaluation is just β[0]
            if vols is None:
                phi_b = _poly_basis(u, degree)
                beta_h = _masked_lstsq_beta(phi_b, continuation, w_h, psum_axis)
                cont_h = beta_h[0]
            else:
                phi_b = _joint_basis(u, v_t, degree)
                beta_h = _masked_lstsq_beta(phi_b, continuation, w_h, psum_axis)
                cont_h = _joint_basis(jnp.zeros_like(u), v_t, degree) @ beta_h
            # the live option only admits exercise at exercise dates — a
            # Bermudan knocked in between dates carries pure continuation
            exercised_h = jnp.maximum(intrinsic_h, cont_h)
            if exercise_mask is not None:
                y_t = jnp.where(exercise_mask[t], exercised_h, cont_h)
            else:
                y_t = exercised_h
            return (tau, value), y_t
        if collect_betas:
            return (tau, value), beta
        return (tau, value), None

    ts = jnp.arange(nsteps - 1, 0, -1)  # nsteps-1 … 1 (t=0 excluded, lsm.jl:114)
    out, ys = jax.lax.scan(step, carry0, ts)
    if barrier_eval is not None or collect_betas:
        return out + (ys,)
    return out


def _lsm_setup(prob: PricingProblem, method: LSM):
    from ..core.payoffs import Bermudan

    payoff = prob.payoff
    if not isinstance(payoff.exercise_style, (American, Bermudan)):
        raise TypeError(
            "LSM prices American/Bermudan options (lsm.jl solve signature "
            ":99-102; Bermudan is a beyond-reference extension)."
        )
    from ..core.payoffs import AsianOption, BarrierOption, KnockIn, LookbackOption

    if isinstance(payoff, AsianOption):
        raise TypeError(
            "LSM's stopping state carries no running-average state; American "
            "Asian pricing is unsupported"
        )
    if isinstance(payoff, LookbackOption):
        raise TypeError(
            "LSM's stopping state carries no running-extremum state; "
            "American lookback pricing is unsupported"
        )
    from ..core.payoffs import DoubleBarrierOption

    if isinstance(payoff, DoubleBarrierOption):
        raise TypeError(
            "barrier LSM carries the single-barrier survival state only; "
            "American double-barrier pricing is unsupported"
        )
    market = prob.market_inputs
    T = market_yearfrac(market, payoff.expiry)
    nsteps = method.mc_method.config.steps
    # single-step discount factor (lsm.jl:110) — stay in YEAR-FRACTION space:
    # materializing T/nsteps as ticks (ACT/365) and re-reading it under the
    # curve's own day-count would scale every per-step discount by the
    # convention ratio (e.g. 365/360 on an ACT/360 market)
    from ..market.rate_curve import df_yf

    disc = df_yf(market.rate, T / nsteps)
    return jnp.log(disc), jnp.asarray(payoff.strike, jnp.float64)


def _is_conditional(mc_method: MonteCarlo) -> bool:
    from .montecarlo import HestonQE

    return isinstance(mc_method.strategy, HestonQE) and mc_method.strategy.conditional


def _flatten_grid(grid):
    n_groups, ntimes, npaths = grid.shape
    return jnp.moveaxis(grid, 0, 1).reshape(ntimes, n_groups * npaths)


def rb_terminal_value(prob: PricingProblem, spots, vols):
    """Rao-Blackwellized terminal stopping value on a conditional (S, V) grid:
    E[payoff(S_T) | S_{n−1}, V-path] in closed form over the LAST segment.

    The conditional bridge draws logS_T = logS_{n−1} + rΔ − IV/2 + ρJ +
    √((1−ρ²)·IV)·Z_⊥ with the trapezoid IV and the CIR-identity J of the
    final segment (montecarlo.simulate_conditional_grid), so S_T | (S_{n−1},
    V-seg) is lognormal with forward F = S_{n−1}·e^{rΔ+ρJ−ρ²IV/2} and
    variance (1−ρ²)·IV — the same conditional close the mixing estimator
    uses (montecarlo.conditional_payoff_close), seeded per path."""
    from .montecarlo import _sim_params, conditional_payoff_close

    market, T, r0 = _sim_params(prob)
    nsteps = spots.shape[0] - 1
    dt = T / nsteps
    kappa, sigma, rho = market.kappa, market.sigma, market.rho
    v_a, v_b = vols[nsteps - 1], vols[nsteps]
    iv = 0.5 * dt * (v_a + v_b)
    j = (v_b - v_a - kappa * market.theta * dt + kappa * iv) / sigma
    f_eff = spots[nsteps - 1] * jnp.exp(r0 * dt + rho * j - 0.5 * rho**2 * iv)
    return conditional_payoff_close(prob.payoff, f_eff, (1.0 - rho**2) * iv)


@register_solver(LSM)
def _solve_lsm(prob: PricingProblem, method: LSM) -> LSMSolution:
    from ..core.payoffs import BarrierOption, KnockIn

    log_disc, strike_scale = _lsm_setup(prob, method)
    ex_mask = _exercise_mask(prob, method)
    if isinstance(prob.payoff, BarrierOption):
        if isinstance(prob.payoff.knock, KnockIn):
            return _solve_lsm_knock_in(prob, method, log_disc, strike_scale, ex_mask)
        return _solve_lsm_knock_out(prob, method, log_disc, strike_scale, ex_mask)
    if _is_conditional(method.mc_method):
        # conditional LSM (American at flagship speed): variance-only QE path
        # + one-normal exact conditional S bridge per step, regression on the
        # joint (S, V) basis — see simulate_conditional_grid
        from .montecarlo import simulate_conditional_grid

        s_grid, v_grid = simulate_conditional_grid(prob, method.mc_method.config)
        spots, vols = _flatten_grid(s_grid), _flatten_grid(v_grid)
        terminal = rb_terminal_value(prob, spots, vols) if method.rao_blackwell else None
    else:
        grid = simulate_price_grid(prob, method.mc_method)  # (g, steps+1, paths)
        spots, vols, terminal = _flatten_grid(grid), None, None

    tau, value = lsm_backward_induction(
        spots, prob.payoff, log_disc, method.degree, strike_scale, vols=vols,
        terminal_value=terminal, exercise_mask=ex_mask,
    )
    price = jnp.mean(jnp.exp(tau * log_disc) * value)
    return LSMSolution(prob, method, price, (tau, value), spots)


def _exercise_mask(prob: PricingProblem, method: LSM):
    """None for American (every grid date); the concrete Bermudan step mask
    otherwise (core.payoffs.bermudan_step_mask)."""
    from ..core.payoffs import Bermudan, bermudan_step_mask

    if not isinstance(prob.payoff.exercise_style, Bermudan):
        return None
    return bermudan_step_mask(
        prob.payoff.exercise_style, prob.market_inputs, prob.payoff.expiry,
        method.mc_method.config.steps,
    )


def _solve_lsm_knock_in(
    prob: PricingProblem, method: LSM, log_disc, strike_scale, ex_mask=None
) -> LSMSolution:
    """American/Bermudan knock-IN barrier LSM — the hit-time estimator on a
    SIMULATED grid (beyond the lattice engine, this handles STOCHASTIC
    VARIANCE: the live option's value at the hit depends on (τ, V_τ)).

    By the strong Markov property KI = E[Σ_k 1{first hit ∈ seg k}·D(t_k)·
    V_live(t_k, H, V_k)] + R·D(T)·P(never hit).  Per path, the first-hit-
    segment distribution comes from the bridge no-cross factors (the same
    substrate as the knock-out legs), and V_live(t, H, v) is the VANILLA
    American induction's fitted continuation evaluated AT THE BARRIER —
    max(intrinsic(H), φ(H, v)·β_t), per-path in v on the conditional Heston
    grid (this is where the hit-time state lives; a lattice cannot carry
    it).  The (hit-prob × barrier-value) product is per-path, so the
    fh_k ↔ V_k correlation through the variance path is captured — the
    quantity a deterministic hit-law quadrature misses under Heston.

    Accuracy: the regression surrogate extrapolates the continuation fit to
    s = H; for down-in puts (H below spot, deep ITM) the barrier sits
    inside the well-sampled ITM regression region.  Validated against the
    closed-hit-law CRR engine on GBM grids and in the σ_v → 0 Heston
    degeneration (tests/agreement/test_american_knock_in_mc.py)."""
    from ..market.rate_curve import df_yf
    from .montecarlo import barrier_grid_factors

    from ..core.payoffs import Spot

    payoff = prob.payoff
    market = prob.market_inputs
    if not isinstance(payoff.underlying, Spot):
        raise TypeError("barrier LSM monitors the spot; use Spot underlying")
    if jnp.ndim(payoff.strike) > 0 or jnp.ndim(payoff.barrier) > 0:
        raise TypeError(
            "barrier LSM prices one (strike, barrier) pair per solve; vmap "
            "over contracts for grids"
        )
    spot_grid, factors, t_mids, v_grid, seg_vars = barrier_grid_factors(
        prob, method.mc_method
    )
    nsteps = factors.shape[0]
    spots = spot_grid.reshape(nsteps + 1, -1)
    surv = factors.reshape(nsteps, -1)
    vols = _flatten_grid(v_grid) if v_grid is not None else None

    # Richardson pair for the never-hit survival (see _solve_barrier_mc):
    # on Heston grids re-bridge the SAME grid at every 2nd node so the
    # rebate leg's P(never hit) matches the European knock-in's
    # extrapolated estimate on the same paths exactly.  (The knocked leg
    # keeps the fine-resolution first-hit pairing — its accuracy is
    # regression-dominated, and the coarse grid has no matching per-step
    # barrier-value sequence to pair with.)  The coarse pass reuses the
    # spot grid + segment variances barrier_grid_factors already simulated
    # — re-simulating with the same seed produced an identical grid at
    # double the simulation cost (ADVICE r4).
    surv_T_coarse = None
    from ..core.payoffs import Up
    from .montecarlo import (
        _RICH_W,
        _coarse_bridge_inputs,
        _richardson_applies,
        _sim_params,
        brownian_bridge_survival_factors,
    )

    mc_cfg = method.mc_method.config
    if _richardson_applies(method.mc_method.dynamics, mc_cfg.steps):
        _, T_, _ = _sim_params(prob)
        lg2, sv2, _tm2 = _coarse_bridge_inputs(
            jnp.log(spot_grid), seg_vars, T_, mc_cfg.steps
        )
        f2 = brownian_bridge_survival_factors(
            lg2, sv2, jnp.log(payoff.barrier),
            isinstance(payoff.direction, Up),
        )
        surv_T_coarse = jnp.prod(f2, axis=0).reshape(-1)

    intrinsic_h = payoff(payoff.barrier)
    tau, value, ys_rev = lsm_backward_induction(
        spots, payoff, log_disc, method.degree, strike_scale, vols=vols,
        exercise_mask=ex_mask,
        barrier_eval=(payoff.barrier / strike_scale, intrinsic_h),
    )
    # V_live(t_k, H[, V_k]) over k = 0..nsteps: no t=0 regression (the
    # induction excludes it — reuse t=1's fit; the first segment's hit mass
    # is paired with it), terminal hit = intrinsic at the barrier.
    # ys is (nsteps−1,) on S-only grids, (nsteps−1, N) on joint (S, V) ones.
    ys = ys_rev[::-1]  # t = 1..nsteps−1
    y_full = jnp.concatenate(
        [ys[:1], ys, jnp.full_like(ys[:1], intrinsic_h)], axis=0
    )
    v_mid = 0.5 * (y_full[:-1] + y_full[1:])  # per-segment midpoint value
    if v_mid.ndim == 1:
        v_mid = v_mid[:, None]  # broadcast against the path axis

    past = jnp.concatenate([jnp.ones_like(surv[:1]), jnp.cumprod(surv, axis=0)])
    first_hit = past[:-1] * (1.0 - surv)  # (nsteps, N)
    d_mid = df_yf(market.rate, t_mids)
    knocked_leg = jnp.mean(jnp.sum(d_mid[:, None] * first_hit * v_mid, axis=0))
    surv_T = past[-1]
    if surv_T_coarse is not None:
        surv_T = _RICH_W * surv_T - (_RICH_W - 1.0) * surv_T_coarse
    rebate_leg = payoff.rebate * df(market.rate, payoff.expiry) * jnp.mean(surv_T)
    ki_price = knocked_leg + rebate_leg

    # already beyond the barrier at inception → the contract IS the live
    # American: the SAME induction's stopping value prices it (the CRR
    # engine's knocked_root branch, mirrored)
    from ..core.payoffs import Up

    up = isinstance(payoff.direction, Up)
    knocked_root = (
        market.spot >= payoff.barrier if up else market.spot <= payoff.barrier
    )
    vanilla_price = jnp.mean(jnp.exp(tau * log_disc) * value)
    price = jnp.where(knocked_root, vanilla_price, ki_price)
    return LSMSolution(prob, method, price, (tau, value), spots)


def _solve_lsm_knock_out(
    prob: PricingProblem, method: LSM, log_disc, strike_scale, ex_mask=None
) -> LSMSolution:
    """American knock-out barrier LSM: the stopping induction over the
    bridge grid with the per-segment no-cross factors riding the stopping
    state (see ``lsm_backward_induction``'s ``surv_factors``).

    Per-path price contribution: A_τ·disc^τ·intrinsic(S_τ) with the
    FULL survival to exercise A_τ = Π_{s<τ} q_s (= q_0·fsurv, since the
    induction excludes t=0), plus the rebate legs — a knock-out's rebate
    pays only when the barrier is hit BEFORE exercise settles the option:
    at the hit time (Σ_k 1[k<τ]·A_k·(1−q_k)·D(t_mid_k)·R, the first-hit-
    segment distribution from the bridge factors) or at expiry
    (R·D(T)·(1 − A_τ)).  Everything is smooth in (spot, vol, barrier), so
    ``jax.grad`` barrier-American greeks survive.  Grids:
    LognormalDynamics × EulerMaruyama or the conditional Heston bridge
    (joint (S, V) regression basis)."""
    from ..market.rate_curve import df_yf
    from .montecarlo import barrier_grid_factors

    from ..core.payoffs import Spot

    payoff = prob.payoff
    market = prob.market_inputs
    if not isinstance(payoff.underlying, Spot):
        raise TypeError("barrier LSM monitors the spot; use Spot underlying")
    if jnp.ndim(payoff.strike) > 0 or jnp.ndim(payoff.barrier) > 0:
        raise TypeError(
            "barrier LSM prices one (strike, barrier) pair per solve; vmap "
            "over contracts for grids"
        )
    spot_grid, factors, t_mids, v_grid, _seg_vars = barrier_grid_factors(
        prob, method.mc_method
    )
    nsteps = factors.shape[0]
    spots = spot_grid.reshape(nsteps + 1, -1)  # (steps+1, g·paths)
    surv = factors.reshape(nsteps, -1)
    vols = _flatten_grid(v_grid) if v_grid is not None else None

    from ..core.payoffs import American

    # first-passage exercise (see lsm_backward_induction): admissible only
    # under continuous (American) exercise; intrinsic(H) = 0 degrades it to
    # the plain rebate leg automatically
    hit_ex = (
        payoff(jnp.asarray(payoff.barrier))
        if ex_mask is None and isinstance(payoff.exercise_style, American)
        else None
    )

    tau, value, fsurv, _rleg = lsm_backward_induction(
        spots, payoff, log_disc, method.degree, strike_scale, vols=vols,
        surv_factors=surv, rebate_spec=(payoff.rebate, payoff.rebate_at_hit),
        exercise_mask=ex_mask, hit_exercise_value=hit_ex,
    )
    a_tau = surv[0] * fsurv  # Π_{s<τ} q_s
    price = jnp.mean(a_tau * jnp.exp(tau * log_disc) * value)
    rebate = payoff.rebate
    past = jnp.concatenate([jnp.ones_like(surv[:1]), jnp.cumprod(surv, axis=0)])
    D_T = df(market.rate, payoff.expiry)
    k = jnp.arange(nsteps, dtype=jnp.float64)
    before_tau = (k[:, None] < tau[None, :]).astype(jnp.float64)
    first_hit = past[:-1] * (1.0 - surv)  # P(first hit in segment k)
    d_mid = df_yf(market.rate, t_mids)
    if payoff.rebate_at_hit:
        # without a first-passage exercise right (Bermudan/European gate),
        # the hit pays the contractual rebate AS IS — maximum() against a
        # phantom 0 intrinsic would silently clamp a negative rebate
        hit_pay = d_mid * (
            rebate if hit_ex is None else jnp.maximum(hit_ex, rebate)
        )
        leg = jnp.mean(jnp.sum(hit_pay[:, None] * first_hit * before_tau, axis=0))
    elif hit_ex is not None:
        # at the hit the holder chooses: exercise intrinsic(H) now, or hold
        # for the at-expiry rebate
        hit_pay = jnp.maximum(hit_ex * d_mid, rebate * D_T)
        leg = jnp.mean(jnp.sum(hit_pay[:, None] * first_hit * before_tau, axis=0))
    else:
        leg = rebate * D_T * jnp.mean(1.0 - a_tau)
    return LSMSolution(prob, method, price + leg, (tau, value), spots)
