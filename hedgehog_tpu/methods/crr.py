"""Cox-Ross-Rubinstein binomial tree as a `lax.scan` backward induction.

Parity target: reference src/pricing_methods/cox_ross_rubinstein.jl.
Forward-measure tree: up factor ``u = exp(σ√ΔT)``, down ``1/u``, up
probability ``p = 1/(1+u)`` (so the forward is a martingale), per-step
discount ``exp(-z(T)·ΔT)`` (crr.jl:113-130).  European + American exercise;
Spot or Forward underlying semantics (Spot discounts the forward node values
back with the curve, crr.jl:77-97).

Design: the shrinking tree is a fixed-width ``(steps+1,)`` vector.  Each
backward contraction reads ``v[j]`` and ``v[j+1]``; after ``k`` steps slot
``j`` depends only on initial slots ``j..j+k``, all of which are valid payoff
nodes, so no masking is needed and slot 0 holds the root price after ``steps``
contractions.  The whole induction is one ``lax.scan`` — XLA compiles it to a
tight on-chip loop, and the pricer can be vmapped over strike/expiry batches.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.dates import yearfrac
from ..core.payoffs import American, Spot
from ..core.problems import CRRSolution, PricingProblem
from ..core.solve import AbstractPricingMethod, register_solver
from ..market.rate_curve import df, df_yf, zero_rate, zero_rate_yf
from ..market.inputs import market_yearfrac
from ..market.vol_surface import get_vol
from ..utils.pytree import pytree, static_field

__all__ = ["CoxRossRubinsteinMethod"]


@pytree
class CoxRossRubinsteinMethod(AbstractPricingMethod):
    steps: int = static_field(default=100)


@register_solver(CoxRossRubinsteinMethod)
def _solve_crr(prob: PricingProblem, method: CoxRossRubinsteinMethod) -> CRRSolution:
    payoff = prob.payoff
    market = prob.market_inputs
    steps = method.steps

    from ..core.payoffs import AsianOption, BarrierOption, KnockIn, LookbackOption

    if isinstance(payoff, AsianOption):
        raise TypeError(
            "CRR's backward induction carries no running-average state; "
            "Asian options price analytically under Black-Scholes (geometric) "
            "or via grid Monte Carlo"
        )
    if isinstance(payoff, LookbackOption):
        raise TypeError(
            "CRR's backward induction carries no running-extremum state; "
            "lookbacks price analytically under Black-Scholes or via the "
            "bridge Monte Carlo estimator"
        )
    from ..core.payoffs import DoubleBarrierOption

    if isinstance(payoff, DoubleBarrierOption):
        raise TypeError(
            "the CRR lattice carries the single-barrier bridge correction "
            "only; double barriers price analytically under Black-Scholes "
            "or via the two-sided bridge Monte Carlo estimator"
        )
    if isinstance(payoff, BarrierOption):
        # A single barrier IS lattice-compatible: knocked nodes are absorbed
        # at the rebate value during the backward induction, so no path state
        # is needed.  Knock-ins reduce to knock-outs by in-out parity
        # (European only — American knock-in has no parity: the knocked-in
        # claim is a LIVE American vanilla, not a terminal payout).
        if isinstance(payoff.knock, KnockIn):
            from ..core.payoffs import European

            if not isinstance(payoff.exercise_style, European):
                # in-out parity is EUROPEAN-only (knocking in leaves a LIVE
                # American/Bermudan option); early-exercise knock-ins run
                # the joint two-layer induction instead
                return _solve_crr_knock_in_early(prob, method)
            return _solve_crr_knock_in(prob, method)
        return _solve_crr_knock_out(prob, method)

    if jnp.ndim(payoff.strike) > 0:
        # Strike grid: one tree per strike, batched along a LEADING strike
        # axis with the node axis last — the same in-method grid contract as
        # BS/Carr-Madan/conditional-MC.  The tree value vector becomes
        # (m, steps+1); per-strike vols (RectVolSurface smiles) make u/p
        # (m, 1) and broadcast cleanly through the backward contraction.
        import dataclasses

        payoff = dataclasses.replace(payoff, strike=jnp.asarray(payoff.strike)[:, None])
        prob = PricingProblem(payoff, market)

    from ..market.inputs import carry_yield, forward_spot

    sigma = get_vol(market.sigma, payoff.expiry, payoff.strike)
    T = market_yearfrac(market, payoff.expiry)
    D_T = df(market.rate, payoff.expiry)
    q = carry_yield(market)
    # forward_spot subtracts PV(cash divs ≤ T): the tree evolves the
    # ESCROWED spot S* = S − PV(divs) — Hull's textbook discrete-dividend
    # lattice (plain GBM on S*, so u/p are unchanged and the tree still
    # recombines); exercise decisions add the remaining-dividend PV back
    # (see div_addback below)
    forward = forward_spot(market, T) / D_T  # carry-adjusted T-forward
    dT = T / steps
    u = jnp.exp(sigma * jnp.sqrt(dT))
    p = 1.0 / (1.0 + u)
    step_discount = jnp.exp(-zero_rate(market.rate, payoff.expiry) * dT)

    has_divs = getattr(market, "dividends", None) is not None
    if has_divs and not isinstance(payoff.underlying, Spot):
        raise TypeError(
            "discrete dividends on the CRR lattice need a Spot underlying "
            "(the escrowed add-back is a spot-level correction)"
        )

    from ..core.payoffs import Bermudan, bermudan_step_mask

    j = jnp.arange(steps + 1)
    is_american = isinstance(payoff.exercise_style, American)
    is_bermudan = isinstance(payoff.exercise_style, Bermudan)
    can_exercise = is_american or is_bermudan
    ex_mask = (
        bermudan_step_mask(payoff.exercise_style, market, payoff.expiry, steps)
        if is_bermudan else None
    )
    on_spot = isinstance(payoff.underlying, Spot)

    # Terminal payoff over all steps+1 leaves (exponents -steps, -steps+2, …, steps).
    # With dividends the leaves are the escrowed spot = the full spot at T
    # (every ex-date ≤ T has dropped), so no terminal add-back is needed.
    value0 = payoff(forward * u ** (2 * j - steps))

    rate_curve = market.rate
    if has_divs and can_exercise:
        from ..market.dividends import remaining_dividend_pv

        # full spot at node time = escrowed node + PV_t(remaining divs)
        div_addback = remaining_dividend_pv(market, jnp.arange(steps) * dT, T)
    else:
        div_addback = jnp.zeros((max(steps, 1),))

    def step_fn(value, i):
        # i runs steps-1 … 0. Contraction: v'[j] = disc·(p·v[j+1] + (1-p)·v[j]).
        v_up = jnp.roll(value, -1, axis=-1)  # v[j+1]; last slot garbage, never consumed
        continuation = step_discount * (p * v_up + (1.0 - p) * value)
        if can_exercise:
            fwd_nodes = forward * u ** (2 * j - i)
            if on_spot:
                # Discount forward nodes to spot at time i·ΔT (crr.jl:77-83);
                # the zero-rate lookup stays in year fractions (a tick
                # round-trip would shift the tenor by the curve's day-count
                # ratio on non-ACT/365 markets).  With carry q the no-arb
                # relation is S_t = F_t·D(t,T)·e^{q(T−t)}.
                underlying = jnp.exp(
                    (q - zero_rate_yf(rate_curve, i * dT)) * (steps - i) * dT
                ) * fwd_nodes + div_addback[i]
            else:
                underlying = fwd_nodes
            exercised = jnp.maximum(continuation, payoff(underlying))
            if is_bermudan:
                # mask slot 0 is never True by construction, so i = 0 (and
                # all non-exercise node times) stays pure continuation
                new_value = jnp.where(ex_mask[i], exercised, continuation)
            else:
                new_value = exercised
        else:
            new_value = continuation
        return new_value, None

    steps_rev = jnp.arange(steps - 1, -1, -1)
    value_final, _ = jax.lax.scan(step_fn, value0, steps_rev)
    return CRRSolution(prob, method, value_final[..., 0])


def _solve_crr_knock_out(prob: PricingProblem, method: CoxRossRubinsteinMethod):
    """Knock-out barrier CRR (European + American) with BRIDGE-CORRECTED
    edges: each parent→child contraction edge carries the Brownian-bridge
    no-cross factor q = 1 − exp(−2·d0·d1/σ²ΔT) over the segment, and the
    crossing mass (1 − q) is absorbed at the rebate value — the lattice
    analog of the MC estimator's per-segment bridge products
    (montecarlo.brownian_bridge_survival_factors), pricing CONTINUOUS
    monitoring directly.  This kills the classic sawtooth: naive
    node-monitoring prices the first node LINE beyond the barrier (the walk
    cannot cross without touching it), oscillating with the lattice/barrier
    offset and converging only as O(√ΔT); the bridged edges are exact in the
    within-segment crossing law, leaving the plain O(ΔT) lattice error
    (measured: ~340bp → ~1bp at 1000 steps for an up-out call at H=1.2·S).

    Rebate semantics match ``BarrierOption``: crossing mass pays R at the
    segment midpoint (``rebate_at_hit``) or R discounted from expiry; a node
    beyond the barrier never propagates (its inbound edges have q = 0)."""
    from ..core.payoffs import Up

    payoff = prob.payoff
    market = prob.market_inputs
    steps = method.steps
    if not isinstance(payoff.underlying, Spot):
        raise TypeError("barrier CRR monitors the spot; use Spot underlying")
    if jnp.ndim(payoff.strike) > 0 or jnp.ndim(payoff.barrier) > 0:
        raise TypeError(
            "barrier CRR prices one (strike, barrier) pair per solve; vmap "
            "over contracts for grids"
        )
    if getattr(market, "dividends", None) is not None:
        raise TypeError(
            "barrier CRR assumes a dividend-free GBM path law (the bridge "
            "edge factors and hit law are escrow-inconsistent); price "
            "discrete-dividend barriers on the PDE engine or EulerMaruyama "
            "bridge MC (spot model)"
        )

    from ..market.inputs import carry_yield, forward_spot

    sigma = get_vol(market.sigma, payoff.expiry, payoff.strike)
    T = market_yearfrac(market, payoff.expiry)
    D_T = df(market.rate, payoff.expiry)
    q = carry_yield(market)
    forward = forward_spot(market, T) / D_T
    dT = T / steps
    u = jnp.exp(sigma * jnp.sqrt(dT))
    p = 1.0 / (1.0 + u)
    step_discount = jnp.exp(-zero_rate(market.rate, payoff.expiry) * dT)

    j = jnp.arange(steps + 1)
    is_american = isinstance(payoff.exercise_style, American)
    up = isinstance(payoff.direction, Up)
    log_b = jnp.log(payoff.barrier)
    R = payoff.rebate
    rate_curve = market.rate
    seg_var = sigma**2 * dT

    def log_spot_nodes(i, offsets):
        # log node spot levels at time i·ΔT for exponents ``offsets`` (same
        # discounted-forward semantics as the vanilla American branch /
        # crr.jl:77-83; with carry q, S_t = F_t·D(t,T)·e^{q(T−t)})
        return (
            jnp.log(forward)
            + (q - zero_rate_yf(rate_curve, i * dT)) * (steps - i) * dT
            + offsets * sigma * jnp.sqrt(dT)
        )

    def no_cross(x0, x1):
        d0 = (log_b - x0) if up else (x0 - log_b)
        d1 = (log_b - x1) if up else (x1 - log_b)
        inside = (d0 > 0.0) & (d1 > 0.0)
        arg = jnp.where(inside, -2.0 * d0 * d1 / seg_var, 0.0)
        return jnp.where(inside, -jnp.expm1(arg), 0.0)

    # first-passage exercise (American only, mirroring the LSM estimator's
    # hit_exercise_value): a continuously exercisable holder whose edge is
    # about to cross exercises AT the barrier — S = H exactly on a
    # continuous path — so crossing mass absorbs at
    # max(intrinsic(H)·disc^½, rebate leg) instead of the rebate alone.
    # Without this the bridged lattice is itself an O(√ΔT) lower bound for
    # boundary-hugging contracts (up-and-out calls: measured ~+2.5% at 2000
    # steps once the mass pays H−K).  Bermudan holders cannot exercise
    # between dates, so they keep the plain rebate absorption.
    hit_ex = payoff(jnp.exp(log_b)) if is_american else None

    def rebate_value(i):
        # value at t_i of R given a crossing: R at the segment midpoint
        # (one-touch; half-step discount) or R discounted from expiry with
        # the exact forward factor D(t_i, T) = D(0,T)/D(0,t_i)
        if payoff.rebate_at_hit:
            reb = R * jnp.sqrt(step_discount)
        else:
            reb = R * D_T / df_yf(rate_curve, i * dT)
        if hit_ex is not None:
            reb = jnp.maximum(hit_ex * jnp.sqrt(step_discount), reb)
        return reb

    from ..core.payoffs import Bermudan, bermudan_step_mask

    is_bermudan = isinstance(payoff.exercise_style, Bermudan)
    can_exercise = is_american or is_bermudan
    ex_mask = (
        bermudan_step_mask(payoff.exercise_style, market, payoff.expiry, steps)
        if is_bermudan else None
    )

    x_T = log_spot_nodes(steps, 2 * j - steps)
    s_T = jnp.exp(x_T)
    knocked_T = (x_T >= log_b) if up else (x_T <= log_b)
    value0 = jnp.where(knocked_T, R, payoff(s_T))

    def step_fn(value, i):
        v_up = jnp.roll(value, -1, axis=-1)  # up-child values
        x_i = log_spot_nodes(i, 2 * j - i)
        x_up = log_spot_nodes(i + 1, 2 * j - i + 1)
        x_dn = log_spot_nodes(i + 1, 2 * j - i - 1)
        q_up, q_dn = no_cross(x_i, x_up), no_cross(x_i, x_dn)
        reb = rebate_value(i)
        new_value = p * (
            q_up * step_discount * v_up + (1.0 - q_up) * reb
        ) + (1.0 - p) * (q_dn * step_discount * value + (1.0 - q_dn) * reb)
        s_i = jnp.exp(x_i)
        knocked_i = (x_i >= log_b) if up else (x_i <= log_b)
        if can_exercise:
            exercised = jnp.maximum(new_value, payoff(s_i))
            new_value = (
                jnp.where(ex_mask[i], exercised, new_value)
                if is_bermudan else exercised
            )
        # beyond-barrier nodes: already knocked (their inbound edges carry
        # q=0, so this only matters for the root when S0 is beyond H)
        new_value = jnp.where(
            knocked_i, R if payoff.rebate_at_hit else rebate_value(i), new_value
        )
        return new_value, None

    steps_rev = jnp.arange(steps - 1, -1, -1)
    value_final, _ = jax.lax.scan(step_fn, value0, steps_rev)
    return CRRSolution(prob, method, value_final[..., 0])


def _solve_crr_knock_in_early(
    prob: PricingProblem, method: CoxRossRubinsteinMethod
):
    """American/Bermudan knock-IN: hit-time quadrature against the lattice
    value of the LIVE option at the barrier (no in-out parity exists —
    knocking in leaves a live early-exercise option, not a terminal payout).

    By the strong Markov property, under the engine's lognormal dynamics

        KI = ∫₀ᵀ  D(0,t) · V_live(t, H) · dF(t)  +  R · D(0,T) · (1 − F(T)),

    where F is the CLOSED-FORM first-passage law of the drifted log-spot to
    the barrier (inverse-Gaussian; drift z(T) − q − σ²/2, the same flat
    per-step drift the lattice itself uses) and V_live(t, H) is the
    American/Bermudan vanilla value at the barrier — one standard lattice
    induction (layer A), interpolated at log H per time step.  The
    quadrature is per-segment midpoint: P(τ ∈ segment) from F differences,
    V at the segment-endpoint average, curve discount at the midpoint.

    Chosen over a crossing-mass-absorption lattice (the knock-out engine
    with rebate → V_live): absorption converges only as O(√ΔT) — the
    two-point child quadrature near the barrier misweights the kinked
    value function — measured +270 bp → +23 bp over 250→2000 steps on an
    up-in call, while this quadrature is exact in the hit law and measured
    ~1 bp at 2000 steps (the residual is layer A's node-interp sawtooth).

    Sanity anchors (tests/unit/test_barrier.py, test_american_barrier.py):
    an American up-in CALL on a carry-free market equals the European
    knock-in parity price (early exercise of the live call is never
    optimal); H at the spot recovers the plain American vanilla; KI ≤
    vanilla American; KI_am ≥ KI_eu; KI_am + KO_am superreplicates.
    """
    from ..core.payoffs import Up

    payoff = prob.payoff
    market = prob.market_inputs
    steps = method.steps
    if not isinstance(payoff.underlying, Spot):
        raise TypeError("barrier CRR monitors the spot; use Spot underlying")
    if jnp.ndim(payoff.strike) > 0 or jnp.ndim(payoff.barrier) > 0:
        raise TypeError(
            "barrier CRR prices one (strike, barrier) pair per solve; vmap "
            "over contracts for grids"
        )
    if getattr(market, "dividends", None) is not None:
        raise TypeError(
            "barrier CRR assumes a dividend-free GBM path law (the "
            "first-passage hit law is escrow-inconsistent); price "
            "discrete-dividend barriers on the barrier LSM grid estimator "
            "(spot model)"
        )

    from ..market.inputs import carry_yield, forward_spot

    sigma = get_vol(market.sigma, payoff.expiry, payoff.strike)
    T = market_yearfrac(market, payoff.expiry)
    D_T = df(market.rate, payoff.expiry)
    q = carry_yield(market)
    forward = forward_spot(market, T) / D_T
    dT = T / steps
    u = jnp.exp(sigma * jnp.sqrt(dT))
    p = 1.0 / (1.0 + u)
    step_discount = jnp.exp(-zero_rate(market.rate, payoff.expiry) * dT)

    j = jnp.arange(steps + 1)
    up = isinstance(payoff.direction, Up)
    log_b = jnp.log(payoff.barrier)
    R = payoff.rebate
    rate_curve = market.rate

    def log_spot_nodes(i, offsets):
        return (
            jnp.log(forward)
            + (q - zero_rate_yf(rate_curve, i * dT)) * (steps - i) * dT
            + offsets * sigma * jnp.sqrt(dT)
        )

    from ..core.payoffs import Bermudan, bermudan_step_mask

    is_bermudan = isinstance(payoff.exercise_style, Bermudan)
    ex_mask = (
        bermudan_step_mask(payoff.exercise_style, market, payoff.expiry, steps)
        if is_bermudan else None
    )

    x_T = log_spot_nodes(steps, 2 * j - steps)
    am0 = payoff(jnp.exp(x_T))  # live vanilla terminal value

    sq_dT = sigma * jnp.sqrt(dT)

    def barrier_interp(vals, it):
        # linear interpolation of ``vals`` at log H across the node axis,
        # CLAMPED to the valid triangle: after steps−it contractions only
        # slots 0..it hold real node values (slot j, exponent 2j−it; later
        # slots carry the roll wrap-around).  Clamping is benign — it only
        # engages while the lattice cannot reach the barrier, where the
        # first-passage mass it multiplies is ~0 (P(τ ≤ it·ΔT) ≲ Φ(−√it)).
        c = jnp.log(forward) + (
            q - zero_rate_yf(rate_curve, it * dT)
        ) * (steps - it) * dT
        jf = jnp.clip(((log_b - c) / sq_dT + it) / 2.0, 0.0, it)
        j0 = jnp.clip(jnp.floor(jf).astype(jnp.int32), 0, steps - 1)
        w = jf - j0
        return (1.0 - w) * vals[j0] + w * vals[j0 + 1]

    def step_fn(am, i):
        # layer A: live American/Bermudan vanilla, barrier value collected
        x_i = log_spot_nodes(i, 2 * j - i)
        am_up = jnp.roll(am, -1, axis=-1)
        am_cont = step_discount * (p * am_up + (1.0 - p) * am)
        exercised = jnp.maximum(am_cont, payoff(jnp.exp(x_i)))
        if is_bermudan:
            am_i = jnp.where(ex_mask[i], exercised, am_cont)
        else:
            am_i = exercised
        return am_i, barrier_interp(am_i, i)

    steps_rev = jnp.arange(steps - 1, -1, -1)
    am_root_vec, ys_rev = jax.lax.scan(step_fn, am0, steps_rev)
    # V_live(t_k, H) for k = 0..steps (terminal = intrinsic at the barrier)
    y = jnp.concatenate(
        [ys_rev[::-1], jnp.asarray(payoff(payoff.barrier))[None]]
    )

    # ---- closed-form first-passage law of the log-spot to log H ----
    # Drift is the lattice's own flat horizon drift ν = z(T) − q − σ²/2
    # (a non-flat curve enters only through the exact segment discounts).
    x_root = log_spot_nodes(0, jnp.asarray(0))
    nu = zero_rate(market.rate, payoff.expiry) - q - 0.5 * sigma**2
    d = (log_b - x_root) if up else (x_root - log_b)  # > 0 while un-knocked
    mu = nu if up else -nu  # signed drift TOWARD the barrier
    d_safe = jnp.maximum(d, 1e-300)

    from jax.scipy.stats import norm as _norm

    def fp_cdf(t):
        # P(τ_H ≤ t) = Φ((μt − d)/(σ√t)) + e^{2μd/σ²} Φ((−d − μt)/(σ√t));
        # the reflection term is assembled in log space (e^{2μd/σ²} can
        # overflow alone when its Φ factor underflows)
        st = sigma * jnp.sqrt(jnp.maximum(t, 1e-300))
        direct = _norm.cdf((mu * t - d_safe) / st)
        reflect = jnp.exp(
            2.0 * mu * d_safe / sigma**2 + _norm.logcdf((-d_safe - mu * t) / st)
        )
        return jnp.where(t > 0.0, direct + reflect, 0.0)

    t_grid = jnp.arange(steps + 1) * dT
    F = fp_cdf(t_grid)
    P_seg = jnp.diff(F)
    t_mid = (jnp.arange(steps) + 0.5) * dT
    disc_mid = df_yf(rate_curve, t_mid)  # exact curve discount to midpoints
    v_mid = 0.5 * (y[:-1] + y[1:])
    ki = jnp.sum(P_seg * disc_mid * v_mid) + R * D_T * (1.0 - F[-1])

    # already beyond the barrier at inception → the option IS the live
    # American: layer A's root value
    knocked_root = (x_root >= log_b) if up else (x_root <= log_b)
    price = jnp.where(knocked_root, am_root_vec[..., 0], ki)
    return CRRSolution(prob, method, price)


def _solve_crr_knock_in(prob: PricingProblem, method: CoxRossRubinsteinMethod):
    """European knock-in by in-out parity on the SAME lattice:
    KI(R) = vanilla − KO(0) + R·NT with the no-touch bond
    NT = E[D(T)·1{never hit}] = D(T) − (KO(rebate=1, at expiry) − KO(0))
    — three inductions that XLA fuses under one jit."""
    import dataclasses

    from ..core.payoffs import European, KnockOut, VanillaOption

    payoff = prob.payoff
    market = prob.market_inputs
    van = VanillaOption(
        payoff.strike, payoff.expiry, European(), payoff.call_put, Spot()
    )
    ko0 = dataclasses.replace(payoff, knock=KnockOut(), rebate=0.0)
    ko1e = dataclasses.replace(
        payoff, knock=KnockOut(), rebate=1.0, rebate_at_hit=False
    )
    p_van = _solve_crr(PricingProblem(van, market), method).price
    p_ko0 = _solve_crr_knock_out(PricingProblem(ko0, market), method).price
    p_ko1e = _solve_crr_knock_out(PricingProblem(ko1e, market), method).price
    no_touch = df(market.rate, payoff.expiry) - (p_ko1e - p_ko0)
    price = p_van - p_ko0 + payoff.rebate * no_touch
    return CRRSolution(prob, method, price)
