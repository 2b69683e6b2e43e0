"""Hull-White pricing: curve-fitted closed forms + exact short-rate MC.

Beyond-reference asset class (see models/hull_white.py for the math; the
reference — src/market_inputs/rate_curve.jl — treats rates as a
deterministic discounting input only).  The same ``solve(problem, method)``
facade covers:

    ZeroCouponBond  — the curve df (the fit identity; MC: E[pathwise
                      discount], pinned to the curve by the Γ-correction)
    BondOption      — lognormal ZCB-option closed form (σ_p), branchless
                      σ_p → 0 intrinsic
    Caplet/floorlet — scaled bond put/call (the textbook equivalence)
    Swaption        — Jamshidian decomposition: the critical state x* from
                      the IFT-differentiable bracketed root, then a sum of
                      bond options — AD flows through x* correctly
    HullWhiteMonteCarlo — EXACT (x, ∫x) joint transitions at ANY step
                      count with the pathwise stochastic discount; the MC
                      is the agreement oracle for every closed form above

Greeks/calibration: ``a``/``sigma`` are leaves of :class:`HullWhiteInputs`
and the curve enters through P(0, ·) only, so key-rate durations
(ZeroRateSpineLens), dP/dσ (rate vega) and (a, σ) calibration to
caplet/swaption quotes all run through the standard lens machinery.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.stats import norm

from ..core.payoffs import BondOption, CapFloor, Caplet, Swaption, ZeroCouponBond
from ..core.problems import AnalyticSolution, MonteCarloSolution, PricingProblem
from ..core.solve import AbstractPricingMethod, register_solver
from ..market.rate_curve import df_yf
from ..math.rootfind import implicit_root
from ..models.hull_white import hw_b, hw_bond, hw_gamma, hw_sigma_p, hw_step_moments
from ..utils.pytree import pytree, static_field
from .montecarlo import Antithetic, SimulationConfig, _base_key, _qmc_normals

__all__ = [
    "HullWhiteAnalytic",
    "HullWhiteMonteCarlo",
    "HullWhiteGrid",
    "hw_zbo_price",
]

_IR_PAYOFFS = (ZeroCouponBond, BondOption, Caplet, CapFloor, Swaption)


@pytree
class HullWhiteAnalytic(AbstractPricingMethod):
    """Closed forms for the interest-rate payoff family on
    :class:`HullWhiteInputs` markets (see module docstring)."""


@pytree
class HullWhiteMonteCarlo(AbstractPricingMethod):
    """Exact-transition short-rate Monte Carlo: (x, ∫x) drawn jointly from
    the OU transition law per segment (no discretization error at any
    ``config.steps``), stochastic discount exp(−∫r) carried per path.
    ``config.qmc`` draws the (2 × steps)-dimensional Sobol' stream."""

    config: SimulationConfig = static_field(default=SimulationConfig())


@pytree
class HullWhiteGrid(AbstractPricingMethod):
    """Dense x-grid backward induction for (Bermudan) swaptions — the
    matmul replacement for the classic Hull-White trinomial tree.

    The OU transition density over ANY gap is Gaussian in closed form, and
    the bank-account weight E[e^{−∫x}|x, x'] is a closed-form exponential
    of (x, x'), so the discounted transition operator between consecutive
    exercise dates is one dense (nodes × nodes) kernel matrix: a Bermudan
    with m exercise dates prices in m matmuls — no per-Δt
    stepping, no tree geometry, exact transitions at any date spacing.
    ``nodes`` trapezoid points over ``width`` stationary standard
    deviations; European swaptions cross-check Jamshidian at ~1e-5."""

    nodes: int = static_field(default=257)
    width: float = static_field(default=7.0)


def _yf(market, ticks):
    return market.daycount.yearfrac(market.reference_date, ticks)


def hw_zbo_price(market, t_exp, t_bond, strike, cp):
    """ZCB-option closed form: cp = +1 call / −1 put on P(T, S) struck at
    ``strike``, exercising at T = t_exp (year fractions).  σ_p → 0 (or
    T → 0) degenerates branchlessly to the discounted intrinsic."""
    p_t = df_yf(market.rate, t_exp)
    p_s = df_yf(market.rate, t_bond)
    sp = hw_sigma_p(market.a, market.sigma, t_exp, t_bond)
    ok = sp > 1e-14
    sp_safe = jnp.where(ok, sp, 1.0)
    h = jnp.log(p_s / (strike * p_t)) / sp_safe + 0.5 * sp_safe
    live = cp * (p_s * norm.cdf(cp * h) - strike * p_t * norm.cdf(cp * (h - sp_safe)))
    intrinsic = jnp.maximum(cp * (p_s - strike * p_t), 0.0)
    return jnp.where(ok, live, intrinsic)


def _caplet_as_zbo(market, payoff: Caplet):
    """(t_exp, t_end, bond strike K', scale): caplet = scale·ZBP(T, S, K'),
    floorlet = scale·ZBC — the simple-rate/bond-put equivalence."""
    tau = market.daycount.yearfrac(payoff.start, payoff.end)
    k_bond = 1.0 / (1.0 + payoff.strike_rate * tau)
    scale = payoff.notional * (1.0 + payoff.strike_rate * tau)
    return _yf(market, payoff.start), _yf(market, payoff.end), k_bond, scale


def _require_european_swaption(payoff, name):
    from ..core.payoffs import European

    if isinstance(payoff, Swaption) and not isinstance(
        payoff.exercise_style, European
    ):
        raise TypeError(
            f"{name} prices European swaptions; Bermudan exercise prices on "
            "HullWhiteGrid (the x-grid backward induction)"
        )


def _swap_legs(market, payoff: Swaption):
    """(t_exp, payment yfs (n,), coupons c_i (n,)): the fixed+principal leg
    Σ c_i·P(T, t_i) the payer swaption puts against par."""
    t_exp = _yf(market, payoff.expiry)
    times = jnp.asarray([_yf(market, d) for d in payoff.payment_dates])
    prev = jnp.concatenate([jnp.asarray([t_exp]), times[:-1]])
    taus = times - prev
    c = payoff.strike_rate * taus
    c = c.at[-1].add(1.0)
    return t_exp, times, c


def _jamshidian_strikes(market, t_exp, times, c):
    """Critical x* with Σ c_i·P̂(T, t_i; x*) = 1 (monotone in x — P̂ is a
    decreasing exponential of x) via the IFT-differentiable bracketed root,
    and the per-payment strikes K_i = P̂(T, t_i; x*)."""
    p_t = df_yf(market.rate, t_exp)

    def bond_at(x):
        return hw_bond(
            p_t, df_yf(market.rate, times), market.a, market.sigma,
            t_exp, times, x,
        )

    x_star = implicit_root(lambda x: jnp.sum(c * bond_at(x)) - 1.0, -3.0, 3.0)
    return bond_at(x_star)


@register_solver(HullWhiteAnalytic)
def _solve_hw_analytic(prob: PricingProblem, method: HullWhiteAnalytic):
    payoff, market = prob.payoff, prob.market_inputs
    _require_hw(market, payoff, "HullWhiteAnalytic")
    if isinstance(payoff, ZeroCouponBond):
        price = df_yf(market.rate, _yf(market, payoff.maturity))
    elif isinstance(payoff, BondOption):
        cp = payoff.call_put()
        price = hw_zbo_price(
            market, _yf(market, payoff.expiry), _yf(market, payoff.bond_maturity),
            payoff.strike, cp,
        )
    elif isinstance(payoff, Caplet):
        t_exp, t_end, k_bond, scale = _caplet_as_zbo(market, payoff)
        cp_bond = -payoff.call_put()  # caplet = bond PUT, floorlet = bond CALL
        price = scale * hw_zbo_price(market, t_exp, t_end, k_bond, cp_bond)
    elif isinstance(payoff, CapFloor):
        from ..utils.pytree import replace as _replace

        price = sum(
            _solve_hw_analytic(_replace(prob, payoff=c), method).price
            for c in payoff.caplets()
        )
    elif isinstance(payoff, Swaption):
        _require_european_swaption(payoff, "HullWhiteAnalytic")
        t_exp, times, c = _swap_legs(market, payoff)
        strikes = _jamshidian_strikes(market, t_exp, times, c)
        cp_bond = -1.0 if payoff.payer else 1.0  # payer = basket of bond puts
        per_leg = hw_zbo_price(market, t_exp, times, strikes, cp_bond)
        price = payoff.notional * jnp.sum(c * per_leg)
    return AnalyticSolution(prob, method, price)


def _require_hw(market, payoff, name):
    from ..market.inputs import HullWhiteInputs

    if not isinstance(market, HullWhiteInputs):
        raise TypeError(f"{name} prices on HullWhiteInputs markets; got "
                        f"{type(market).__name__}")
    if not isinstance(payoff, _IR_PAYOFFS):
        raise TypeError(
            f"{name} prices the interest-rate payoff family "
            f"(ZeroCouponBond/BondOption/Caplet/Swaption); got "
            f"{type(payoff).__name__}"
        )


def _hw_paths(market, t_exp, config: SimulationConfig, key):
    """Exact (x_T, ∫₀ᵀ x) per path: (g, paths) each, g = 2 under antithetic.
    One scan over ``config.steps`` exact joint OU transitions."""
    steps, paths = config.steps, config.trajectories
    dt = t_exp / steps
    e1, b_dt, s_x, coef, s_res = hw_step_moments(market.a, market.sigma, dt)
    anti = isinstance(config.variance_reduction, Antithetic)
    base = _base_key(config, key)
    if config.qmc:
        z = _qmc_normals(base, steps, 2, paths)  # (steps, 2, paths)
        z1, z2 = z[:, 0], z[:, 1]
        if anti:
            z1 = jnp.stack([z1, -z1], axis=1)  # (steps, g, paths)
            z2 = jnp.stack([z2, -z2], axis=1)
        else:
            z1, z2 = z1[:, None], z2[:, None]
    else:
        z = jax.random.normal(base, (steps, 2, paths), dtype=jnp.float64)
        z1, z2 = z[:, 0], z[:, 1]
        if anti:
            z1 = jnp.stack([z1, -z1], axis=1)
            z2 = jnp.stack([z2, -z2], axis=1)
        else:
            z1, z2 = z1[:, None], z2[:, None]

    def step(carry, zs):
        x, integ = carry
        zk1, zk2 = zs
        x_new = x * e1 + s_x * zk1
        d_i = x * b_dt + coef * zk1 + s_res * zk2
        return (x_new, integ + d_i), None

    g = z1.shape[1]
    x0 = jnp.zeros((g, paths))
    (x_T, x_int), _ = jax.lax.scan(step, (x0, jnp.zeros_like(x0)), (z1, z2))
    return x_T, x_int


@register_solver(HullWhiteMonteCarlo)
def _solve_hw_mc(prob: PricingProblem, method: HullWhiteMonteCarlo):
    payoff, market = prob.payoff, prob.market_inputs
    _require_hw(market, payoff, "HullWhiteMonteCarlo")
    config = method.config
    if isinstance(payoff, CapFloor):
        from ..utils.pytree import replace as _replace

        # per-period seeds decorrelate the legs (a shared stream would be
        # fine too; independent legs give the tighter strip estimate)
        vals = None
        price = 0.0
        for i, c in enumerate(payoff.caplets()):
            cfg_i = _replace(config, seed=config.seed + 7919 * i)
            sol = _solve_hw_mc(
                _replace(prob, payoff=c), HullWhiteMonteCarlo(cfg_i)
            )
            price = price + sol.price
        return MonteCarloSolution(prob, method, price, vals)
    if isinstance(payoff, ZeroCouponBond):
        t_exp = _yf(market, payoff.maturity)
        terminal = lambda x: jnp.ones_like(x)  # noqa: E731
    elif isinstance(payoff, BondOption):
        t_exp = _yf(market, payoff.expiry)
        t_bond = _yf(market, payoff.bond_maturity)
        cp = payoff.call_put()
        p_t = df_yf(market.rate, t_exp)

        def terminal(x):
            p = hw_bond(p_t, df_yf(market.rate, t_bond), market.a,
                        market.sigma, t_exp, t_bond, x)
            return jnp.maximum(cp * (p - payoff.strike), 0.0)
    elif isinstance(payoff, Caplet):
        t_exp, t_end, k_bond, scale = _caplet_as_zbo(market, payoff)
        cp_bond = -payoff.call_put()
        p_t = df_yf(market.rate, t_exp)

        def terminal(x):
            p = hw_bond(p_t, df_yf(market.rate, t_end), market.a,
                        market.sigma, t_exp, t_end, x)
            return scale * jnp.maximum(cp_bond * (p - k_bond), 0.0)
    else:  # Swaption
        from ..core.payoffs import European

        if not isinstance(payoff.exercise_style, European):
            return _solve_hw_bermudan_lsm(prob, method)
        t_exp, times, c = _swap_legs(market, payoff)
        p_t = df_yf(market.rate, t_exp)
        sign = 1.0 if payoff.payer else -1.0

        def terminal(x):
            p = hw_bond(p_t, df_yf(market.rate, times)[:, None, None],
                        market.a, market.sigma, t_exp, times[:, None, None], x)
            leg = jnp.sum(c[:, None, None] * p, axis=0)
            return payoff.notional * jnp.maximum(sign * (1.0 - leg), 0.0)

    if float(t_exp) <= 0.0:
        # expiry AT the reference date (e.g. a spot-start cap's first
        # period: the fixing is known) — the value is deterministic;
        # hw_step_moments at dt = 0 would produce a 0/0 NaN
        x_T = jnp.zeros((1, config.trajectories))
        x_int = jnp.zeros_like(x_T)
    else:
        x_T, x_int = _hw_paths(market, t_exp, config, None)
    # pathwise stochastic discount — E[it] is the curve df EXACTLY
    disc = df_yf(market.rate, t_exp) * jnp.exp(
        -x_int - 0.5 * market.sigma**2 * hw_gamma(market.a, t_exp)
    )
    vals = disc * terminal(x_T)
    price = jnp.mean(vals, axis=(0, -1))
    return MonteCarloSolution(prob, method, price, vals)


def _hw_kernel(market, t_a, t_b, x_from, x_to, w_to):
    """Discounted transition operator between two dates on the x grid:

        K[i, j] = E[ e^{−∫_{t_a}^{t_b} r du} · 1{x_{t_b} ≈ x_j} | x_{t_a} = x_i ]·w_j

    = (deterministic exp(−∫α) block) × (exact OU Gaussian density) ×
    (E[e^{−∫x} | x_i, x_j] — lognormal in the conditional (∫x | x, x')
    Gaussian) × trapezoid weight.  All closed form; one such matrix per
    exercise-date gap, applied as a single (nodes × nodes) matmul."""
    a, sig = market.a, market.sigma
    delta = t_b - t_a
    e1 = jnp.exp(-a * delta)
    b = hw_b(a, delta)
    v_x = sig**2 * (1.0 - e1 * e1) / (2.0 * a)
    s_x = jnp.sqrt(v_x)
    c = sig**2 * (1.0 - e1) ** 2 / (2.0 * a**2)
    beta = c / v_x
    v_res = jnp.maximum(sig**2 * hw_gamma(a, delta) - c * beta, 0.0)
    det = (
        df_yf(market.rate, t_b) / df_yf(market.rate, t_a)
        * jnp.exp(-0.5 * sig**2 * (hw_gamma(a, t_b) - hw_gamma(a, t_a)))
    )
    diff = x_to[None, :] - x_from[:, None] * e1
    dens = jnp.exp(-0.5 * (diff / s_x) ** 2) / (s_x * jnp.sqrt(2.0 * jnp.pi))
    mu_i_cond = x_from[:, None] * b + beta * diff
    return det * dens * jnp.exp(-mu_i_cond + 0.5 * v_res) * w_to[None, :]


def _swap_intrinsic_on_grid(market, payoff: Swaption, e_j, x):
    """Exercise value at date e_j (yf) on the x grid: the remaining swap's
    fixed+principal leg vs par, co-terminal accruals from e_j."""
    sign = 1.0 if payoff.payer else -1.0
    times = [
        _yf(market, d) for d in payoff.payment_dates
        if _yf(market, d) > e_j + 1e-12
    ]
    prev = [e_j] + times[:-1]
    taus = jnp.asarray([t - p for t, p in zip(times, prev)])
    coup = payoff.strike_rate * taus
    coup = coup.at[-1].add(1.0)
    t_arr = jnp.asarray(times)
    p = hw_bond(
        df_yf(market.rate, e_j), df_yf(market.rate, t_arr)[:, None],
        market.a, market.sigma, e_j, t_arr[:, None], x[None, :],
    )
    leg = jnp.sum(coup[:, None] * p, axis=0)
    return payoff.notional * jnp.maximum(sign * (1.0 - leg), 0.0)


@register_solver(HullWhiteGrid)
def _solve_hw_grid(prob: PricingProblem, method: HullWhiteGrid):
    payoff, market = prob.payoff, prob.market_inputs
    _require_hw(market, payoff, "HullWhiteGrid")
    if not isinstance(payoff, Swaption):
        raise TypeError(
            "HullWhiteGrid prices (Bermudan) Swaptions; ZCBs/bond options/"
            "caplets price on HullWhiteAnalytic / HullWhiteMonteCarlo"
        )
    ex = [_yf(market, t) for t in payoff.exercise_ticks()]
    a, sig = market.a, market.sigma
    s_stat = sig * jnp.sqrt((1.0 - jnp.exp(-2.0 * a * ex[-1])) / (2.0 * a))
    n = method.nodes
    x = jnp.linspace(-method.width, method.width, n) * s_stat
    h = x[1] - x[0]
    w_trap = jnp.full((n,), h).at[0].mul(0.5).at[-1].mul(0.5)

    value = _swap_intrinsic_on_grid(market, payoff, ex[-1], x)
    for j in range(len(ex) - 2, -1, -1):
        cont = _hw_kernel(market, ex[j], ex[j + 1], x, x, w_trap) @ value
        value = jnp.maximum(_swap_intrinsic_on_grid(market, payoff, ex[j], x), cont)
    k0 = _hw_kernel(market, 0.0, ex[0], jnp.zeros((1,)), x, w_trap)
    price = (k0 @ value)[0]
    return AnalyticSolution(prob, method, price)


def _hw_exercise_paths(market, ex_times, config: SimulationConfig, key):
    """Exact path states at the exercise dates: (x (m, g, P), disc (m, g, P))
    with disc the pathwise discount-to-0 P(0,e_j)·exp(−∫x − ½σ²Γ(e_j)) —
    ONE exact joint (x, ∫x) transition per exercise gap (the OU law is
    closed-form over any gap, so no substeps are needed)."""
    a, sig = market.a, market.sigma
    paths = config.trajectories
    anti = isinstance(config.variance_reduction, Antithetic)
    base = _base_key(config, key)
    m = len(ex_times)
    z = jax.random.normal(base, (m, 2, paths), dtype=jnp.float64)
    z = jnp.stack([z, -z], axis=2) if anti else z[:, :, None]  # (m, 2, g, P)
    g = z.shape[2]
    x = jnp.zeros((g, paths))
    integ = jnp.zeros_like(x)
    xs, discs = [], []
    prev = 0.0
    for j, e_j in enumerate(ex_times):
        e1, b_dt, s_x, coef, s_res = hw_step_moments(a, sig, e_j - prev)
        d_i = x * b_dt + coef * z[j, 0] + s_res * z[j, 1]
        x = x * e1 + s_x * z[j, 0]
        integ = integ + d_i
        xs.append(x)
        discs.append(
            df_yf(market.rate, e_j)
            * jnp.exp(-integ - 0.5 * sig**2 * hw_gamma(a, e_j))
        )
        prev = e_j
    return jnp.stack(xs), jnp.stack(discs)


def _solve_hw_bermudan_lsm(prob: PricingProblem, method: HullWhiteMonteCarlo,
                           degree: int = 4):
    """Bermudan swaption by Longstaff-Schwartz under STOCHASTIC discounting
    — the independent MC cross-engine for :class:`HullWhiteGrid`.

    States at exercise dates come from exact OU transitions; the pathwise
    discount D_j is F_j-measurable but NOT a function of x_j alone, so the
    regression target is the FORWARD value h_τ/D_j (whose conditional mean
    given x_j IS the time-j continuation — x is Markov), regressed on an
    x-monomial basis over ITM paths; exercise where the intrinsic exceeds
    the fit.  A frozen suboptimal policy ⇒ a LOWER bound in expectation,
    a few tenths of a percent under the grid price at degree 4."""
    payoff, market = prob.payoff, prob.market_inputs
    config = method.config
    ex_times = [_yf(market, t) for t in payoff.exercise_ticks()]
    xs, discs = _hw_exercise_paths(market, ex_times, config, None)
    m = len(ex_times)
    shape = xs.shape[1:]  # (g, P)
    intr = jnp.stack([
        _swap_intrinsic_on_grid(market, payoff, ex_times[j],
                                xs[j].reshape(-1)).reshape(shape)
        for j in range(m)
    ])
    h = discs * intr  # discounted-to-0 exercise values
    value = h[m - 1]
    from ..math.linalg import cholesky_solve_small

    x_scale = jnp.maximum(market.sigma * jnp.sqrt(ex_times[-1]), 1e-8)
    for j in range(m - 2, -1, -1):
        xj = (xs[j] / x_scale).reshape(-1)
        target = (value / jnp.maximum(discs[j], 1e-300)).reshape(-1)
        w = (intr[j] > 0.0).reshape(-1).astype(jnp.float64)
        phi = xj[:, None] ** jnp.arange(degree + 1)[None, :]
        phw = phi * w[:, None]
        amat = phw.T @ phi
        bvec = phw.T @ target
        ridge = 1e-10 * jnp.eye(degree + 1) * (1.0 + jnp.trace(amat) / (degree + 1))
        beta = cholesky_solve_small(amat + ridge, bvec)
        fitted = (phi @ beta).reshape(shape)
        exercise = (intr[j] > 0.0) & (intr[j] > fitted)
        value = jnp.where(exercise, h[j], value)
    price = jnp.mean(value)
    return MonteCarloSolution(prob, method, price, value)
