"""Finite-difference PDE pricing: a 1-D theta-scheme in spot space.

A pricing-method family the reference does not have (its method set is
analytic/tree/MC/Fourier/LSM — src/Hedgehog.jl:78-90); added because a PDE
engine is the classic complement: one backward solve values EVERY spot level
at once, American exercise is a projection (no regression noise), and
barriers/digitals price without Monte Carlo error.

Discretization (Tavella-Randall style):

- **Space**: a sinh-stretched spot grid clustered at the strike (where the
  terminal kink lives), non-uniform 3-point central differences, and
  branchless Péclet-limited upwinding of the drift wherever a central
  off-diagonal would go negative — the operator stays an M-matrix, so the
  scheme is monotone (no spurious oscillation around digital/barrier
  discontinuities).
- **Time**: theta-scheme (Crank-Nicolson default) with Rannacher startup
  (the first ``rannacher`` steps after expiry fully implicit, restoring
  2nd-order convergence on kinked payoffs), curve-exact per-step forward
  rates, American/Bermudan exercise by projection after each step.
- **Boundaries**: far-field rows drop diffusion (V_SS → 0 at ±n_std·σ√T)
  and one-sided the advection — exact for the linear-in-S asymptotes of
  vanilla payoffs and the constant asymptotes of digitals.  Knock-out
  barriers make the barrier a grid ENDPOINT with a Dirichlet rebate row
  (continuous monitoring, no monitoring-date bias); European knock-ins
  reduce by in-out parity (same identity as the CRR engine).

Design: each time step solves one tridiagonal system by PARALLEL CYCLIC
REDUCTION (math/linalg.tridiag_solve_pcr) — ⌈log₂n⌉ wide stages instead
of a length-n sequential Thomas sweep — inside one ``lax.scan`` over time;
per-step coefficients (local vols, forward rates) are precomputed as scan
inputs, so the loop body is a handful of fused vector ops.  The whole solve
is jit/vmap/grad-compatible.

Greeks: the grid is built under ``stop_gradient`` (the "frozen grid"
convention), so AD flows through the PDE coefficients and the cubic spot
readout only — delta/gamma are derivatives of the C²-continuous natural
cubic readout, vega flows through the diffusion coefficients.  Barrier-level
sensitivities (∂/∂H) do NOT flow here (the barrier is a frozen grid
endpoint); use the closed forms or the bridge MC estimator for those.

Dynamics supported: ``LognormalDynamics`` (flat-vol semantics, like CRR),
``CEVDynamics`` (σ·S^β diffusion on CEVInputs), ``LocalVolDynamics``
(Dupire σ_loc(t, S) from the market's implied surface — the PDE
complement of the LV Monte Carlo in models/local_vol.py).
"""

from __future__ import annotations

from typing import Any

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
from ..core.solve import AbstractPricingMethod, register_solver
from ..market.inputs import carry_yield, market_yearfrac
from ..market.rate_curve import df, df_yf
from ..market.vol_surface import get_vol
from ..math.linalg import tridiag_solve_pcr
from ..models.dynamics import (
    CEVDynamics,
    LocalVolDynamics,
    LognormalDynamics,
    PriceDynamics,
)
from ..utils.pytree import pytree, static_field

__all__ = ["PDEMethod"]


@pytree
class PDEMethod(AbstractPricingMethod):
    """1-D finite-difference theta-scheme (see module docstring).

    ``space_steps``/``time_steps`` set the (N+1)-node spot grid and the
    number of backward steps; ``theta`` the implicitness (0.5 =
    Crank-Nicolson, 1.0 = fully implicit); ``rannacher`` how many startup
    steps run fully implicit; ``n_std`` the grid half-width in terminal
    standard deviations; ``cluster`` the sinh clustering scale as a
    fraction of strike (smaller = tighter node concentration at the kink).
    """

    dynamics: Any = static_field(default=LognormalDynamics())
    space_steps: int = static_field(default=400)
    time_steps: int = static_field(default=200)
    theta: float = static_field(default=0.5)
    rannacher: int = static_field(default=2)
    n_std: float = static_field(default=7.0)
    cluster: float = static_field(default=0.1)
    var_steps: int = static_field(default=64)  # 2-D (Heston ADI) only


def _reference_vol(market, dynamics: PriceDynamics, expiry, strike, T):
    """A scalar lognormal-vol proxy used only for grid sizing."""
    if isinstance(dynamics, CEVDynamics):
        return market.sigma * jnp.maximum(market.spot, 1e-12) ** (market.beta - 1.0)
    # Lognormal / LocalVol: the implied vol at (expiry, strike) sizes the grid
    return get_vol(market.sigma, expiry, strike)


def _sinh_grid(s_lo, s_hi, center, scale, n):
    """n+1 spot nodes on [s_lo, s_hi], sinh-clustered around ``center``."""
    c1 = jnp.arcsinh((s_lo - center) / scale)
    c2 = jnp.arcsinh((s_hi - center) / scale)
    u = jnp.linspace(0.0, 1.0, n + 1)
    s = center + scale * jnp.sinh(c1 + u * (c2 - c1))
    # pin the endpoints exactly (barrier Dirichlet rows sit on them)
    return s.at[0].set(s_lo).at[-1].set(s_hi)


def _local_sigma(market, dynamics: PriceDynamics, sigma_flat, t, s_nodes):
    """σ(t, S) over the grid nodes (price-vol units: dS = … + σ(t,S)·S dW)."""
    if isinstance(dynamics, CEVDynamics):
        return market.sigma * jnp.maximum(s_nodes, 1e-12) ** (market.beta - 1.0)
    if isinstance(dynamics, LocalVolDynamics):
        from ..models.local_vol import dupire_local_vol

        return jax.vmap(lambda s: dupire_local_vol(market, t, s))(s_nodes)
    return jnp.broadcast_to(sigma_flat, s_nodes.shape)


def convection_diffusion_operator(x, dcoef, drift, kill):
    """Tridiagonal generator diagonals (l, m, u) for the 1-D operator

        L·V = dcoef·V_xx + drift·V_x − kill·V

    on the non-uniform grid ``x`` (last axis; ``dcoef``/``drift`` may carry
    leading batch axes, e.g. one operator row per variance level in the
    2-D ADI solver; ``kill`` is a scalar).

    Interior rows: central 3-point differences with branchless
    Péclet-limited upwinding (an off-diagonal that would go negative under
    central advection switches that node to one-sided drift — M-matrix /
    monotone scheme).  Boundary rows: diffusion dropped, one-sided
    advection toward the interior (exact for linear/constant far-field
    asymptotes; also the right degenerate form at a v=0 CIR boundary,
    where the diffusion vanishes and the drift flows inward).
    """
    h = jnp.diff(x)  # (n,)
    h_m = h[:-1]  # h_{i-1} for interior i = 1..n-1
    h_p = h[1:]  # h_i
    mu = drift[..., 1:-1]
    dc = dcoef[..., 1:-1]

    # non-uniform central weights
    w_m = -h_p / (h_m * (h_m + h_p))
    w_p = h_m / (h_p * (h_m + h_p))
    w_0 = -(w_m + w_p)
    v_m = 2.0 / (h_m * (h_m + h_p))
    v_p = 2.0 / (h_p * (h_m + h_p))
    v_0 = -(v_m + v_p)

    l_c = dc * v_m + mu * w_m
    u_c = dc * v_p + mu * w_p
    m_c = dc * v_0 + mu * w_0

    # Péclet-limited upwind fallback (per node, branchless)
    l_uw = dc * v_m + jnp.where(mu < 0.0, -mu / h_m, 0.0)
    u_uw = dc * v_p + jnp.where(mu > 0.0, mu / h_p, 0.0)
    m_uw = dc * v_0 + jnp.where(mu > 0.0, -mu / h_p, mu / h_m)
    need_uw = (l_c < 0.0) | (u_c < 0.0)
    l_i = jnp.where(need_uw, l_uw, l_c)
    u_i = jnp.where(need_uw, u_uw, u_c)
    m_i = jnp.where(need_uw, m_uw, m_c) - kill

    # boundary rows: V_xx = 0, one-sided advection, −kill·V
    mu_lo = drift[..., :1]
    mu_hi = drift[..., -1:]
    zeros = jnp.zeros_like(mu_lo)
    lower = jnp.concatenate([zeros, l_i, -mu_hi / h[-1]], axis=-1)
    upper = jnp.concatenate([mu_lo / h[0], u_i, zeros], axis=-1)
    main = jnp.concatenate(
        [-mu_lo / h[0] - kill, m_i, mu_hi / h[-1] - kill], axis=-1
    )
    return lower, main, upper


def _build_operator(s, sig, r_step, q):
    """BS-generator diagonals on the spot grid (see the generic helper)."""
    return convection_diffusion_operator(
        s, 0.5 * sig**2 * s**2, (r_step - q) * s, r_step
    )


def _terminal_condition(payoff, s_grid):
    """Exact cell-averaged terminal condition (Tavella-Randall projection).

    Pointwise sampling of a kinked/discontinuous payoff makes the scheme's
    constant term depend on where the kink falls inside a cell — an O(h)
    wobble for digitals.  Averaging the payoff over each node's cell
    [(s_{i−1}+s_i)/2, (s_i+s_{i+1})/2] restores smooth O(h²) behavior.  The
    supported payoffs are piecewise linear in S with the single breakpoint
    at the strike, so the averages are closed-form; boundary nodes (far
    from the kink) keep their pointwise values.
    """
    k = jnp.asarray(payoff.strike, jnp.float64)
    cp = payoff.call_put()
    mid = 0.5 * (s_grid[:-1] + s_grid[1:])
    a, b = mid[:-1], mid[1:]  # cells of interior nodes 1..n-1
    w = b - a
    s_i = s_grid[1:-1]
    if isinstance(payoff, DigitalOption):
        if cp > 0:
            avg = payoff.cash * jnp.maximum(b - jnp.maximum(k, a), 0.0) / w
        else:
            avg = payoff.cash * jnp.maximum(jnp.minimum(k, b) - a, 0.0) / w
        slope = jnp.zeros_like(s_i)
    else:  # vanilla intrinsic (BarrierOption.__call__ is the same ramp)
        if cp > 0:
            avg = 0.5 * (jnp.maximum(b - k, 0.0) ** 2
                         - jnp.maximum(a - k, 0.0) ** 2) / w
        else:
            avg = 0.5 * (jnp.maximum(k - a, 0.0) ** 2
                         - jnp.maximum(k - b, 0.0) ** 2) / w
        slope = jnp.where(cp * (s_i - k) > 0.0, cp, 0.0)
    # On a non-uniform grid the mid-cell centroid ≠ the node, so the raw
    # average of even a LINEAR payoff is biased by slope·(centroid − s_i).
    # Subtract that linear part exactly: kink-free cells recover the
    # pointwise value, the kink cell keeps only the smoothing excess.
    v_avg = avg - slope * (0.5 * (a + b) - s_i)
    v = payoff(s_grid)
    return v.at[1:-1].set(v_avg)


def _pde_backward(market, method: PDEMethod, payoff, expiry, s_grid, v_T,
                  dirichlet):
    """Run the backward theta-scheme; returns V(·, t=0) on ``s_grid``.

    ``dirichlet`` is None or ``(side, values)`` with side ∈ {0, -1} and
    ``values`` a (time_steps+1,)-vector pinning that endpoint row at each
    time index (knock-out rebate).
    """
    M = method.time_steps
    T = market_yearfrac(market, expiry)
    dt = T / M
    q = carry_yield(market)
    # CEV markets carry a scale parameter, not a vol surface
    sigma_flat = (
        None if isinstance(method.dynamics, CEVDynamics)
        else get_vol(market.sigma, expiry, payoff.strike)
    )

    # per-step curve-exact forward rates and mid-step local vols (scan xs)
    t_edges = jnp.arange(M + 1) * dt
    log_df = jnp.log(df_yf(market.rate, t_edges))
    r_steps = -(log_df[1:] - log_df[:-1]) / dt  # r over [t_k, t_{k+1}]
    t_mid = (jnp.arange(M) + 0.5) * dt
    if isinstance(method.dynamics, LocalVolDynamics):
        sig_steps = jax.vmap(
            lambda t: _local_sigma(market, method.dynamics, sigma_flat, t, s_grid)
        )(t_mid)
    else:
        sig_row = _local_sigma(market, method.dynamics, sigma_flat, 0.0, s_grid)
        sig_steps = jnp.broadcast_to(sig_row, (M,) + s_grid.shape)

    style = payoff.exercise_style
    is_american = isinstance(style, American)
    is_bermudan = isinstance(style, Bermudan)
    can_exercise = is_american or is_bermudan
    ex_mask = (
        bermudan_step_mask(style, market, expiry, M) if is_bermudan
        else jnp.ones((max(M, 1),), bool)
    )
    intrinsic = payoff(s_grid) if can_exercise else jnp.zeros_like(s_grid)

    rann = min(method.rannacher, M)
    # step index i runs M-1 … 0 (interval [t_i, t_{i+1}]); Rannacher =
    # the FIRST steps walked (nearest expiry): i ≥ M - rannacher
    thetas = jnp.where(jnp.arange(M) >= M - rann, 1.0, method.theta)

    if dirichlet is not None:
        d_side, d_vals = dirichlet
    else:  # static placeholders keep the scan body branch-free to trace
        d_side, d_vals = 0, jnp.zeros((M + 1,))
    has_dirichlet = dirichlet is not None

    divs = getattr(market, "dividends", None)
    if divs is not None:
        from ..market.dividends import dividend_step_amounts

        # cash drop applied at grid time (i+1)·dt — slot i (shared snapping
        # with the grid-MC sampler, so both engines discretize the same
        # piecewise-lognormal model)
        div_steps = dividend_step_amounts(market, T, M)
        # pre-drop exercise at the ex-date t_{i+1}: gate slot i by the
        # NEXT time's exercise right (ex_mask[i] gates t_i; the terminal
        # payoff covers an ex-date landing exactly at expiry)
        ex_mask_end = jnp.concatenate([ex_mask[1:], jnp.zeros((1,), bool)])
    else:
        div_steps = None
        ex_mask_end = None

    def step(v, xs):
        i, r_k, sig_k, th = xs
        if div_steps is not None:
            # jump condition at the ex-date t_{i+1}: the pre-drop value is
            # the post-drop value at the dropped spot, V(t⁻, S) = V(t⁺, S−D)
            # (linear interp keeps the M-matrix monotonicity; clamped ends
            # sit in the far field where V is its asymptote)
            d_i = div_steps[i]
            v_shift = jnp.interp(s_grid - d_i, s_grid, v)
            v = jnp.where(d_i > 0.0, v_shift, v)
            if can_exercise:
                # the holder may exercise the instant BEFORE the drop —
                # the classic just-before-ex-div call exercise; Bermudans
                # get it only when the ex-date t_{i+1} is an exercise date
                gate = True if is_american else ex_mask_end[i]
                v = jnp.where((d_i > 0.0) & gate, jnp.maximum(v, intrinsic), v)
            if has_dirichlet:
                v = v.at[d_side].set(d_vals[i + 1])
        lower, main, upper = _build_operator(s_grid, sig_k, r_k, q)
        # explicit half: (I + (1-θ)·dt·L) v
        v_lo = jnp.concatenate([jnp.zeros((1,)), v[:-1]])
        v_hi = jnp.concatenate([v[1:], jnp.zeros((1,))])
        Lv = lower * v_lo + main * v + upper * v_hi
        rhs = v + (1.0 - th) * dt * Lv
        # implicit half: solve (I - θ·dt·L) v' = rhs
        a_l = -th * dt * lower
        a_m = 1.0 - th * dt * main
        a_u = -th * dt * upper
        if has_dirichlet:
            a_l = a_l.at[d_side].set(0.0)
            a_u = a_u.at[d_side].set(0.0)
            a_m = a_m.at[d_side].set(1.0)
            rhs = rhs.at[d_side].set(d_vals[i])
        v_new = tridiag_solve_pcr(a_l, a_m, a_u, rhs)
        if can_exercise:
            exercised = jnp.maximum(v_new, intrinsic)
            v_new = jnp.where(ex_mask[i], exercised, v_new)
            if has_dirichlet:  # the barrier endpoint is not exercisable
                v_new = v_new.at[d_side].set(d_vals[i])
        return v_new, None

    steps_rev = jnp.arange(M - 1, -1, -1)
    xs = (steps_rev, r_steps[steps_rev], sig_steps[steps_rev], thetas[steps_rev])
    v0, _ = jax.lax.scan(step, v_T, xs)
    return v0


def _readout(s_grid, v0, spot):
    """C²-smooth cubic readout of the t=0 value slice at the live spot."""
    from ..math.interpolation import interp1d

    return interp1d(spot, s_grid, v0, kind="cubic")


def _grid_bounds(market, payoff, sigma_ref, T, n_std):
    """Frozen (stop_gradient) grid bounds covering strike, spot and drift."""
    k = jnp.asarray(payoff.strike, dtype=jnp.float64)
    s0 = jnp.asarray(market.spot, dtype=jnp.float64)
    b = -jnp.log(df(market.rate, payoff.expiry)) / jnp.maximum(T, 1e-12) - carry_yield(market)
    w = n_std * jnp.maximum(sigma_ref, 0.01) * jnp.sqrt(jnp.maximum(T, 1e-12)) + 0.05
    lo = jnp.minimum(jnp.log(k), jnp.log(s0)) - w + jnp.minimum(b, 0.0) * T
    hi = jnp.maximum(jnp.log(k), jnp.log(s0)) + w + jnp.maximum(b, 0.0) * T
    return jnp.exp(lo), jnp.exp(hi)


def _check_supported(prob: PricingProblem, method: PDEMethod):
    payoff = prob.payoff
    if not isinstance(payoff, (VanillaOption, DigitalOption, BarrierOption)):
        raise TypeError(
            "PDEMethod prices vanilla, digital and single-barrier payoffs; "
            "path-dependent payoffs (Asians, lookbacks, doubles) carry "
            "running state the 1-D grid does not — use Monte Carlo"
        )
    if not isinstance(payoff.underlying, Spot):
        raise TypeError("PDEMethod evolves the spot; use Spot underlying")
    if jnp.ndim(payoff.strike) > 0:
        raise TypeError(
            "PDEMethod prices one contract per solve (its grid is built "
            "around the strike); vmap over contracts for grids"
        )
    from ..models.dynamics import HestonDynamics

    if not isinstance(
        method.dynamics,
        (LognormalDynamics, CEVDynamics, LocalVolDynamics, HestonDynamics),
    ):
        raise TypeError(
            f"PDEMethod supports Lognormal/CEV/LocalVol dynamics (1-D grid) "
            f"and Heston (2-D ADI), got {type(method.dynamics).__name__}; "
            "other stochastic-vol/jump models use their MC/Fourier engines"
        )
    if getattr(prob.market_inputs, "dividends", None) is not None and not isinstance(
        method.dynamics, LognormalDynamics
    ):
        raise TypeError(
            "discrete-dividend PDE jump conditions are wired for "
            "LognormalDynamics (a Dupire surface already embeds its own "
            "dividend assumptions); strip the schedule or use "
            "LognormalDynamics"
        )


@register_solver(PDEMethod)
def _solve_pde(prob: PricingProblem, method: PDEMethod) -> PDESolution:
    _check_supported(prob, method)
    payoff = prob.payoff
    market = prob.market_inputs

    from ..models.dynamics import HestonDynamics

    if isinstance(method.dynamics, HestonDynamics):
        from ..market.inputs import HestonInputs

        if not isinstance(market, HestonInputs):
            raise TypeError(
                "PDEMethod(HestonDynamics()) prices HestonInputs markets"
            )
        from .pde2d import solve_pde_heston

        return solve_pde_heston(prob, method)

    if isinstance(payoff, BarrierOption):
        if isinstance(payoff.knock, KnockIn):
            if not isinstance(payoff.exercise_style, European):
                raise TypeError(
                    "early-exercise knock-ins have no in-out parity; price "
                    "them on the CRR hit-time quadrature or barrier LSM"
                )
            return _solve_pde_knock_in(prob, method)
        return _solve_pde_knock_out(prob, method)

    T = market_yearfrac(market, payoff.expiry)
    sigma_ref = _reference_vol(market, method.dynamics, payoff.expiry, payoff.strike, T)
    s_lo, s_hi = _grid_bounds(market, payoff, sigma_ref, T, method.n_std)
    if getattr(market, "dividends", None) is not None:
        # the cash drops push the whole path band down: widen the lower
        # bound by the escrowed fraction so post-drop paths stay on-grid
        from ..market.dividends import escrowed_spot

        frac = jnp.clip(escrowed_spot(market, T) / market.spot, 0.05, 1.0)
        s_lo = s_lo * frac
    scale = method.cluster * jnp.asarray(payoff.strike, jnp.float64)
    s_grid = jax.lax.stop_gradient(
        _sinh_grid(s_lo, s_hi, jnp.asarray(payoff.strike, jnp.float64), scale,
                   method.space_steps)
    )
    v_T = _terminal_condition(payoff, s_grid)
    v0 = _pde_backward(market, method, payoff, payoff.expiry, s_grid, v_T, None)
    price = _readout(s_grid, v0, market.spot)
    return PDESolution(prob, method, price, s_grid, v0)


def _solve_pde_knock_out(prob: PricingProblem, method: PDEMethod) -> PDESolution:
    """Knock-out: the barrier is a grid endpoint with a Dirichlet rebate row
    — continuous monitoring, no monitoring-date bias.  American/Bermudan
    exercise projects on the live region only."""
    payoff = prob.payoff
    market = prob.market_inputs
    if jnp.ndim(payoff.barrier) > 0:
        raise TypeError("PDEMethod prices one (strike, barrier) pair per solve")

    T = market_yearfrac(market, payoff.expiry)
    sigma_ref = _reference_vol(market, method.dynamics, payoff.expiry, payoff.strike, T)
    s_lo, s_hi = _grid_bounds(market, payoff, sigma_ref, T, method.n_std)
    up = isinstance(payoff.direction, Up)
    H = jnp.asarray(payoff.barrier, jnp.float64)
    if up:
        s_hi, d_side = H, -1
    else:
        s_lo, d_side = H, 0
    # cluster at whichever kink the live region contains (the strike if it
    # is inside, else the barrier itself)
    k = jnp.asarray(payoff.strike, jnp.float64)
    center = jnp.clip(k, s_lo, s_hi)
    scale = method.cluster * k
    s_grid = jax.lax.stop_gradient(
        _sinh_grid(s_lo, s_hi, center, scale, method.space_steps)
    )

    M = method.time_steps
    dt = T / M
    R = payoff.rebate
    D_T = df(market.rate, payoff.expiry)
    t_edges = jnp.arange(M + 1) * dt
    if payoff.rebate_at_hit:
        d_vals = jnp.broadcast_to(jnp.asarray(R, jnp.float64), (M + 1,))
    else:
        d_vals = R * D_T / df_yf(market.rate, t_edges)

    v_T = _terminal_condition(payoff, s_grid).at[d_side].set(
        jnp.asarray(R, jnp.float64)
    )
    v0 = _pde_backward(
        market, method, payoff, payoff.expiry, s_grid, v_T, (d_side, d_vals)
    )
    price_live = _readout(s_grid, v0, market.spot)
    # already beyond the barrier at inception → knocked: rebate value at t=0
    knocked0 = (market.spot >= H) if up else (market.spot <= H)
    price = jnp.where(knocked0, d_vals[0], price_live)
    return PDESolution(prob, method, price, s_grid, v0)


def _solve_pde_knock_in(prob: PricingProblem, method: PDEMethod) -> PDESolution:
    """European knock-in by in-out parity on the same engine (crr.py:431):
    KI(R) = vanilla − KO(0) + R·NT, NT = D_T − (KO(rebate=1@expiry) − KO(0))."""
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
    p_van = _solve_pde(PricingProblem(van, market), method).price
    p_ko0 = _solve_pde_knock_out(PricingProblem(ko0, market), method).price
    p_ko1e = _solve_pde_knock_out(PricingProblem(ko1e, market), method).price
    no_touch = df(market.rate, payoff.expiry) - (p_ko1e - p_ko0)
    price = p_van - p_ko0 + payoff.rebate * no_touch
    return PDESolution(prob, method, price, None, None)
