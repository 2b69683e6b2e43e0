"""Carr-Madan Fourier pricing: damped-call transform over the CF of log S_T.

Parity target: reference src/pricing_methods/carr_madan.jl.  The damped
integrand (carr_madan.jl:61-62, :88-92) is

    integrand(v) = e^{-α·logK}/(2π) · ψ(v) · e^{-i·v·logK}
    ψ(v)         = D(T)·φ(v − (α+1)i) / (α² + α − v² + i·v·(2α+1))

with the call price the real part of ∫_{-bound}^{bound} and puts recovered by
parity (:67-68).

Fixed-node quadrature: the reference's adaptive quadgk is not XLA-expressible
(data-dependent subdivision), so we use a fixed-node two-scale panel rule.
The integrand has TWO length scales: an α-driven central peak of width ~1
(the rational denominator) and a CF-decay envelope of width ~1/(σ√T), which
diverges for short-dated/low-vol options — a single Gauss-Legendre rule over
(−bound, bound) needs O(bound) nodes to resolve the peak and silently loses
the price when the bound must grow (measured +0.74 error on a 0.31 price at
T=7d, σ=5% with the naive GL-256 rule).  The panel rule (``quadrature=
"panel"``, default) spends ``nodes`` GL points on the peak [−c, c] and
``nodes//2`` log-substituted GL points on each smooth tail [c, bound] — the
log substitution makes accuracy independent of the bound, so ``bound="auto"``
can scale with 1/(σ_eff√T) for free.  BS-agreement error ≈1e-13 across
T ∈ [2d, 10y] × σ ∈ [2%, 80%], far inside the reference's 1e-6 tolerance
(price_agreement.jl:53); the legacy single-GL rule stays available as
``quadrature="gl"``.  Everything is one fused dot product that jit/vmaps
over strikes and differentiates cleanly (Heston calibration gradients flow
through here).
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp
import numpy as np

from ..core.dates import yearfrac
from ..core.payoffs import require_european
from ..core.problems import CarrMadanSolution, PricingProblem
from ..core.payoffs import parity_transform
from ..core.solve import AbstractPricingMethod, register_solver
from ..market.rate_curve import df
from ..market.inputs import market_yearfrac
from ..market.vol_surface import get_vol
from ..models.dynamics import (
    BatesDynamics,
    HestonDynamics,
    KouJumpDynamics,
    VarianceGammaDynamics,
    LognormalDynamics,
    MertonJumpDynamics,
    terminal_log_cf,
)
from ..utils.pytree import pytree, static_field

__all__ = ["CarrMadan", "carr_madan_error_estimate", "carr_madan_fft_smile"]


def carr_madan_fft_smile(
    prob: "PricingProblem", dynamics=None, *, alpha: float = 1.5,
    eta: float = 0.0125, n: int = 65536, k_window: float = 10.0,
):
    """Whole call smile in ONE FFT (Carr-Madan 1999 §3): returns
    ``(strikes, call_prices)`` on the regular log-strike grid
    k_u = −b + u·2π/(nη), b = π/η, restricted to |k| ≤ ``k_window``.

    The reference integrates per strike (carr_madan.jl:64-65, vmapped here
    by the panel engine); for DENSE smiles (surface construction, smile
    calibration against hundreds of quotes) the FFT prices all grid strikes
    for the cost of one n·log n transform — interpolate in log-strike for
    quotes between grid points.  Simpson-weighted trapezoid in the Fourier
    variable; the default (η, n) resolves the α-peak to ≲1e-6 absolute with
    λ = 2π/(nη) ≈ 0.77% strike spacing (an FFT this size is milliseconds —
    far cheaper than per-strike quadrature for dense grids).

    complex128 throughout.  The strike of ``prob.payoff`` is ignored — the
    market/expiry define the smile.
    """
    payoff = prob.payoff
    require_european(payoff, "carr_madan_fft_smile", spot_only=True)
    market = prob.market_inputs
    D = df(market.rate, payoff.expiry)
    phi = terminal_log_cf(prob, dynamics)

    v = jnp.arange(n) * eta
    psi = D * phi(v - (alpha + 1.0) * 1j) / (
        alpha**2 + alpha - v**2 + 1j * v * (2.0 * alpha + 1.0)
    )
    lam = 2.0 * jnp.pi / (n * eta)
    b = 0.5 * n * lam
    j = jnp.arange(n)
    # Simpson weights 1/3, 4/3, 2/3, …  (Carr-Madan eq. 24 uses 1-based j)
    simpson = (3.0 - (-1.0) ** j - jnp.where(j == 0, 1.0, 0.0)) / 3.0
    x = psi * jnp.exp(1j * b * v) * (eta * simpson)
    # static window: outside |k| ≤ k_window the damping factor e^{−αk}
    # overflows on the deep-left tail and the strikes are absurd anyway
    lo = int(np.ceil((float(-k_window) + b) / (2.0 * np.pi / (n * eta))))
    hi = int(np.floor((float(k_window) + b) / (2.0 * np.pi / (n * eta)))) + 1
    k = (-b + lam * j)[lo:hi]
    calls = jnp.exp(-alpha * k) / jnp.pi * jnp.real(jnp.fft.fft(x))[lo:hi]
    return jnp.exp(k), calls


@pytree
class CarrMadan(AbstractPricingMethod):
    """Carr-Madan method: damping ``alpha``, integration ``bound``, model
    ``dynamics``, ``nodes`` quadrature points (replaces QuadGKJL).

    ``bound`` may be the string "auto": the truncation point then scales
    with the CF decay length, 16/(σ_eff·√T) (σ_eff from the vol surface for
    lognormal dynamics, from the mean integrated variance for Heston) — the
    right choice for short-dated/low-vol options where any fixed bound
    truncates real mass.

    ``engine``: "complex" evaluates the CF in native complex128; "pair"
    evaluates in split real/imag arithmetic (math/complexops.py); "auto"
    resolves to "complex" on every backend.

    ``quadrature``: "panel" (default) = two-scale rule (GL peak panel +
    log-substituted GL tails, accuracy independent of ``bound``);
    "gl" = legacy single Gauss-Legendre rule over (−bound, bound).

    CF-evaluation budget: "gl" evaluates exactly ``nodes`` points; "panel"
    evaluates ``nodes`` peak points plus ``max(32, nodes // 2)`` per tail —
    512 total at the default ``nodes=256``.
    """

    alpha: float = static_field(default=1.0)
    # "auto" is the default: the CF-decay-aware bound (see _auto_bound) is
    # exact to ~1e-12 where a fixed 32.0 loses up to 86bp in
    # Feller-violating Heston corners (the tail decay is LINEAR in u with
    # rate √(1−ρ²)(V0+κθT)/σ, not Gaussian), and the two-scale panel rule
    # makes large bounds free.  Pass a float to pin the reference's
    # fixed-truncation semantics (carr_madan.jl:15-21).
    bound: Any = static_field(default="auto")
    dynamics: Any = static_field(default=LognormalDynamics())
    nodes: int = static_field(default=256)
    engine: str = static_field(default="auto")
    quadrature: str = static_field(default="panel")


def _gl_nodes(bound, n: int):
    x, w = np.polynomial.legendre.leggauss(n)
    return jnp.asarray(x) * bound, jnp.asarray(w) * bound


def _panel_nodes(bound, n: int):
    """Two-scale nodes: n-point GL on the central peak [−c, c] plus
    max(32, n//2) log-substituted GL points on each tail [±c, ±bound]
    (n + 2·max(32, n//2) CF evaluations total).

    The tail substitution v = c·e^t turns the smooth power-law×Gaussian decay
    into a low-order function of t over [0, ln(bound/c)], so node count does
    NOT grow with the bound.  ``bound`` may be traced (auto mode)."""
    bound = jnp.asarray(bound, jnp.float64)
    c = jnp.minimum(8.0, 0.25 * bound)
    xc, wc = np.polynomial.legendre.leggauss(n)
    xt, wt = np.polynomial.legendre.leggauss(max(32, n // 2))
    v_c = jnp.asarray(xc) * c
    w_c = jnp.asarray(wc) * c
    L = jnp.log(bound / c)
    t = 0.5 * L * (jnp.asarray(xt) + 1.0)
    v_t = c * jnp.exp(t)
    w_t = 0.5 * L * jnp.asarray(wt) * v_t  # dv = v dt
    v = jnp.concatenate([v_c, v_t, -v_t])
    w = jnp.concatenate([w_c, w_t, w_t])
    return v, w


def _auto_bound(prob: PricingProblem, dynamics) -> jnp.ndarray:
    """CF-decay-aware truncation: 16 / (σ_eff·√T), floored at 64.

    Always a SCALAR: with an array-strike payoff on a vol surface the
    per-strike σ varies, and the bound takes the widest decay length (the
    smallest σ) — conservative and free, since the panel rule's accuracy is
    bound-independent."""
    market = prob.market_inputs
    T = market_yearfrac(market, prob.payoff.expiry)
    if isinstance(dynamics, LognormalDynamics):
        sigma = get_vol(market.sigma, prob.payoff.expiry, prob.payoff.strike)
        s2 = sigma**2 * T
    elif isinstance(dynamics, (HestonDynamics, BatesDynamics)):
        # mean integrated variance E[∫V] = θT + (V0−θ)(1−e^{−κT})/κ
        s2 = market.theta * T + (market.V0 - market.theta) * (
            1.0 - jnp.exp(-market.kappa * T)
        ) / market.kappa
        if isinstance(dynamics, BatesDynamics):
            # plus the Merton jump envelope λT(μ_J² + σ_J²)
            s2 = s2 + market.jump_intensity * (
                market.jump_mean**2 + market.jump_std**2
            ) * T
        # The Heston CF tail is NOT Gaussian: as |u| → ∞, d ≈ σ√(1−ρ²)|u|
        # and log|φ| → −(√(1−ρ²)/σ)·(V0 + κθT)·|u| — a LINEAR decay rate
        # that collapses in high-σ / low-(V0+κθT) (Feller-violating)
        # corners, where the 16/(σ_eff√T) Gaussian rule truncates live
        # mass (measured +86bp vs the ADI PDE and conditional MC at
        # κ=σ=1, θ=V0=0.04, ρ=−0.9 with the old bound).  Take the max of
        # both envelopes: u* = 34/c puts the linear tail below ~2e-15,
        # and the log-substituted panels make large bounds free.
        c_lin = jnp.sqrt(jnp.maximum(1.0 - market.rho**2, 2.5e-3)) * (
            market.V0 + market.kappa * market.theta * T
        ) / market.sigma
        u_lin = 34.0 / jnp.maximum(c_lin, 1e-8)
        s = jnp.sqrt(jnp.maximum(jnp.min(s2), 1e-16))
        return jnp.clip(jnp.maximum(16.0 / s, u_lin), 64.0, 1e7)
    elif isinstance(dynamics, MertonJumpDynamics):
        # the Gaussian envelope of the Merton CF decays with the total
        # log-variance σ²T + λT(μ_J² + σ_J²)
        s2 = (market.sigma**2
              + market.jump_intensity * (market.jump_mean**2 + market.jump_std**2)) * T
    elif isinstance(dynamics, VarianceGammaDynamics):
        # VG's CF decays POLYNOMIALLY: |φ| ~ (½σ²ν u²)^{−T/ν}; with the
        # integrand's extra 1/u², truncating where the envelope reaches
        # 1e-12 bounds the tail mass — u* = √(2/(σ²ν))·(1e-12)^{−ν/(2T)}
        # (capped: the log-substituted tail panels make big bounds free)
        T_safe = jnp.maximum(T, 1e-6)
        u_star = jnp.sqrt(2.0 / (market.sigma**2 * market.nu)) * jnp.exp(
            (market.nu / (2.0 * T_safe)) * jnp.log(1e12)
        )
        return jnp.clip(u_star, 64.0, 1e7)
    elif isinstance(dynamics, KouJumpDynamics):
        # same envelope with the double-exponential second moment
        # E[J²] = 2p/η₁² + 2(1−p)/η₂²
        ej2 = (2.0 * market.p_up / market.eta_up**2
               + 2.0 * (1.0 - market.p_up) / market.eta_down**2)
        s2 = (market.sigma**2 + market.jump_intensity * ej2) * T
    else:
        # everything else either has no terminal log-price CF at all
        # (rough Bergomi, SLV, CEV, SABR, local vol — Fourier pricing is
        # impossible, matching terminal_log_cf's rejection) or no
        # decay-envelope rule; either way auto cannot choose a bound
        raise TypeError(
            f"no terminal law / CF decay envelope for dynamics "
            f"{type(dynamics).__name__}: bound='auto' supports "
            f"LognormalDynamics, HestonDynamics, BatesDynamics, "
            f"MertonJumpDynamics, VarianceGammaDynamics and KouJumpDynamics"
        )
    s = jnp.sqrt(jnp.maximum(jnp.min(s2), 1e-16))
    return jnp.maximum(64.0, 16.0 / s)


def _quad_nodes(prob: PricingProblem, method: "CarrMadan"):
    bound = method.bound
    if isinstance(bound, str):
        if bound != "auto":
            raise ValueError(
                f"string bound must be 'auto', got {bound!r} (pass a float "
                "for a fixed truncation)"
            )
        if method.quadrature == "gl":
            # the auto bound can reach ~1e9 for short-dated/low-vol inputs;
            # a single Gauss-Legendre rule spreads its nodes over the whole
            # interval and silently misses the O(1)-wide α-peak.  Only the
            # two-scale panel rule is bound-independent.
            raise ValueError(
                "quadrature='gl' cannot resolve the bound='auto' interval "
                "(the α-peak is O(1) wide while the auto bound scales like "
                "16/(σ√T)); use quadrature='panel' or pass a fixed bound"
            )
        bound = _auto_bound(prob, method.dynamics)
    if method.quadrature == "panel":
        return _panel_nodes(bound, method.nodes)
    if method.quadrature == "gl":
        return _gl_nodes(bound, method.nodes)
    raise ValueError(f"unknown quadrature {method.quadrature!r} (use 'panel' or 'gl')")


def _solve_carr_madan_digital(
    prob: PricingProblem, method: CarrMadan, engine: str
) -> CarrMadanSolution:
    """Cash-or-nothing digital via Gil-Pelaez inversion on the same
    quadrature nodes: P(S_T > K) = ½ + (1/π)∫₀^∞ Im[e^{−iu·lnK}φ(u)]/u du.
    The integrand is even in u (φ(−u) = conj φ(u)), so the symmetric
    (−bound, bound) node set integrates it with a single ½·Σ w·g dot
    product; digital puts follow from the cash parity."""
    payoff = prob.payoff
    market = prob.market_inputs
    if method.nodes % 2:
        raise ValueError(
            "digital Carr-Madan needs an even node count (an odd "
            "Gauss-Legendre rule places a node at u=0, where the Gil-Pelaez "
            "integrand's 1/u form is indeterminate)"
        )
    K = payoff.strike
    logK = jnp.log(K)
    D = df(market.rate, payoff.expiry)
    v, w = _quad_nodes(prob, method)
    logK_b = jnp.asarray(logK)[..., None]

    if engine == "pair":
        from ..math.complexops import cmul
        from ..models.dynamics import terminal_log_cf_pair

        phi_pair = terminal_log_cf_pair(prob, method.dynamics)
        phi = phi_pair(v, jnp.zeros_like(v))
        osc = (jnp.cos(v * logK_b), -jnp.sin(v * logK_b))  # e^{-i u lnK}
        g = cmul(phi, osc)[1] / v
    else:
        phi = terminal_log_cf(prob, method.dynamics)
        g = jnp.imag(phi(v + 0.0j) * jnp.exp(-1j * v * logK_b)) / v
    p_itm = 0.5 + (0.5 / jnp.pi) * jnp.sum(w * g, axis=-1)
    call_price = D * payoff.cash * p_itm
    if jnp.ndim(K) == 0:
        call_price = jnp.reshape(call_price, ())
        p_itm = jnp.reshape(p_itm, ())
    price = parity_transform(call_price, payoff, market.spot, market.rate)
    return CarrMadanSolution(prob, method, price, p_itm)


@register_solver(CarrMadan)
def _solve_carr_madan(prob: PricingProblem, method: CarrMadan) -> CarrMadanSolution:
    payoff = prob.payoff
    # European×Spot-only (carr_madan.jl:48)
    require_european(payoff, "CarrMadan", spot_only=True)
    market = prob.market_inputs

    K = payoff.strike
    logK = jnp.log(K)
    alpha = method.alpha
    D = df(market.rate, payoff.expiry)

    engine = "complex" if method.engine == "auto" else method.engine

    from ..core.payoffs import (
        AsianOption,
        BarrierOption,
        DigitalOption,
        DoubleBarrierOption,
        LookbackOption,
    )

    if isinstance(payoff, (BarrierOption, AsianOption, DoubleBarrierOption,
                           LookbackOption)):
        raise TypeError(
            f"CarrMadan prices path-independent payoffs (the CF of log S_T "
            f"carries no path law); {type(payoff).__name__} prices "
            f"analytically under Black-Scholes (where a closed form exists) "
            f"or via grid Monte Carlo"
        )
    if isinstance(payoff, DigitalOption):
        return _solve_carr_madan_digital(prob, method, engine)

    v, w = _quad_nodes(prob, method)
    damp = jnp.exp(-alpha * logK) / (2.0 * jnp.pi)

    # Array strikes: broadcast K against the quadrature axis and reduce over
    # the trailing (nodes) axis only, so strike grids vectorize like the
    # BS/CRR pricers instead of collapsing into one scalar.
    logK_b = jnp.asarray(logK)[..., None]  # (..., 1) vs v: (nodes,)

    if engine == "pair":
        # split-complex evaluation (math/complexops.py)
        from ..math.complexops import cdiv, cmul
        from ..models.dynamics import terminal_log_cf_pair

        phi_pair = terminal_log_cf_pair(prob, method.dynamics)
        # u = v − (α+1)i
        phi = phi_pair(v, jnp.full_like(v, -(alpha + 1.0)))
        denom = (alpha**2 + alpha - v**2, v * (2.0 * alpha + 1.0))
        psi = cdiv((D * phi[0], D * phi[1]), denom)
        osc = (jnp.cos(v * logK_b), -jnp.sin(v * logK_b))  # e^{-i v logK}
        integrand_re = damp[..., None] * cmul(psi, osc)[0]
        call_price = jnp.sum(w * integrand_re, axis=-1)
        integral = call_price
    else:
        # native complex128 (carr_madan.jl:88-92)
        phi = terminal_log_cf(prob, method.dynamics)
        numerator = D * phi(v - (alpha + 1.0) * 1j)
        denominator = alpha**2 + alpha - v**2 + 1j * v * (2.0 * alpha + 1.0)
        integrand = damp[..., None] * (numerator / denominator) * jnp.exp(-1j * v * logK_b)
        integral = jnp.sum(w * integrand, axis=-1)
        call_price = jnp.real(integral)
    if jnp.ndim(K) == 0:
        call_price = jnp.reshape(call_price, ())
        integral = jnp.reshape(integral, ())
    # put parity needs the carry-adjusted (and dividend-escrowed) spot:
    # call − put = S·e^{−qT} − PV(divs) − K·D, NOT raw-spot parity (which
    # overprices puts by S(1 − e^{−qT}) under a dividend yield)
    from ..market.inputs import forward_spot as _fwd_spot

    T_par = market_yearfrac(market, payoff.expiry)
    price = parity_transform(
        call_price, payoff, _fwd_spot(market, T_par), market.rate
    )
    return CarrMadanSolution(prob, method, price, integral)


def carr_madan_error_estimate(prob: PricingProblem, method: CarrMadan) -> dict:
    """Quadrature accuracy diagnostic for a Carr-Madan configuration.

    Returns ``{"price", "refinement", "tail", "total"}`` where ``refinement``
    is the max |Δprice| from doubling the node count (resolution error),
    ``tail`` the max |Δprice| from doubling the bound at the refined node
    count (truncation error), and ``total`` their sum — a practical error
    estimate for the *configured* settings.  ``price`` keeps the payoff's
    strike shape (scalar or grid); the error fields are scalar maxima over
    the grid.  Three solves; intended for validating a configuration against
    an accuracy budget (e.g. before a calibration run on short-dated
    quotes), not for the hot path.

    Addresses the reference's silent-accuracy gap: carr_madan.jl forwards
    solver tolerances blindly and nothing reports what the fixed-parameter
    quadrature actually achieved.
    """
    import dataclasses

    p0 = _solve_carr_madan(prob, method).price
    fine = dataclasses.replace(method, nodes=2 * method.nodes)
    p1 = _solve_carr_madan(prob, fine).price
    if isinstance(method.bound, str):
        # auto mode: widen by re-deriving with half the effective decay rate
        wide_bound = float(2.0 * _auto_bound(prob, method.dynamics))
    else:
        wide_bound = 2.0 * method.bound
    wide = dataclasses.replace(method, nodes=2 * method.nodes, bound=wide_bound)
    p2 = _solve_carr_madan(prob, wide).price
    refinement = float(jnp.max(jnp.abs(p1 - p0)))
    tail = float(jnp.max(jnp.abs(p2 - p1)))
    return {
        "price": p0,
        "refinement": refinement,
        "tail": tail,
        "total": refinement + tail,
    }
