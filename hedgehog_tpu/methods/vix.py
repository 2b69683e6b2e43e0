"""VIX futures and options under Heston — beyond-reference asset class
(volatility derivatives; the reference prices equity vanillas only).

Under Heston, the 30-day forward variance at T is AFFINE in the
instantaneous variance:

    VIX_T² = (2/τ)·E[−log(S_{T+τ}/F) | F_T] = a·V_T + b,
    a = (1 − e^{−κτ})/(κτ),   b = θ·(1 − a),

Under Bates the variance dynamics are unchanged but the CBOE VIX is the
LOG-CONTRACT strip, so the S-jumps add a constant to VIX²:

    b += 2λ·E[e^J − 1 − J] = 2λ·(e^{μ_J+σ_J²/2} − 1 − μ_J)

(the standard jump convexity term; it preserves the affine form, so the
same survival quadrature applies).

and V_T | V₀ is a scaled noncentral χ²: V_T = c̄·χ'²(d, λ) with
c̄ = σ²(1−e^{−κT})/(4κ), d = 4κθ/σ², λ = V₀e^{−κT}/c̄.  Every VIX payoff
is therefore a 1-D integral against that law.  The branchless evaluation uses
the SURVIVAL form (integration by parts — no density, no v→0 singularity
in the Feller-violating regime d < 2):

    E[(√(aV+b) − K)⁺] = (√(a·v_K+b) − K)·S(v_K)
                        + (a/2)·∫_{v_K}^{v_hi} S(v)/√(av+b) dv,

with S = 1 − F the ncx2 survival (methods/cev.py::ncx2_cdf — fixed-trip
mode-centered Poisson-gamma series, differentiable in all parameters),
v_K = max((K² − b)/a, 0), evaluated by fixed Gauss-Legendre nodes.  The
futures price is the K = 0 case.  Smooth end to end → `jax.grad` VIX
greeks in all five Heston parameters work.

Puts by parity: E[(K − X)⁺] = E[(X − K)⁺] + K − E[X].

Parity anchors: deterministic-variance limit (σ_v → 0) collapses to
VIX_T = √(a·m_T + b) with m_T the CIR mean; exact-transition MC
(Poisson-mixed gamma draws) agrees at MC tolerance
(tests/unit/test_vix.py).
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp

from ..core.dates import to_ticks
from ..core.problems import AnalyticSolution, PricingProblem
from ..core.solve import AbstractPricingMethod, register_solver
from ..market.inputs import market_yearfrac
from ..market.rate_curve import df
from ..core.payoffs import Call, CallPut, European, ExerciseStyle
from ..utils.pytree import pytree, static_field
from .cev import ncx2_cdf


def _gauss_legendre(n: int, lo, hi):
    """(nodes, weights) of the n-point Gauss-Legendre rule on the (traced)
    interval [lo, hi] — reference nodes are trace-time numpy constants."""
    import numpy as np

    x, w = np.polynomial.legendre.leggauss(n)
    half = 0.5 * (hi - lo)
    return lo + half * (jnp.asarray(x) + 1.0), half * jnp.asarray(w)

__all__ = [
    "VIXFuture",
    "VIXOption",
    "VIXAnalytic",
    "vix_params",
    "vix_future_price",
    "vix_option_price",
]

#: CBOE convention: 30-day window, ACT/365
_TAU_30D = 30.0 / 365.0


@pytree
class VIXFuture:
    """A VIX futures contract settling at ``expiry`` on the ``tau``-window
    forward volatility, quoted as ``scale``·√(a·V_T + b) (scale 100 = vol
    points).  `solve` returns the (undiscounted) futures price."""

    expiry: Any
    tau: Any = _TAU_30D
    scale: Any = 100.0

    def __post_init__(self):
        object.__setattr__(self, "expiry", to_ticks(self.expiry))


@pytree
class VIXOption:
    """A European option on the VIX index at ``expiry`` (strike in the
    same ``scale`` units as the index, e.g. vol points)."""

    strike: Any
    expiry: Any
    exercise_style: ExerciseStyle = static_field(default=European())
    call_put: CallPut = static_field(default=Call())
    tau: Any = _TAU_30D
    scale: Any = 100.0

    def __post_init__(self):
        object.__setattr__(self, "expiry", to_ticks(self.expiry))


@pytree
class VIXAnalytic(AbstractPricingMethod):
    """Survival-form quadrature over the exact CIR transition law.
    ``nodes`` Gauss-Legendre points over [v_K, mean + ``width``·std];
    ``terms`` sizes the ncx2 series window."""

    nodes: int = static_field(default=128)
    width: float = static_field(default=30.0)
    terms: int = static_field(default=2048)


def vix_params(market, T, tau):
    """(a, b, c̄, d, λ) of the affine VIX² map and the V_T transition law.
    Bates markets fold the jump convexity 2λ(e^{μ+σ²/2} − 1 − μ) into b."""
    kappa, theta, sigma, v0 = market.kappa, market.theta, market.sigma, market.V0
    a = -jnp.expm1(-kappa * tau) / (kappa * tau)
    b = theta * (1.0 - a)
    lam_j = getattr(market, "jump_intensity", None)
    if lam_j is not None:
        kbar = jnp.expm1(market.jump_mean + 0.5 * market.jump_std**2)
        b = b + 2.0 * lam_j * (kbar - market.jump_mean)
    ekt = jnp.exp(-kappa * T)
    c_bar = sigma**2 * -jnp.expm1(-kappa * T) / (4.0 * kappa)
    d = 4.0 * kappa * theta / sigma**2
    lam = v0 * ekt / c_bar
    return a, b, c_bar, d, lam


def _ncx2_survival(x, d, lam, terms):
    """1 − F of χ'²(d, λ), valid for ALL λ: the exact fixed-trip series
    while the mode-centered window covers it (λ ≲ 2(terms/14)²), and a
    one-term Edgeworth (skew-corrected normal) tail beyond — at the
    switch point the skew is ~3/√λ ≈ 1.5%, so the Edgeworth residual is
    O(γ₁²) ≈ 2e-4 and shrinking like 1/λ; the λ → ∞ (σ_v → 0) limit is
    exact.  Both branches stay finite everywhere (series λ clipped), so
    the jnp.where select is AD-safe."""
    lam_max = 1.96 * (terms / 14.0) ** 2  # just inside the series window
    lam_safe = jnp.minimum(lam, lam_max)
    # jax.scipy.special.gammainc has no shape-parameter derivative (NaN
    # tangent), and d = 4κθ/σ² feeds the shape — linearize in d around a
    # stop-gradient point with a central-difference slope so κ/θ/σ greeks
    # flow (exact first-order; the series is analytic in d)
    import jax as _jax

    d_sg = _jax.lax.stop_gradient(d)
    h = 1e-4 * (1.0 + d_sg)
    s_mid = 1.0 - ncx2_cdf(x, d_sg, lam_safe, terms=terms)
    slope = _jax.lax.stop_gradient(
        (ncx2_cdf(x, d_sg - h, lam_safe, terms=terms)
         - ncx2_cdf(x, d_sg + h, lam_safe, terms=terms)) / (2.0 * h)
    )
    series = s_mid + slope * (d - d_sg)
    mu = d + lam
    sig = jnp.sqrt(2.0 * (d + 2.0 * lam))
    z = (x - mu) / sig
    gamma1 = 8.0 * (d + 3.0 * lam) / (2.0 * (d + 2.0 * lam)) ** 1.5
    phi = jnp.exp(-0.5 * z**2) / jnp.sqrt(2.0 * jnp.pi)
    from jax.scipy.stats import norm as _norm

    edge = (1.0 - _norm.cdf(z)) + gamma1 / 6.0 * (z**2 - 1.0) * phi
    edge = jnp.clip(edge, 0.0, 1.0)
    return jnp.where(lam > lam_max, edge, series)


def _expected_vix_excess(market, T, tau, k_tilde, nodes, width, terms):
    """E[(√(a·V_T + b) − k̃)⁺] by the survival-form quadrature (k̃ = 0
    gives E[√(a·V_T + b)] since √b − 0 ≥ 0 handles the boundary term)."""
    a, b, c_bar, d, lam = vix_params(market, T, tau)
    mean_v = c_bar * (d + lam)
    std_v = c_bar * jnp.sqrt(2.0 * (d + 2.0 * lam))
    v_k = jnp.maximum((k_tilde**2 - b) / a, 0.0)
    v_hi = jnp.maximum(mean_v + width * std_v, v_k * (1.0 + 1e-6) + 1e-12)
    # below mean − width·std the survival is 1 to ~e^{−width²/2}: integrate
    # that flat stretch in closed form and spend every quadrature node on
    # the transition window (keeps the near-deterministic σ_v → 0 limit
    # exact instead of asking 128 points to resolve a step)
    v_lo = jnp.clip(mean_v - width * std_v, v_k, v_hi)
    flat = jnp.sqrt(a * v_lo + b) - jnp.sqrt(a * v_k + b)
    x, w = _gauss_legendre(nodes, v_lo, v_hi)
    surv = _ncx2_survival(x / c_bar, d, lam, terms)
    integral = jnp.sum(w * surv / jnp.sqrt(a * x + b), axis=-1) * (a / 2.0)
    s0 = _ncx2_survival(v_k / c_bar, d, lam, terms)
    boundary = (jnp.sqrt(a * v_k + b) - k_tilde) * s0
    return boundary + flat + integral


def vix_future_price(market, T, tau=_TAU_30D, scale=100.0, *,
                     nodes=128, width=30.0, terms=2048):
    """Futures price scale·E[√(a·V_T + b)] (undiscounted, as quoted)."""
    return scale * _expected_vix_excess(market, T, tau, 0.0, nodes, width, terms)


def vix_option_price(market, T, strike, cp=1.0, tau=_TAU_30D, scale=100.0, *,
                     nodes=128, width=30.0, terms=2048):
    """Undiscounted E[(cp·(VIX_T − K))⁺]; puts by parity.  A concrete
    ``cp`` (the solver path — Call/Put are static markers) skips the
    futures quadrature entirely for calls."""
    call = scale * _expected_vix_excess(
        market, T, tau, strike / scale, nodes, width, terms
    )
    if isinstance(cp, (bool, int, float)):
        if cp > 0:
            return call
        fut = vix_future_price(market, T, tau, scale, nodes=nodes,
                               width=width, terms=terms)
        return call + strike - fut
    fut = vix_future_price(market, T, tau, scale, nodes=nodes, width=width,
                           terms=terms)
    return jnp.where(cp > 0, call, call + strike - fut)


@register_solver(VIXAnalytic)
def _solve_vix(prob: PricingProblem, method: VIXAnalytic) -> AnalyticSolution:
    """VIX derivatives on a Heston/Bates market (the variance block is all
    that enters).  Futures prices are quoted (undiscounted); options are
    discounted at the market curve."""
    payoff = prob.payoff
    market = prob.market_inputs
    from ..market.inputs import BatesInputs, HestonInputs

    # an explicit whitelist, not duck-typing: SLVInputs also carries a
    # (kappa, theta, sigma, V0) block but its variance has vol-of-vol
    # mixing·σ and its VIX is E[L²V], not affine in V — silently pricing
    # it as pure Heston would be materially wrong
    if not isinstance(market, (HestonInputs, BatesInputs)):
        raise TypeError(
            f"VIXAnalytic needs a CIR variance block with pure Heston/Bates "
            f"dynamics (HestonInputs/BatesInputs); got "
            f"{type(market).__name__}"
        )
    T = market_yearfrac(market, payoff.expiry)
    if isinstance(payoff, VIXFuture):
        price = vix_future_price(
            market, T, payoff.tau, payoff.scale,
            nodes=method.nodes, width=method.width, terms=method.terms,
        )
        return AnalyticSolution(prob, method, price)
    if isinstance(payoff, VIXOption):
        if not isinstance(payoff.exercise_style, European):
            raise TypeError("VIX options are European-exercise only")
        undisc = vix_option_price(
            market, T, payoff.strike, payoff.call_put(), payoff.tau,
            payoff.scale, nodes=method.nodes, width=method.width,
            terms=method.terms,
        )
        price = df(market.rate, payoff.expiry) * undisc
        return AnalyticSolution(prob, method, price)
    raise TypeError(
        f"VIXAnalytic prices VIXFuture/VIXOption payoffs, got "
        f"{type(payoff).__name__}"
    )
