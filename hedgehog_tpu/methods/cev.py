"""CEV (constant elasticity of variance) closed-form pricing — a
beyond-reference model family (the reference prices lognormal and Heston
only; src/pricing_methods/black_scholes.jl is its closed-form scope).

dS = (r − q)·S dt + σ·S^β dW, β ∈ (0, 1), absorbing at zero.  The terminal
law is noncentral chi-squared (Cox 1975, Schroder 1989); in Hull's
parameterization, with ν = σ²·(e^{2μ̂(1−β)T} − 1)/(2μ̂(1−β)) (→ σ²T as
μ̂ = r−q → 0):

    a = K^{2(1−β)} / ((1−β)²·ν)
    c = S^{2(1−β)}·e^{2μ̂(1−β)T} / ((1−β)²·ν)
    b = 1/(1−β)

    call = S·e^{−qT}·[1 − F(a; b+2, c)] − K·e^{−rT}·F(c; b, a)

with F(x; k, λ) the noncentral-χ² CDF.  P(S_T > K) = F(c; b, a) prices cash
digitals; the put follows from the same two CDFs (absorption included —
discounted CEV is a true martingale for β < 1, so put-call parity holds and
is asserted in tests against the independent CDF evaluations).

Design: F is the Poisson-mixture series Σ_j pois(j; λ/2)·P(k/2+j, x/2)
evaluated as ONE fixed-trip window of ``terms`` terms centered on the
Poisson mode (static shape; the mode center keeps the window inside the
±10√(λ/2) mass for λ/2 up to ~(terms/20)²), with log-space Poisson weights
and `jax.scipy.special.gammainc` — differentiable in BOTH arguments (XLA
IgammaGradA), so AD greeks flow to spot, σ, r, q AND β.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import gammainc, gammaln

from ..core.payoffs import DigitalOption, European, VanillaOption
from ..core.problems import AnalyticSolution, PricingProblem
from ..core.solve import AbstractPricingMethod, register_solver
from ..market.inputs import market_yearfrac
from ..market.rate_curve import df, zero_rate
from ..utils.pytree import pytree, static_field

__all__ = ["CEVAnalytic", "ncx2_cdf", "cev_call_price", "cev_survival"]


@pytree
class CEVAnalytic(AbstractPricingMethod):
    """Schroder noncentral-χ² closed form for CEV vanillas and digitals.
    ``terms`` sizes the fixed-trip CDF series (mode-centered window)."""

    terms: int = static_field(default=2048)

    @property
    def dynamics(self):
        from ..models.dynamics import CEVDynamics

        return CEVDynamics()


def ncx2_cdf(x, k, lam, terms: int = 2048):
    """Noncentral-χ² CDF P(χ'²_k(λ) ≤ x) as a fixed-trip Poisson-gamma
    series: Σ_j e^{−λ/2}(λ/2)^j/j! · P(k/2 + j, x/2), summed over a
    ``terms``-wide window centered on the Poisson mode ⌊λ/2⌋ (truncation
    error = the Poisson mass outside the window — ≤1e-12 while
    √(λ/2) ≲ terms/14).  Broadcasts over x/k/λ; differentiable in all
    three."""
    x = jnp.asarray(x, jnp.float64)
    k = jnp.asarray(k, jnp.float64)
    lam = jnp.asarray(lam, jnp.float64)
    half = lam / 2.0
    try:  # eager path: refuse a silently-truncated window (λ too large —
        # for CEV that is β pushed toward 1, where BS is the right model)
        need = float(jnp.max(half)) ** 0.5 * 14.0
        if need > terms:
            raise ValueError(
                f"ncx2_cdf window of {terms} terms cannot cover "
                f"noncentrality/2 = {float(jnp.max(half)):.3g} "
                f"(needs ~{int(need) + 1}); raise `terms` "
                "(CEVAnalytic(terms=...)) or move β toward Black-Scholes"
            )
    except (jax.errors.ConcretizationTypeError, TypeError):
        pass  # traced: the window contract is the caller's
    j0 = jnp.maximum(jnp.floor(half) - terms // 2, 0.0)
    j = j0[..., None] + jnp.arange(terms, dtype=jnp.float64)
    log_w = j * jnp.log(jnp.maximum(half[..., None], 1e-300)) - half[..., None] - gammaln(j + 1.0)
    # λ = 0 degenerates to the central χ²: the j = 0 term with weight 1
    w = jnp.where(half[..., None] > 0.0, jnp.exp(log_w), (j == 0.0) * 1.0)
    # double-where: gammainc'(a, 0) = ∞ for a < 1, so the dead x ≤ 0 branch
    # must never see x = 0 or reverse-mode AD turns 0·∞ into NaN
    x_pos = x > 0.0
    x_safe = jnp.where(x_pos, x, 1.0)
    p = gammainc(k[..., None] / 2.0 + j, x_safe[..., None] / 2.0)
    out = jnp.sum(w * p, axis=-1)
    return jnp.where(x_pos, out, 0.0)


def _cev_abc(spot, strike, mu_hat, sigma, beta, T):
    one_b = 1.0 - beta
    e = jnp.exp(2.0 * mu_hat * one_b * T)
    # ν = σ²(e−1)/(2 μ̂ (1−β)), with the exact μ̂ → 0 limit σ²T via expm1
    mu_safe = jnp.where(jnp.abs(mu_hat) > 1e-14, mu_hat, 1.0)
    nu = jnp.where(
        jnp.abs(mu_hat) > 1e-14,
        sigma**2 * jnp.expm1(2.0 * mu_hat * one_b * T) / (2.0 * mu_safe * one_b),
        sigma**2 * T,
    )
    denom = one_b**2 * nu
    a = strike ** (2.0 * one_b) / denom
    c = spot ** (2.0 * one_b) * e / denom
    b = 1.0 / one_b
    return a, b, c


def cev_survival(spot, strike, mu_hat, sigma, beta, T, terms: int = 2048):
    """Risk-neutral P(S_T > K) under CEV (absorption at zero included)."""
    a, b, c = _cev_abc(spot, strike, mu_hat, sigma, beta, T)
    return ncx2_cdf(c, b, a, terms)


def cev_call_price(spot, strike, r, q, sigma, beta, T, discount, terms: int = 2048):
    """Undamped CEV call (Schroder 1989 via Hull's a/b/c); absorbing zero
    boundary, general carry."""
    a, b, c = _cev_abc(spot, strike, r - q, sigma, beta, T)
    stock_leg = spot * jnp.exp(-q * T) * (1.0 - ncx2_cdf(a, b + 2.0, c, terms))
    cash_leg = strike * discount * ncx2_cdf(c, b, a, terms)
    return stock_leg - cash_leg


@register_solver(CEVAnalytic)
def _solve_cev(prob: PricingProblem, method: CEVAnalytic) -> AnalyticSolution:
    from ..market.inputs import CEVInputs, carry_yield

    payoff = prob.payoff
    market = prob.market_inputs
    if not isinstance(market, CEVInputs):
        raise TypeError(
            f"CEVAnalytic prices CEVInputs markets; got {type(market).__name__}"
        )
    if not isinstance(payoff, (VanillaOption, DigitalOption)):
        raise TypeError(
            f"CEVAnalytic prices European vanillas and digitals; "
            f"{type(payoff).__name__} has no CEV closed form here"
        )
    if not isinstance(payoff.exercise_style, European):
        raise TypeError(
            "CEVAnalytic is European-only (use LSM on the CEV Euler grid "
            "for early exercise)"
        )
    T = market_yearfrac(market, payoff.expiry)
    D = df(market.rate, payoff.expiry)
    r = zero_rate(market.rate, payoff.expiry)
    q = carry_yield(market)
    K = payoff.strike
    cp = payoff.call_put()
    if isinstance(payoff, DigitalOption):
        # cash-or-nothing: D·P(S_T > K) for calls; puts pay on the
        # complement, which INCLUDES the absorbed-at-zero mass
        surv = cev_survival(
            market.spot, K, r - q, market.sigma, market.beta, T, method.terms
        )
        price = payoff.cash * D * jnp.where(cp > 0, surv, 1.0 - surv)
    else:
        call = cev_call_price(
            market.spot, K, r, q, market.sigma, market.beta, T, D, method.terms
        )
        # put by parity (discounted CEV is a true martingale under
        # absorption, so C − P = S e^{−qT} − K D holds exactly)
        fwd_leg = market.spot * jnp.exp(-q * T) - K * D
        price = jnp.where(cp > 0, call, call - fwd_leg)
    return AnalyticSolution(prob, method, price)
