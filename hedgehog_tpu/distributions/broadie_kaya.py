"""Broadie-Kaya exact Heston terminal sampling, fully batched.

Parity target: reference src/distributions/heston.jl:76-300 and
src/distributions/sample_from_cf.jl — the 3-step recipe:

  1. V_T  ~ c·χ'²(d, λ)  (noncentral chi-squared, heston.jl:125-133)
  2. ∫V dt | V0,V_T  by Fourier inversion of its characteristic function
     (heston.jl:150-212; sample_from_cf.jl)
  3. log S_T | V_T, ∫V  conditionally Gaussian (heston.jl:278-300)

Batched redesign (SURVEY §7 step 9):

- χ'² via the Poisson-mixture representation: N~Poisson(λ/2),
  V_T = c·2·Gamma(d/2+N) — both samplers exist in jax.random, fully batched.
- Step 2 is the *generic* CF-inversion machinery of
  distributions/sample_from_cf.py (moment-matched h, trapezoid CDF series,
  fixed-trip bisection), driven by the Heston ∫V conditional CF below.  The
  Bessel angle-unwrapping state — the sequential part of the reference
  algorithm — is threaded through the series scan as the CF carry.
- Complex-argument log I_ν(z) lives in math/besseli.py (series + uniform
  large-p expansion with Stokes smoothing, accurate to ≲1e-6 for the orders
  ν = 2κθ/σ² − 1 ≲ 40 that market Heston parameters produce).

The CF machinery is complex128 and runs on the device like every other
sampler.  The flagship price path is the exact-transition mixing estimator;
BK is the high-accuracy oracle, exactly the role it plays in the reference
(heston.jl:246-300).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.dates import yearfrac
from ..market.rate_curve import zero_rate
from ..market.inputs import market_yearfrac
from ..math.besseli import log_besseli_complex
from .sample_from_cf import cdf_series_weights, invert_cdf_series

__all__ = [
    "log_besseli_complex",
    "sample_noncentral_chisq",
    "heston_integrated_variance_weights",
    "heston_integrated_variance_cf",
    "broadie_kaya_terminal_prices",
]


def sample_noncentral_chisq(key, d, lam, shape):
    """χ'²(d, λ) draws via Poisson(λ/2)-mixed central Gamma: χ'² = 2·Γ(d/2+N).

    Replaces Distributions.NoncentralChisq (heston.jl:131)."""
    k_pois, k_gamma = jax.random.split(key)
    n = jax.random.poisson(k_pois, lam / 2.0, shape)
    alpha = d / 2.0 + n.astype(jnp.float64)
    return 2.0 * jax.random.gamma(k_gamma, alpha, shape, dtype=jnp.float64)


def heston_integrated_variance_cf(VT, V0, kappa, theta_lt, sigma, T):
    """The conditional CF of ∫₀ᵀ V dt given (V0, V_T) as a *stateful* CF
    ``cf(a, theta_prev) -> (φ(a), theta_unwrapped)`` for sample_from_cf
    (heston.jl:150-212).  Vectorized over paths (VT is (paths,)).

    Returns (cf, carry0) where the carry is the unwrapped Bessel angle."""
    d = 4.0 * kappa * theta_lt / sigma**2
    nu = 0.5 * d - 1.0
    em = -jnp.expm1(-kappa * T)  # 1 - e^{-κT}
    zeta_k = em / kappa
    eta_k = kappa * (1.0 + jnp.exp(-kappa * T)) / em
    nu_k = jnp.sqrt(V0 * VT) * 4.0 * kappa * jnp.exp(-0.5 * kappa * T) / (sigma**2 * em)
    log_I_k = log_besseli_complex(nu, nu_k, jnp.zeros_like(nu_k))

    def cf(a, theta_prev):
        """φ(a) with Bessel-angle unwrapping threaded (heston.jl:184-212).

        ``a`` is a (possibly path-batched) scalar frequency or a
        (B, *batch) block of *increasing* frequencies (sample_from_cf block
        protocol); for a block, the angle unwrap runs as an in-block cumsum
        chained off the carry.  Block detection compares against the BATCH
        rank (a path-batched scalar frequency has the same ndim as the
        batched state — ndim alone cannot distinguish them)."""
        a_c = jnp.asarray(a, jnp.complex128)
        block = a_c.ndim > jnp.ndim(nu_k)
        gamma = jnp.sqrt(kappa**2 - 2.0 * sigma**2 * a_c * 1j)
        e_g = jnp.exp(-gamma * T)
        zeta_g = (1.0 - e_g) / gamma
        eta_g = gamma * (1.0 + e_g) / (1.0 - e_g)
        nu_g = (
            jnp.sqrt(V0 * VT) * 4.0 * gamma * jnp.exp(-0.5 * gamma * T)
            / (sigma**2 * (1.0 - e_g))
        )

        first = jnp.exp(-0.5 * (gamma - kappa) * T) * (zeta_k / zeta_g)
        second = jnp.exp((V0 + VT) / sigma**2 * (eta_k - eta_g))

        theta = jnp.angle(nu_g)
        if block:
            prev = jnp.concatenate([jnp.broadcast_to(theta_prev, theta[:1].shape), theta[:-1]], axis=0)
            delta = theta - prev
            delta = delta - 2.0 * jnp.pi * jnp.round(delta / (2.0 * jnp.pi))
            theta_unwrapped = theta_prev + jnp.cumsum(delta, axis=0)
            carry_out = theta_unwrapped[-1]
        else:
            delta = theta - theta_prev
            delta = delta - 2.0 * jnp.pi * jnp.round(delta / (2.0 * jnp.pi))
            theta_unwrapped = theta_prev + delta
            carry_out = theta_unwrapped
        log_I_g = log_besseli_complex(nu, jnp.abs(nu_g), theta_unwrapped)
        return first * second * jnp.exp(log_I_g - log_I_k), carry_out

    carry0 = jnp.angle(nu_k + 0j)  # real-axis start for the unwrapping
    return cf, carry0


def heston_integrated_variance_weights(VT, V0, kappa, theta_lt, sigma, T, n_terms: int):
    """Per-path CFSeries (mean, std, h, weights) of the ∫V CDF series —
    the generic cdf_series_weights applied to the Heston conditional CF.

    CDF(x) = h·x/π + Σ_{j=1..J} w_j·sin(h·j·x),  w_j = (2/π)·Re φ(h·j)/j
    (sample_from_cf.jl:75-96), with h = π/(mean + 5·std) (:37).
    """
    cf, carry0 = heston_integrated_variance_cf(VT, V0, kappa, theta_lt, sigma, T)
    block = 8 if n_terms % 8 == 0 else 1
    return cdf_series_weights(cf, n_terms, carry0=carry0, block_size=block)


def _bk_terminal_from_params(
    key, S0, V0, kappa, theta_lt, sigma, rho, r, T, n, antithetic, cf_terms, iters
):
    """Pure-array BK sampler: (n_groups, n) terminal prices."""
    k_vt, k_u, k_z = jax.random.split(key, 3)

    # Step 1: V_T ~ c·χ'²(d, λ) (heston.jl:125-133)
    em = -jnp.expm1(-kappa * T)
    d = 4.0 * kappa * theta_lt / sigma**2
    lam = 4.0 * kappa * jnp.exp(-kappa * T) * V0 / (sigma**2 * em)
    c = sigma**2 * em / (4.0 * kappa)
    VT = c * sample_noncentral_chisq(k_vt, d, lam, (n,))

    # Step 2: ∫V | V0, V_T via generic CF inversion (one scan for series
    # weights, one fixed bisection for the inverse CDF)
    series = heston_integrated_variance_weights(VT, V0, kappa, theta_lt, sigma, T, cf_terms)
    u = jax.random.uniform(k_u, (n,), dtype=jnp.float64, minval=1e-12, maxval=1.0 - 1e-12)
    integral_V = invert_cdf_series(u, series, iters=iters)

    # Step 3: log S_T | V_T, ∫V conditionally Gaussian (heston.jl:278-300)
    mu = (
        jnp.log(S0)
        + r * T
        - 0.5 * integral_V
        + (rho / sigma) * (VT - V0 - kappa * theta_lt * T + kappa * integral_V)
    )
    cond_std = jnp.sqrt(jnp.maximum((1.0 - rho**2) * integral_V, 0.0))
    z = jax.random.normal(k_z, (n,), dtype=jnp.float64)
    if antithetic:
        zs = jnp.stack([z, -z])
    else:
        zs = z[None]
    return jnp.exp(mu + cond_std * zs)


def broadie_kaya_terminal_prices(prob, config, strat, key=None):
    """Terminal Heston prices (n_groups, paths) by exact BK sampling.

    Antithetic pairs share (V_T, ∫V) and negate the conditional Gaussian of
    step 3 (heston.jl:296-297 ``antithetic ? -Z : Z``).
    """
    from ..methods.montecarlo import Antithetic  # avoid circular import

    from ..market.inputs import forward_spot

    market = prob.market_inputs
    T = market_yearfrac(market, prob.payoff.expiry)
    r = zero_rate(market.rate, prob.payoff.expiry)
    params = (
        # dividend carry via the effective spot — exact for the terminal law
        forward_spot(market, T),
        market.V0,
        market.kappa,
        market.theta,
        market.sigma,
        market.rho,
        r,
        T,
    )
    n = config.trajectories
    antithetic = isinstance(config.variance_reduction, Antithetic)

    if key is None:
        key = jax.random.PRNGKey(config.seed)
    S0, V0, kappa, theta_lt, sigma, rho, r, T = params
    return _bk_terminal_from_params(
        key, S0, V0, kappa, theta_lt, sigma, rho, r, T,
        n, antithetic, strat.cf_terms, strat.inversion_iters,
    )
