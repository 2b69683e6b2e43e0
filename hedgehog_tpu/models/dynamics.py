"""Price dynamics: model markers, terminal (marginal) laws and characteristic
functions.

Parity targets: reference src/pricing_methods/montecarlo.jl:1-22 (dynamics
markers), :286-320 (marginal laws), and src/distributions/heston.jl:307-319
(Heston characteristic function of log S_T).

The reference's LognormalDynamics marginal law computes the log-price mean as
``log S0 + (r − σ²/2)·√α`` (montecarlo.jl:302) — a latent bug that is exact
only when α == 1 (all its tests use T=1).  We implement the correct
``(r − σ²/2)·α`` drift; the agreement suite covers maturities ≠ 1.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.dates import yearfrac
from ..market.rate_curve import zero_rate
from ..market.inputs import market_yearfrac
from ..market.vol_surface import get_vol
from ..utils.pytree import pytree

__all__ = [
    "PriceDynamics",
    "LognormalDynamics",
    "HestonDynamics",
    "BatesDynamics",
    "MertonJumpDynamics",
    "KouJumpDynamics",
    "VarianceGammaDynamics",
    "NormalDynamics",
    "RoughBergomiDynamics",
    "HestonHullWhiteDynamics",
    "CEVDynamics",
    "SABRDynamics",
    "LocalVolDynamics",
    "SLVDynamics",
    "lognormal_terminal_law",
    "merton_terminal_params",
    "heston_cf",
    "bates_jump_factor",
    "lognormal_cf",
    "merton_cf",
    "kou_cf",
    "vg_cf",
    "vg_terminal_params",
    "kou_terminal_params",
    "terminal_log_cf",
    "log_dynamics",
]


def log_dynamics(method) -> "PriceDynamics":
    """Dynamics assumed by a pricing method (reference log_dynamics,
    black_scholes.jl:18-20; for methods carrying a dynamics field, that
    field)."""
    if hasattr(method, "dynamics"):
        return method.dynamics
    from ..methods.black_scholes import BlackScholesAnalytic

    if isinstance(method, BlackScholesAnalytic):
        return LognormalDynamics()
    raise TypeError(f"no log dynamics for {type(method).__name__}")


class PriceDynamics:
    """Marker base for price processes."""


@pytree
class LognormalDynamics(PriceDynamics):
    """Geometric Brownian motion (Black-Scholes)."""


@pytree
class HestonDynamics(PriceDynamics):
    """Heston stochastic volatility (CIR variance)."""


@pytree
class LocalVolDynamics(PriceDynamics):
    """Dupire local volatility (beyond-reference model family): GBM with a
    state/time-dependent volatility σ_loc(S, t) derived from the market's
    implied-vol surface (models/local_vol.py).  Markets are ordinary
    :class:`BlackScholesInputs` whose ``sigma`` is a surface; by
    construction LV Monte Carlo reprices the surface's own vanillas."""


@pytree
class CEVDynamics(PriceDynamics):
    """Constant elasticity of variance (beyond-reference model family):
    dS = (r − q)·S dt + σ·S^β dW, β ∈ (0, 1), absorbing at zero.  No
    log-price CF exists (the law carries an atom at zero) — Fourier
    methods raise; pricing runs through :class:`CEVAnalytic` (Schroder
    noncentral-χ² closed form) or price-space Euler Monte Carlo.  Markets
    carry :class:`CEVInputs`."""


@pytree
class SABRDynamics(PriceDynamics):
    """SABR stochastic-volatility dynamics (beyond-reference model family):
    dF = α F^β dW₁, dα = ν α dW₂ on the T-forward.  No tractable CF —
    Fourier methods raise; pricing runs through :class:`SABRAnalytic`
    (Hagan's expansion) or Euler Monte Carlo.  Markets carry
    :class:`SABRInputs`."""


@pytree
class SLVDynamics(PriceDynamics):
    """Stochastic-local-vol dynamics (beyond-reference model family):
    Heston variance with a Gyöngy/Dupire leverage L(t, S) so the model
    reprices the market vanilla surface at any mixing fraction
    (models/slv.py).  Leverage breaks affinity — no CF, Fourier methods
    raise; pricing runs through Euler Monte Carlo on a calibrated
    :class:`SLVInputs` market."""


@pytree
class BatesDynamics(PriceDynamics):
    """Bates (1996) stochastic-volatility jump-diffusion — Heston variance
    plus Merton lognormal jumps, the production equity smile model.
    Markets carry :class:`BatesInputs`."""


@pytree
class MertonJumpDynamics(PriceDynamics):
    """Merton (1976) lognormal jump-diffusion (beyond-reference model
    family): dS/S = (r − λκ̄)dt + σ dW + (e^J − 1)dN with J ~ N(μ_J, σ_J²),
    N a Poisson(λ) counting process and κ̄ = e^{μ_J + σ_J²/2} − 1 the
    martingale compensator.  Markets carry :class:`MertonInputs`."""


@pytree
class KouJumpDynamics(PriceDynamics):
    """Kou (2002) double-exponential jump-diffusion (beyond-reference model
    family): lognormal diffusion plus compound-Poisson jumps with
    asymmetric double-exponential sizes — the model behind the classic
    leptokurtic smile/skew fits.  Markets carry :class:`KouInputs`."""


@pytree
class VarianceGammaDynamics(PriceDynamics):
    """Variance Gamma (Madan-Carr-Chang 1998) pure-jump Lévy dynamics —
    Brownian motion with drift time-changed by a gamma subordinator
    (infinite activity, finite variation).  Markets carry
    :class:`VarianceGammaInputs`."""


@pytree
class HestonHullWhiteDynamics(PriceDynamics):
    """Heston variance + Hull-White stochastic short rate on the equity
    (beyond-reference hybrid; markets carry :class:`HestonHullWhiteInputs`).
    No closed form or simple CF under correlation — pricing runs through
    the three-factor conditional mixing Monte Carlo (W_v ⊥ W_r, so logS_T
    given the (V, x) paths is exactly normal)."""


@pytree
class RoughBergomiDynamics(PriceDynamics):
    """Rough Bergomi dynamics (beyond-reference model family): instantaneous
    variance driven by a Riemann-Liouville fractional BM with Hurst index
    H < ½ — NON-Markovian, so there is no SDE state, no characteristic
    function and no closed form; pricing runs through Monte Carlo only
    (the exact-Volterra mixing estimator or grid paths, see
    models/rough_bergomi.py).  Markets carry :class:`RoughBergomiInputs`."""


@pytree
class NormalDynamics(PriceDynamics):
    """Bachelier / normal dynamics (beyond-reference model family): the
    T-forward follows arithmetic Brownian motion dF = σ_N dW (σ_N in PRICE
    units), so F_T = F₀ + σ_N W_T can go negative — the rates/commodities
    convention for low or negative underlyings.  No log-price CF exists
    (the law has full real support) — Fourier methods raise; pricing runs
    through :class:`BachelierAnalytic` or Monte Carlo.  Markets carry
    :class:`BachelierInputs`."""


def lognormal_terminal_law(market, expiry_ticks):
    """(mean, std) of log S_T under risk-neutral GBM at ``expiry_ticks``.

    Uses the zero rate to expiry so the discounted expectation matches
    ``spot / df(T)`` exactly on non-flat curves (montecarlo.jl:293-303).
    """
    from ..market.vol_surface import FlatVolSurface

    from ..market.inputs import carry_yield

    r = zero_rate(market.rate, expiry_ticks)
    if isinstance(market.sigma, FlatVolSurface):
        sigma = market.sigma.sigma
    else:
        sigma = get_vol(market.sigma, expiry_ticks, market.spot)  # ATM lookup
    T = market_yearfrac(market, expiry_ticks)
    # dividend carry: drift r − q (equivalently the q=0 law started at
    # spot·e^{−qT} — exact for the terminal law); discrete cash dividends
    # enter as the escrowed spot S0 − PV(divs ≤ T) (market/dividends.py),
    # so exp(mean + std²/2)·df(T) == forward_spot(market, T) always holds
    spot = market.spot
    if getattr(market, "dividends", None) is not None:
        from ..market.dividends import escrowed_spot

        spot = escrowed_spot(market, T)
    mean = jnp.log(spot) + (r - carry_yield(market) - 0.5 * sigma**2) * T
    std = sigma * jnp.sqrt(T)
    return mean, std


def merton_terminal_params(market, expiry_ticks):
    """(log_s0, r, T, sigma, lam, mu_j, s_j, kbar) for a Merton market at an
    expiry: everything the CF/series/samplers need, derived once.  κ̄ is the
    jump compensator e^{μ_J + σ_J²/2} − 1."""
    from ..market.inputs import carry_yield

    r = zero_rate(market.rate, expiry_ticks)
    T = market_yearfrac(market, expiry_ticks)
    kbar = jnp.expm1(market.jump_mean + 0.5 * market.jump_std**2)
    # dividend carry enters as the effective log-spot log(S0) − qT (the
    # drift r stays the DISCOUNTING rate downstream)
    log_s0 = jnp.log(market.spot) - carry_yield(market) * T
    return (log_s0, r, T, market.sigma,
            market.jump_intensity, market.jump_mean, market.jump_std, kbar)


def bates_jump_factor(u, lam, mu_j, s_j, T):
    """Jump multiplier of the Bates CF: exp(λT(e^{iuμ_J − ½u²σ_J²} − 1)
    − iu·λκ̄T) — the Merton jump block with its martingale compensator."""
    kbar = jnp.expm1(mu_j + 0.5 * s_j**2)
    iu = 1j * u
    return jnp.exp(
        lam * T * (jnp.exp(iu * mu_j - 0.5 * u**2 * s_j**2) - 1.0)
        - iu * lam * kbar * T
    )


def kou_terminal_params(market, expiry_ticks):
    """(log_s0, r, T, sigma, lam, p, eta1, eta2, kbar) for a Kou market —
    κ̄ = p·η₁/(η₁−1) + (1−p)·η₂/(η₂+1) − 1; carry folds into log_s0 as for
    Merton (the drift r stays the DISCOUNTING rate downstream)."""
    from ..market.inputs import carry_yield

    r = zero_rate(market.rate, expiry_ticks)
    T = market_yearfrac(market, expiry_ticks)
    p, e1, e2 = market.p_up, market.eta_up, market.eta_down
    kbar = p * e1 / (e1 - 1.0) + (1.0 - p) * e2 / (e2 + 1.0) - 1.0
    log_s0 = jnp.log(market.spot) - carry_yield(market) * T
    return (log_s0, r, T, market.sigma, market.jump_intensity, p, e1, e2, kbar)


def vg_terminal_params(market, expiry_ticks):
    """(log_s0, r, T, sigma, nu, theta, omega) for a VG market — the
    martingale correction ω = ln(1 − θν − σ²ν/2)/ν; carry folds into
    log_s0 (the drift r stays the DISCOUNTING rate downstream)."""
    from ..market.inputs import carry_yield

    r = zero_rate(market.rate, expiry_ticks)
    T = market_yearfrac(market, expiry_ticks)
    sigma, nu, theta = market.sigma, market.nu, market.theta
    omega = jnp.log(1.0 - theta * nu - 0.5 * sigma**2 * nu) / nu
    log_s0 = jnp.log(market.spot) - carry_yield(market) * T
    return (log_s0, r, T, sigma, nu, theta, omega)


def vg_cf(u, log_s0, r, T, sigma, nu, theta, omega):
    """Variance Gamma CF of log S_T:
    φ(u) = e^{iu·(log S0 + (r + ω)T)} · (1 − iuθν + ½σ²ν u²)^{−T/ν}.
    ``u`` may be complex (Carr-Madan evaluates at v − (α+1)i)."""
    u = jnp.asarray(u)
    if not jnp.iscomplexobj(u):
        u = u.astype(jnp.complex128)
    rdt = jnp.finfo(u.dtype).dtype
    log_s0, r, T, sigma, nu, theta, omega = (
        jnp.asarray(x, rdt) for x in (log_s0, r, T, sigma, nu, theta, omega)
    )
    iu = 1j * u
    drift = log_s0 + (r + omega) * T
    base = 1.0 - iu * theta * nu + 0.5 * sigma**2 * nu * u**2
    return jnp.exp(iu * drift) * base ** (-T / nu)


def vg_cf_pair(u_re, u_im, log_s0, r, T, sigma, nu, theta, omega):
    """VG CF in split-complex (re, im) pairs for the "pair" Carr-Madan
    engine; math identical to :func:`vg_cf` (complex power via clog/cexp)."""
    from ..math.complexops import cexp, clog, cmul

    iu = (-u_im, u_re)
    u2 = (u_re * u_re - u_im * u_im, 2.0 * u_re * u_im)
    drift = log_s0 + (r + omega) * T
    base = (1.0 - iu[0] * theta * nu + 0.5 * sigma**2 * nu * u2[0],
            -iu[1] * theta * nu + 0.5 * sigma**2 * nu * u2[1])
    powed = cexp(tuple((-T / nu) * c for c in clog(base)))
    return cmul(cexp((-u_im * drift, u_re * drift)), powed)


def kou_cf(u, log_s0, r, T, sigma, lam, p, e1, e2, kbar):
    """Kou CF of log S_T:
    φ(u) = exp(iu·(log S0 + (r − σ²/2 − λκ̄)T) − ½u²σ²T
               + λT·(p·η₁/(η₁ − iu) + (1−p)·η₂/(η₂ + iu) − 1)).
    ``u`` may be complex (Carr-Madan evaluates at v − (α+1)i)."""
    u = jnp.asarray(u)
    if not jnp.iscomplexobj(u):
        u = u.astype(jnp.complex128)
    rdt = jnp.finfo(u.dtype).dtype
    log_s0, r, T, sigma, lam, p, e1, e2, kbar = (
        jnp.asarray(x, rdt) for x in (log_s0, r, T, sigma, lam, p, e1, e2, kbar)
    )
    iu = 1j * u
    drift = log_s0 + (r - 0.5 * sigma**2 - lam * kbar) * T
    phi_j = p * e1 / (e1 - iu) + (1.0 - p) * e2 / (e2 + iu)
    return jnp.exp(iu * drift - 0.5 * u**2 * sigma**2 * T + lam * T * (phi_j - 1.0))


def kou_cf_pair(u_re, u_im, log_s0, r, T, sigma, lam, p, e1, e2, kbar):
    """Kou CF in split-complex (re, im) pairs for the "pair" Carr-Madan
    engine; math identical to :func:`kou_cf`."""
    from ..math.complexops import cdiv, cexp

    iu = (-u_im, u_re)
    u2 = (u_re * u_re - u_im * u_im, 2.0 * u_re * u_im)
    drift = log_s0 + (r - 0.5 * sigma**2 - lam * kbar) * T
    one_up = cdiv((p * e1, jnp.zeros_like(u_re)), (e1 - iu[0], -iu[1]))
    one_dn = cdiv(((1.0 - p) * e2, jnp.zeros_like(u_re)), (e2 + iu[0], iu[1]))
    phi_j = (one_up[0] + one_dn[0], one_up[1] + one_dn[1])
    expo = (
        iu[0] * drift - 0.5 * sigma**2 * T * u2[0] + lam * T * (phi_j[0] - 1.0),
        iu[1] * drift - 0.5 * sigma**2 * T * u2[1] + lam * T * phi_j[1],
    )
    return cexp(expo)


def merton_cf(u, log_s0, r, T, sigma, lam, mu_j, s_j, kbar):
    """Merton jump-diffusion CF of log S_T:
    φ(u) = exp(iu·(log S0 + (r − σ²/2 − λκ̄)T) − ½u²σ²T
               + λT·(e^{iu·μ_J − ½u²σ_J²} − 1)).
    ``u`` may be complex (Carr-Madan evaluates at v − (α+1)i); the input's
    complex dtype is preserved."""
    u = jnp.asarray(u)
    if not jnp.iscomplexobj(u):
        u = u.astype(jnp.complex128)
    rdt = jnp.finfo(u.dtype).dtype
    log_s0, r, T, sigma, lam, mu_j, s_j, kbar = (
        jnp.asarray(p, rdt) for p in (log_s0, r, T, sigma, lam, mu_j, s_j, kbar)
    )
    iu = 1j * u
    drift = log_s0 + (r - 0.5 * sigma**2 - lam * kbar) * T
    jump = lam * T * (jnp.exp(iu * mu_j - 0.5 * u**2 * s_j**2) - 1.0)
    return jnp.exp(iu * drift - 0.5 * u**2 * sigma**2 * T + jump)


def merton_cf_pair(u_re, u_im, log_s0, r, T, sigma, lam, mu_j, s_j, kbar):
    """Merton CF in split-complex (re, im) pairs — pure real arithmetic for
    the "pair" Carr-Madan engine (math/complexops.py); math identical to
    :func:`merton_cf`."""
    from ..math.complexops import cexp

    iu = (-u_im, u_re)
    u2 = (u_re * u_re - u_im * u_im, 2.0 * u_re * u_im)
    drift = log_s0 + (r - 0.5 * sigma**2 - lam * kbar) * T
    jexp = cexp((iu[0] * mu_j - 0.5 * s_j**2 * u2[0],
                 iu[1] * mu_j - 0.5 * s_j**2 * u2[1]))
    expo = (
        iu[0] * drift - 0.5 * sigma**2 * T * u2[0] + lam * T * (jexp[0] - 1.0),
        iu[1] * drift - 0.5 * sigma**2 * T * u2[1] + lam * T * jexp[1],
    )
    return cexp(expo)


def lognormal_cf(u, mean, std):
    """CF of a Normal(mean, std) log-price: E[e^{iuX}] (sample_from_cf.jl:14-16).

    ``u`` may be complex (Carr-Madan evaluates at v − (α+1)i).  The input's
    complex dtype is preserved.
    """
    u = jnp.asarray(u)
    if not jnp.iscomplexobj(u):
        u = u.astype(jnp.complex128)
    return jnp.exp(1j * u * mean - 0.5 * (std**2) * u**2)


def heston_cf(u, S0, V0, kappa, theta, sigma, rho, r, T):
    """Heston characteristic function of log S_T ("little trap" form).

    Math parity with reference heston.jl:307-319:
      d  = √((κ − ρσiu)² + σ²(iu + u²))
      g  = (κ − ρσiu − d)/(κ − ρσiu + d)
      C  = κθ/σ² · ((κ − ρσiu − d)T − 2·log((1 − g e^{−dT})/(1 − g)))
      D  = (κ − ρσiu − d)/σ² · (1 − e^{−dT})/(1 − g e^{−dT})
      φ  = exp(C + D·V0 + iu·log S0 + iu·rT)

    Input complex dtype is preserved.
    """
    u = jnp.asarray(u)
    if not jnp.iscomplexobj(u):
        u = u.astype(jnp.complex128)
    # pin all parameters to u's precision so c64 inputs stay c64 end-to-end
    rdt = jnp.finfo(u.dtype).dtype
    S0, V0, kappa, theta, sigma, rho, r, T = (
        jnp.asarray(p, rdt) for p in (S0, V0, kappa, theta, sigma, rho, r, T)
    )
    iu = 1j * u
    beta = kappa - rho * sigma * iu
    d = jnp.sqrt(beta**2 + sigma**2 * (iu + u**2))
    g = (beta - d) / (beta + d)
    e_dt = jnp.exp(-d * T)
    C = (kappa * theta / sigma**2) * ((beta - d) * T - 2.0 * jnp.log((1.0 - g * e_dt) / (1.0 - g)))
    D = ((beta - d) / sigma**2) * ((1.0 - e_dt) / (1.0 - g * e_dt))
    return jnp.exp(C + D * V0 + iu * jnp.log(S0) + iu * r * T)


def heston_cf_pair(u_re, u_im, S0, V0, kappa, theta, sigma, rho, r, T):
    """Heston CF of log S_T in split-complex (re, im) pairs — pure real
    arithmetic (math/complexops.py), the "pair" Carr-Madan engine.

    Math identical to :func:`heston_cf`.
    """
    from ..math.complexops import cdiv, cexp, clog, cmul, csqrt

    dt = jnp.result_type(u_re)
    S0, V0, kappa, theta, sigma, rho, r, T = (
        jnp.asarray(p, dt) for p in (S0, V0, kappa, theta, sigma, rho, r, T)
    )
    iu = (-u_im, u_re)  # i·u
    beta = (kappa - rho * sigma * iu[0], -rho * sigma * iu[1])
    # d = sqrt(beta² + σ²(iu + u²));  u² = (u_re+i·u_im)²
    u2 = (u_re * u_re - u_im * u_im, 2.0 * u_re * u_im)
    inner = cmul(beta, beta)
    inner = (inner[0] + sigma**2 * (iu[0] + u2[0]), inner[1] + sigma**2 * (iu[1] + u2[1]))
    d = csqrt(inner)
    bmd = (beta[0] - d[0], beta[1] - d[1])
    bpd = (beta[0] + d[0], beta[1] + d[1])
    g = cdiv(bmd, bpd)
    e_dt = cexp((-d[0] * T, -d[1] * T))
    one_m_ge = (1.0 - (g[0] * e_dt[0] - g[1] * e_dt[1]), -(g[0] * e_dt[1] + g[1] * e_dt[0]))
    one_m_g = (1.0 - g[0], -g[1])
    log_ratio = clog(cdiv(one_m_ge, one_m_g))
    C = (
        (kappa * theta / sigma**2) * (bmd[0] * T - 2.0 * log_ratio[0]),
        (kappa * theta / sigma**2) * (bmd[1] * T - 2.0 * log_ratio[1]),
    )
    one_m_e = (1.0 - e_dt[0], -e_dt[1])
    D = cmul((bmd[0] / sigma**2, bmd[1] / sigma**2), cdiv(one_m_e, one_m_ge))
    expo = (
        C[0] + D[0] * V0 + iu[0] * (jnp.log(S0) + r * T),
        C[1] + D[1] * V0 + iu[1] * (jnp.log(S0) + r * T),
    )
    return cexp(expo)


def lognormal_cf_pair(u_re, u_im, mean, std):
    """Normal log-price CF in split-complex pairs (see heston_cf_pair)."""
    from ..math.complexops import cexp, cmul

    iu = (-u_im, u_re)
    u2 = (u_re * u_re - u_im * u_im, 2.0 * u_re * u_im)
    expo = (iu[0] * mean - 0.5 * std**2 * u2[0], iu[1] * mean - 0.5 * std**2 * u2[1])
    return cexp(expo)


def terminal_log_cf_pair(prob, dynamics: PriceDynamics):
    """φ(u) in pair form: returns fn(u_re, u_im) -> (re, im)."""
    market = prob.market_inputs
    expiry = prob.payoff.expiry
    if isinstance(dynamics, LognormalDynamics):
        mean, std = lognormal_terminal_law(market, expiry)
        return lambda ur, ui: lognormal_cf_pair(ur, ui, mean, std)
    if isinstance(dynamics, HestonDynamics):
        from ..market.inputs import forward_spot

        r = zero_rate(market.rate, expiry)
        T = market_yearfrac(market, expiry)
        s_eff = forward_spot(market, T)  # exact for the terminal law
        return lambda ur, ui: heston_cf_pair(
            ur, ui, s_eff, market.V0, market.kappa, market.theta,
            market.sigma, market.rho, r, T,
        )
    if isinstance(dynamics, BatesDynamics):
        from ..math.complexops import cmul
        from ..market.inputs import forward_spot

        r = zero_rate(market.rate, expiry)
        T = market_yearfrac(market, expiry)
        s_eff = forward_spot(market, T)
        lam, mu_j, s_j = (market.jump_intensity, market.jump_mean,
                          market.jump_std)
        kbar = jnp.expm1(mu_j + 0.5 * s_j**2)

        def pair(ur, ui):
            from ..math.complexops import cexp

            h = heston_cf_pair(ur, ui, s_eff, market.V0, market.kappa,
                               market.theta, market.sigma, market.rho, r, T)
            iu = (-ui, ur)
            u2 = (ur * ur - ui * ui, 2.0 * ur * ui)
            jexp = cexp((iu[0] * mu_j - 0.5 * s_j**2 * u2[0],
                         iu[1] * mu_j - 0.5 * s_j**2 * u2[1]))
            expo = (
                lam * T * (jexp[0] - 1.0) - iu[0] * lam * kbar * T,
                lam * T * jexp[1] - iu[1] * lam * kbar * T,
            )
            return cmul(h, cexp(expo))

        return pair
    if isinstance(dynamics, MertonJumpDynamics):
        params = merton_terminal_params(market, expiry)
        return lambda ur, ui: merton_cf_pair(ur, ui, *params)
    if isinstance(dynamics, KouJumpDynamics):
        params = kou_terminal_params(market, expiry)
        return lambda ur, ui: kou_cf_pair(ur, ui, *params)
    if isinstance(dynamics, VarianceGammaDynamics):
        params = vg_terminal_params(market, expiry)
        return lambda ur, ui: vg_cf_pair(ur, ui, *params)
    raise TypeError(f"no terminal law for dynamics {type(dynamics).__name__}")


def terminal_log_cf(prob, dynamics: PriceDynamics):
    """Return φ(u) = E[e^{iu·log S_T}] for the problem's market under the given
    dynamics at the payoff expiry (used by Carr-Madan)."""
    market = prob.market_inputs
    expiry = prob.payoff.expiry
    if isinstance(dynamics, LognormalDynamics):
        mean, std = lognormal_terminal_law(market, expiry)
        return lambda u: lognormal_cf(u, mean, std)
    if isinstance(dynamics, HestonDynamics):
        from ..market.inputs import forward_spot

        r = zero_rate(market.rate, expiry)
        T = market_yearfrac(market, expiry)
        s_eff = forward_spot(market, T)  # exact for the terminal law
        return lambda u: heston_cf(
            u, s_eff, market.V0, market.kappa, market.theta, market.sigma, market.rho, r, T
        )
    if isinstance(dynamics, BatesDynamics):
        from ..market.inputs import forward_spot

        r = zero_rate(market.rate, expiry)
        T = market_yearfrac(market, expiry)
        s_eff = forward_spot(market, T)
        return lambda u: heston_cf(
            u, s_eff, market.V0, market.kappa, market.theta, market.sigma,
            market.rho, r, T,
        ) * bates_jump_factor(
            jnp.asarray(u, jnp.complex128)
            if not jnp.iscomplexobj(jnp.asarray(u)) else jnp.asarray(u),
            market.jump_intensity, market.jump_mean, market.jump_std, T,
        )
    if isinstance(dynamics, MertonJumpDynamics):
        params = merton_terminal_params(market, expiry)
        return lambda u: merton_cf(u, *params)
    if isinstance(dynamics, KouJumpDynamics):
        params = kou_terminal_params(market, expiry)
        return lambda u: kou_cf(u, *params)
    if isinstance(dynamics, VarianceGammaDynamics):
        params = vg_terminal_params(market, expiry)
        return lambda u: vg_cf(u, *params)
    raise TypeError(f"no terminal law for dynamics {type(dynamics).__name__}")


def cir_family_euler_update(x, v, z1, z2, *, lev_x, fk, kappa, theta, sig_v,
                            rho, rho_bar, dt, sqrt_dt):
    """One full-truncation log-Euler step of the CIR-variance family —
    the SINGLE source for the (logS, V) update shared by the SLV pricing
    stepper (methods/montecarlo.py::_cir_log_euler_paths) and the particle
    leverage calibration (models/slv.py::calibrate_leverage), so the model
    the calibration fits and the model pricing simulates cannot drift
    apart.  ``lev_x`` is the per-particle leverage L(t_k, S) (1 for pure
    Heston).  The double-where sqrt guard keeps pathwise greeks NaN-free
    (sqrt'(0) = inf would poison the truncated branch via 0·inf)."""
    v_plus = jnp.maximum(v, 0.0)
    sqrt_v = jnp.where(v > 0.0, jnp.sqrt(jnp.where(v > 0.0, v, 1.0)), 0.0)
    sig_s = lev_x * sqrt_v
    x_new = x + (fk - 0.5 * sig_s**2) * dt + sig_s * sqrt_dt * z1
    v_new = v + kappa * (theta - v_plus) * dt + sig_v * sqrt_v * sqrt_dt * (
        rho * z1 + rho_bar * z2
    )
    return x_new, v_new
