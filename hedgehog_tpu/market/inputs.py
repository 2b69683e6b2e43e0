"""Market-input containers for pricing models.

Parity target: reference src/market_inputs/market_inputs.jl.
``BlackScholesInputs`` auto-wraps scalar rate/vol into FlatRateCurve /
FlatVolSurface exactly like the reference convenience constructors
(market_inputs.jl:28-36); ``HestonInputs`` carries the five Heston parameters
plus spot and curve (market_inputs.jl:55-88).  All numeric fields are pytree
leaves, so whole input objects can be vmapped/differentiated.
"""

from __future__ import annotations

from typing import Any

from ..core.dates import ACT365F, to_ticks, yearfrac
from ..utils.pytree import pytree, static_field
from .rate_curve import FlatRateCurve, RateCurve
from .vol_surface import FlatVolSurface, RectVolSurface

__all__ = [
    "AbstractMarketInputs",
    "BlackScholesInputs",
    "HestonInputs",
    "SLVInputs",
    "BatesInputs",
    "RoughBergomiInputs",
    "HullWhiteInputs",
    "HestonHullWhiteInputs",
    "MertonInputs",
    "SABRInputs",
    "KouInputs",
    "VarianceGammaInputs",
    "BachelierInputs",
    "MultiAssetBSInputs",
    "market_yearfrac",
    "carry_yield",
    "forward_spot",
]


class AbstractMarketInputs:
    """Base marker for market-input containers (market_inputs.jl:6)."""


def _wrap_rate(rate, reference_date, daycount):
    if isinstance(rate, (FlatRateCurve, RateCurve)):
        return rate
    return FlatRateCurve(reference_date, rate, daycount)


def _wrap_vol(sigma, reference_date):
    from .svi import SVIVolSurface

    if isinstance(sigma, (FlatVolSurface, RectVolSurface, SVIVolSurface)):
        return sigma
    return FlatVolSurface(sigma, reference_date)


def quanto_dividend_yield(r_domestic, r_foreign, q, sigma, fx_vol, corr):
    """Effective continuous carry that makes a DOMESTIC-currency
    :class:`BlackScholesInputs` price a QUANTO option on a foreign asset
    (payoff converted at a fixed FX rate) — beyond the reference's
    single-currency scope.

    Under the domestic risk-neutral measure the foreign asset drifts at
    r_f − q − ρ·σ_S·σ_FX (the quanto adjustment), while cashflows discount
    at r_d; with ``BlackScholesInputs(rate=r_d, dividend_yield=this)`` the
    forward S·e^{(r_d − yield)T} reproduces exactly that drift:

        yield = r_d − r_f + q + ρ·σ_S·σ_FX

    ``corr`` is the instantaneous correlation between the asset (in its
    own currency) and the DOMESTIC-per-foreign FX rate."""
    return r_domestic - r_foreign + q + corr * sigma * fx_vol


def carry_yield(market):
    """Continuous dividend/borrow yield q of a market (0.0 when absent) —
    beyond-reference: the reference carries rates only.  The spot drifts at
    r − q while cashflows discount at r, so the T-forward is
    spot·e^{−qT}/D(T) and every grid sampler's drift subtracts q."""
    return getattr(market, "dividend_yield", 0.0)


def forward_spot(market, T):
    """The carry-adjusted ESCROWED spot ``(spot − PV(cash divs ≤ T))·e^{−qT}``
    — divide by D(T) for the T-forward.  For terminal-law methods this
    substitution alone prices continuous carry exactly (the q-model's
    terminal law equals the q=0 law started at spot·e^{−qT}) and discrete
    cash dividends in the standard escrowed convention
    (market/dividends.py); markets without a schedule subtract nothing."""
    import jax.numpy as jnp

    spot = market.spot
    if getattr(market, "dividends", None) is not None:
        from .dividends import escrowed_spot

        # escrowed_spot raises eagerly when PV(schedule) >= spot (no
        # lognormal model exists behind a non-positive escrowed spot)
        spot = escrowed_spot(market, T)
    return spot * jnp.exp(-carry_yield(market) * T)


def market_yearfrac(market, t):
    """Year fraction from a market's reference date to ``t`` under the
    market's day-count convention (beyond-reference: the reference is
    ACT/365-fixed only) — the ONE conversion every pricing method uses for
    option maturities, so a market's convention applies consistently."""
    return yearfrac(
        market.reference_date, t, getattr(market, "daycount", None)
    )


@pytree
class BlackScholesInputs(AbstractMarketInputs):
    """Black-Scholes market data: reference date (ticks), rate curve, spot,
    vol surface. Scalars for ``rate``/``sigma`` are auto-wrapped
    (market_inputs.jl:28-36).

    ``daycount`` (beyond-reference, default ACT/365 Fixed) sets the
    date→year-fraction convention for option maturities and is propagated
    into an auto-wrapped flat rate curve; explicit curve/surface objects
    keep their own conventions.  Linear conventions (Act365Fixed/Act360/
    Act36525) are jit/grad-compatible; calendar ones (Thirty360E/ActActISDA)
    evaluate at the concrete-date boundary.

    ``dividends`` (beyond-reference, default None) attaches a
    :class:`~hedgehog_tpu.market.dividends.DividendSchedule` of discrete
    CASH dividends: terminal-law engines (analytic BS, Carr-Madan, exact
    MC, CRR) price the escrowed convention through the shared
    :func:`forward_spot`; grid engines (PDE jump conditions, grid MC under
    LognormalDynamics) price the piecewise-lognormal spot model — see
    market/dividends.py for the exact contracts."""

    reference_date: Any
    rate: Any
    spot: Any
    sigma: Any
    dividend_yield: Any = 0.0
    dividends: Any = None
    daycount: Any = static_field(default=ACT365F)

    def __post_init__(self):
        ref = to_ticks(self.reference_date)
        object.__setattr__(self, "reference_date", ref)
        object.__setattr__(self, "rate", _wrap_rate(self.rate, ref, self.daycount))
        object.__setattr__(self, "sigma", _wrap_vol(self.sigma, ref))


@pytree
class HestonInputs(AbstractMarketInputs):
    """Heston market data: dS/S = r dt + √V dW₁; dV = κ(θ−V) dt + σ√V dW₂,
    corr(dW₁,dW₂)=ρ (market_inputs.jl:55-88).  ``daycount`` as on
    :class:`BlackScholesInputs`."""

    reference_date: Any
    rate: Any
    spot: Any
    V0: Any
    kappa: Any
    theta: Any
    sigma: Any
    rho: Any
    dividend_yield: Any = 0.0
    daycount: Any = static_field(default=ACT365F)

    def __post_init__(self):
        ref = to_ticks(self.reference_date)
        object.__setattr__(self, "reference_date", ref)
        object.__setattr__(self, "rate", _wrap_rate(self.rate, ref, self.daycount))


@pytree
class BatesInputs(AbstractMarketInputs):
    """Bates (1996) market data — Heston stochastic variance PLUS Merton
    lognormal jumps (beyond-reference model family; the production equity
    smile model):

        dS/S = (r − q − λκ̄)dt + √V dW₁ + (e^J − 1)dN
        dV   = κ(θ − V)dt + σ√V dW₂,   corr(dW₁, dW₂) = ρ

    with J ~ N(jump_mean, jump_std²), N ~ Poisson(jump_intensity·t)
    independent of (W₁, W₂), and κ̄ = e^{μ_J+σ_J²/2} − 1.  All eight model
    parameters are pytree leaves; ``dividend_yield``/``daycount`` as on
    :class:`BlackScholesInputs`."""

    reference_date: Any
    rate: Any
    spot: Any
    V0: Any
    kappa: Any
    theta: Any
    sigma: Any
    rho: Any
    jump_intensity: Any
    jump_mean: Any
    jump_std: Any
    dividend_yield: Any = 0.0
    daycount: Any = static_field(default=ACT365F)

    def __post_init__(self):
        ref = to_ticks(self.reference_date)
        object.__setattr__(self, "reference_date", ref)
        object.__setattr__(self, "rate", _wrap_rate(self.rate, ref, self.daycount))


@pytree
class RoughBergomiInputs(AbstractMarketInputs):
    """Rough Bergomi market data (beyond-reference model family; Bayer-Friz-
    Gatheral 2016 — see models/rough_bergomi.py for the exact-Volterra scheme):

        V_t = xi0·exp(η·Z_t − ½η²·t^{2H}),  Z = Riemann-Liouville fBM(H)
        dS/S = (r − q)dt + √V (ρ dW₁ + √(1−ρ²) dW⊥)

    ``xi0`` is the (flat) forward-variance level — E[V_t] = xi0 for all t —
    ``eta`` the vol-of-vol, ``hurst`` the roughness index H ∈ (0, ½]
    (H ≈ 0.05-0.15 fits the equity ATM-skew power law), ``rho`` the
    spot/vol correlation.  ALL FOUR model parameters are pytree leaves —
    including ``hurst``: the Volterra covariance is built from smooth jnp
    ops, so ∂price/∂H (roughness vega) flows through plain ``jax.grad``.
    ``daycount`` as on :class:`BlackScholesInputs`."""

    reference_date: Any
    rate: Any
    spot: Any
    xi0: Any
    eta: Any
    hurst: Any
    rho: Any
    dividend_yield: Any = 0.0
    daycount: Any = static_field(default=ACT365F)

    def __post_init__(self):
        ref = to_ticks(self.reference_date)
        object.__setattr__(self, "reference_date", ref)
        object.__setattr__(self, "rate", _wrap_rate(self.rate, ref, self.daycount))


@pytree
class SLVInputs(AbstractMarketInputs):
    """Stochastic-local-vol market data (beyond-reference model family —
    see models/slv.py for the particle calibration):

        dS/S = (r − q)dt + L(t, S)·√V dW₁
        dV   = κ(θ − V)dt + mixing·σ·√V dW₂,   corr(dW₁, dW₂) = ρ

    ``sigma_surface`` is the MARKET implied-vol surface the model must
    reprice (scalar auto-wrapped flat); (V0, κ, θ, σ, ρ) are the Heston
    block; ``mixing`` ∈ [0, 1] scales the vol-of-vol (0 = pure local vol,
    1 = full Heston smile dynamics — vanillas are repriced at every value);
    ``leverage`` is the calibrated :class:`~hedgehog_tpu.models.slv.
    LeverageSurface` (None until :func:`~hedgehog_tpu.models.slv.
    calibrate_leverage` fills it).  ``daycount`` as on
    :class:`BlackScholesInputs`."""

    reference_date: Any
    rate: Any
    spot: Any
    V0: Any
    kappa: Any
    theta: Any
    sigma: Any
    rho: Any
    sigma_surface: Any
    mixing: Any = 1.0
    leverage: Any = None
    dividend_yield: Any = 0.0
    daycount: Any = static_field(default=ACT365F)

    def __post_init__(self):
        ref = to_ticks(self.reference_date)
        object.__setattr__(self, "reference_date", ref)
        object.__setattr__(self, "rate", _wrap_rate(self.rate, ref, self.daycount))
        object.__setattr__(self, "sigma_surface", _wrap_vol(self.sigma_surface, ref))

    def with_leverage(self, leverage):
        """A copy carrying a calibrated leverage surface."""
        import dataclasses

        return dataclasses.replace(self, leverage=leverage)


@pytree
class HullWhiteInputs(AbstractMarketInputs):
    """Hull-White / G1++ one-factor Gaussian short-rate market (beyond-
    reference ASSET CLASS — the reference treats rates as deterministic
    discounting only): dr = (θ(t) − a·r)dt + σ dW with θ(t) fitted so model
    bonds reproduce ``rate`` (a FlatRateCurve or spine RateCurve) exactly —
    the x-factor formulation in models/hull_white.py never materializes θ.

    ``a`` (mean reversion, must be > 0) and ``sigma`` (absolute short-rate
    vol) are pytree leaves: AD rate-vega/mean-reversion greeks and (a, σ)
    calibration to caplet/swaption quotes flow through the standard lenses,
    and curve-spine bumps (ZeroRateSpineLens) give key-rate durations.
    Pair with the interest-rate payoffs (ZeroCouponBond, BondOption,
    Caplet, Swaption) under HullWhiteAnalytic / HullWhiteMonteCarlo."""

    reference_date: Any
    rate: Any
    a: Any
    sigma: Any
    daycount: Any = static_field(default=ACT365F)

    def __post_init__(self):
        ref = to_ticks(self.reference_date)
        object.__setattr__(self, "reference_date", ref)
        object.__setattr__(self, "rate", _wrap_rate(self.rate, ref, self.daycount))
        try:
            if float(self.a) <= 0.0:
                raise ValueError("HullWhiteInputs.a (mean reversion) must be > 0")
        except TypeError:
            pass  # traced: the B(τ) = (1−e^{−aτ})/a forms assume a > 0


@pytree
class HestonHullWhiteInputs(AbstractMarketInputs):
    """Heston-Hull-White hybrid market (beyond-reference: equity smile
    UNDER STOCHASTIC RATES — the long-dated equity/structured-products
    model):

        dS/S = (r_t − q)dt + √V dW_S
        dV   = κ(θ − V)dt + σ_v √V dW_v,        corr(dW_S, dW_v) = rho_sv
        dr   = (θ_r(t) − a·r)dt + σ_r dW_r,     corr(dW_S, dW_r) = rho_sr

    with W_v ⊥ W_r (the standard identification) and θ_r(t) fitted
    EXACTLY to ``rate`` via the same G1++ x-factor as
    :class:`HullWhiteInputs`.  Validation: rho_sv² + rho_sr² ≤ 1 is the
    caller's responsibility (the S-Brownian decomposes over (W_v, W_r, ⊥)).
    All model parameters are AD leaves.  Pricing: the three-factor
    conditional mixing estimator `MonteCarlo(HestonHullWhiteDynamics(),
    HestonQE(conditional=True), cfg)` — logS_T given the (V, x) paths is
    exactly normal, so each path closes with a conditional Black-Scholes
    form under its own pathwise stochastic discount."""

    reference_date: Any
    rate: Any
    spot: Any
    V0: Any
    kappa: Any
    theta: Any
    sigma: Any
    rho_sv: Any
    a: Any
    sigma_r: Any
    rho_sr: Any = 0.0
    dividend_yield: Any = 0.0
    daycount: Any = static_field(default=ACT365F)

    def __post_init__(self):
        ref = to_ticks(self.reference_date)
        object.__setattr__(self, "reference_date", ref)
        object.__setattr__(self, "rate", _wrap_rate(self.rate, ref, self.daycount))
        try:
            if float(self.a) <= 0.0:
                raise ValueError("HestonHullWhiteInputs.a must be > 0")
        except TypeError:
            pass


@pytree
class MertonInputs(AbstractMarketInputs):
    """Merton (1976) lognormal jump-diffusion market data (beyond-reference
    model family): dS/S = (r − λκ̄)dt + σ dW + (e^J − 1)dN with
    J ~ N(jump_mean, jump_std²), N a Poisson(jump_intensity) process and
    κ̄ = e^{jump_mean + jump_std²/2} − 1 the martingale compensator.

    ``sigma`` is the diffusion volatility (a model parameter, scalar leaf —
    not a vol surface); all five model parameters are pytree leaves, so
    whole-market vmapping and AD greeks/calibration work as for Heston.
    ``daycount`` as on :class:`BlackScholesInputs`."""

    reference_date: Any
    rate: Any
    spot: Any
    sigma: Any
    jump_intensity: Any
    jump_mean: Any
    jump_std: Any
    dividend_yield: Any = 0.0
    daycount: Any = static_field(default=ACT365F)

    def __post_init__(self):
        ref = to_ticks(self.reference_date)
        object.__setattr__(self, "reference_date", ref)
        object.__setattr__(self, "rate", _wrap_rate(self.rate, ref, self.daycount))


@pytree
class KouInputs(AbstractMarketInputs):
    """Kou (2002) double-exponential jump-diffusion market data
    (beyond-reference model family): dS/S = (r − q − λκ̄)dt + σ dW +
    (e^J − 1)dN with asymmetric double-exponential jump sizes — upward
    Exp(eta_up) with probability ``p_up``, downward −Exp(eta_down)
    otherwise — N a Poisson(``jump_intensity``) process, and
    κ̄ = p·η₁/(η₁−1) + (1−p)·η₂/(η₂+1) − 1 the martingale compensator.
    ``eta_up`` must exceed 1 (E[e^J] finite).  All five jump/vol parameters
    are pytree leaves; ``dividend_yield``/``daycount`` as on
    :class:`BlackScholesInputs`."""

    reference_date: Any
    rate: Any
    spot: Any
    sigma: Any
    jump_intensity: Any
    p_up: Any
    eta_up: Any
    eta_down: Any
    dividend_yield: Any = 0.0
    daycount: Any = static_field(default=ACT365F)

    def __post_init__(self):
        ref = to_ticks(self.reference_date)
        object.__setattr__(self, "reference_date", ref)
        object.__setattr__(self, "rate", _wrap_rate(self.rate, ref, self.daycount))
        try:
            e1 = float(self.eta_up)
        except Exception:
            return  # traced: validation is a construction-time convenience
        if e1 <= 1.0:
            raise ValueError(
                f"eta_up must exceed 1 for E[e^J] to be finite (got {e1})"
            )


@pytree
class VarianceGammaInputs(AbstractMarketInputs):
    """Variance Gamma market data (Madan-Carr-Chang 1998; beyond-reference
    model family): log S_T = log S0 + (r − q + ω)T + θ·G_T + σ·W_{G_T}
    with the gamma subordinator G_T ~ Gamma(T/ν, scale ν) (mean T,
    variance νT) — a PURE-JUMP infinite-activity Lévy process, the classic
    fit for short-dated equity smiles.  ω = ln(1 − θν − σ²ν/2)/ν is the
    martingale correction; 1 − θν − σ²ν/2 > 0 is required (validated when
    concrete) for E[S_T] to be finite.  (σ, ν, θ) are pytree leaves;
    ``dividend_yield``/``daycount`` as on :class:`BlackScholesInputs`."""

    reference_date: Any
    rate: Any
    spot: Any
    sigma: Any
    nu: Any
    theta: Any
    dividend_yield: Any = 0.0
    daycount: Any = static_field(default=ACT365F)

    def __post_init__(self):
        ref = to_ticks(self.reference_date)
        object.__setattr__(self, "reference_date", ref)
        object.__setattr__(self, "rate", _wrap_rate(self.rate, ref, self.daycount))
        try:
            margin = 1.0 - float(self.theta) * float(self.nu)                 - 0.5 * float(self.sigma) ** 2 * float(self.nu)
        except Exception:
            return  # traced: validation is a construction-time convenience
        if margin <= 0.0:
            raise ValueError(
                f"VG needs 1 − θν − σ²ν/2 > 0 for a finite forward "
                f"(got {margin:.6f}); reduce θ·ν or σ²·ν"
            )


@pytree
class BachelierInputs(AbstractMarketInputs):
    """Bachelier (normal) market data (beyond-reference model family): the
    T-forward F = spot/D(T) follows dF = σ_N dW with ``sigma`` the NORMAL
    volatility in PRICE units per √year (the rates/commodities quoting
    convention; prices can go negative).  ``sigma`` is a pytree leaf —
    vmapping, AD vega and calibration flow as for the other families.
    ``daycount`` as on :class:`BlackScholesInputs`."""

    reference_date: Any
    rate: Any
    spot: Any
    sigma: Any
    dividend_yield: Any = 0.0
    daycount: Any = static_field(default=ACT365F)

    def __post_init__(self):
        ref = to_ticks(self.reference_date)
        object.__setattr__(self, "reference_date", ref)
        object.__setattr__(self, "rate", _wrap_rate(self.rate, ref, self.daycount))


@pytree
class CEVInputs(AbstractMarketInputs):
    """Constant-elasticity-of-variance market data (beyond-reference model
    family): dS = (r − q)·S dt + σ·S^β dW with elasticity ``beta`` ∈ (0, 1)
    and an ABSORBING boundary at zero (the martingale-preserving
    convention).  ``sigma`` is the CEV scale — its price-vol units are
    σ·S^{β−1}, so e.g. a 20% lognormal vol at spot 100 with β = ½ means
    σ = 0.2·100^{½} = 2.  β < 1 produces the equity-style downward implied
    skew; β → 1 recovers Black-Scholes.  ``sigma`` and ``beta`` are pytree
    leaves: AD vega/skew-risk and calibration flow as for the other
    families.  ``daycount`` as on :class:`BlackScholesInputs`."""

    reference_date: Any
    rate: Any
    spot: Any
    sigma: Any
    beta: Any
    dividend_yield: Any = 0.0
    daycount: Any = static_field(default=ACT365F)

    def __post_init__(self):
        ref = to_ticks(self.reference_date)
        object.__setattr__(self, "reference_date", ref)
        object.__setattr__(self, "rate", _wrap_rate(self.rate, ref, self.daycount))
        try:
            b = float(self.beta)
        except TypeError:
            return  # traced: domain is the caller's contract
        if not 0.0 < b < 1.0:
            raise ValueError(
                f"CEV elasticity beta must lie in (0, 1); got {b} "
                "(beta = 1 IS Black-Scholes — use BlackScholesInputs)"
            )


@pytree
class MultiAssetBSInputs(AbstractMarketInputs):
    """Correlated multi-asset Black-Scholes market (beyond-reference: the
    reference is single-asset throughout): n lognormal assets with spot
    vector ``spots`` (n,), vol vector ``sigmas`` (n,) and instantaneous
    correlation matrix ``correlation`` (n, n; symmetric, unit diagonal —
    validated when concrete).  All three are pytree leaves, so multi-asset
    greeks (per-asset deltas, correlation vega) flow by AD.
    ``dividend_yields`` (scalar or (n,)): per-asset continuous carry —
    asset i drifts at r − q_i.  ``daycount`` as on
    :class:`BlackScholesInputs`."""

    reference_date: Any
    rate: Any
    spots: Any
    sigmas: Any
    correlation: Any
    dividend_yields: Any = 0.0
    daycount: Any = static_field(default=ACT365F)

    def __post_init__(self):
        import numpy as _np

        ref = to_ticks(self.reference_date)
        object.__setattr__(self, "reference_date", ref)
        object.__setattr__(self, "rate", _wrap_rate(self.rate, ref, self.daycount))
        try:
            c = _np.asarray(self.correlation, dtype=_np.float64)
        except Exception:
            return  # traced: validation is a construction-time convenience
        if c.ndim != 2 or c.shape[0] != c.shape[1]:
            raise ValueError("correlation must be a square (n, n) matrix")
        if not _np.allclose(c, c.T, atol=1e-12):
            raise ValueError("correlation must be symmetric")
        if not _np.allclose(_np.diag(c), 1.0, atol=1e-12):
            raise ValueError("correlation must have a unit diagonal")
        if _np.linalg.eigvalsh(c).min() < -1e-10:
            raise ValueError("correlation must be positive semi-definite")


@pytree
class MultiAssetHestonInputs(AbstractMarketInputs):
    """Correlated multi-asset HESTON market (beyond-reference; the r3
    verdict's item 9 — baskets/rainbows/spreads under stochastic vol):
    n assets, each with its own CIR variance
    dV_i = κ_i(θ_i − V_i)dt + σ_i√V_i dW_i^v and spot-vol correlation
    ρ_i = corr(dW_i^s, dW_i^v); variance processes INDEPENDENT across
    assets; cross-asset dependence enters through the instantaneous
    SPOT-spot correlation matrix ``correlation`` R.

    With W_i^s = ρ_i·W_i^v + ρ̄_i·W_i^⊥ (ρ̄ = √(1−ρ²)), R_ij for i ≠ j
    requires corr(W_i^⊥, W_j^⊥) = R_ij/(ρ̄_i ρ̄_j) — which must itself be a
    valid correlation matrix; the constructor validates PSD-ness of that
    ORTHOGONAL matrix when inputs are concrete (an R too strong for the
    chosen spot-vol correlations is rejected, not silently clipped).

    All parameter vectors are pytree leaves → per-asset deltas, Heston
    parameter greeks AND correlation sensitivities flow by AD through
    ``solve`` (methods/multi_asset.solve_multi_asset_heston_mc).
    ``daycount`` as on :class:`BlackScholesInputs`."""

    reference_date: Any
    rate: Any
    spots: Any
    V0s: Any
    kappas: Any
    thetas: Any
    sigma_vs: Any
    rhos: Any
    correlation: Any
    dividend_yields: Any = 0.0
    daycount: Any = static_field(default=ACT365F)

    def __post_init__(self):
        import numpy as _np

        ref = to_ticks(self.reference_date)
        object.__setattr__(self, "reference_date", ref)
        object.__setattr__(self, "rate", _wrap_rate(self.rate, ref, self.daycount))
        try:
            c = _np.asarray(self.correlation, dtype=_np.float64)
            rhos = _np.asarray(self.rhos, dtype=_np.float64)
        except Exception:
            return  # traced: validation is a construction-time convenience
        if c.ndim != 2 or c.shape[0] != c.shape[1]:
            raise ValueError("correlation must be a square (n, n) matrix")
        if not _np.allclose(c, c.T, atol=1e-12):
            raise ValueError("correlation must be symmetric")
        if not _np.allclose(_np.diag(c), 1.0, atol=1e-12):
            raise ValueError("correlation must have a unit diagonal")
        if _np.any(_np.abs(rhos) >= 1.0):
            raise ValueError("spot-vol correlations must satisfy |rho| < 1")
        rho_bar = _np.sqrt(1.0 - rhos**2)
        c_perp = c / _np.outer(rho_bar, rho_bar)
        _np.fill_diagonal(c_perp, 1.0)
        if _np.any(_np.abs(c_perp) > 1.0 + 1e-12):
            raise ValueError(
                "spot-spot correlation too strong for the given spot-vol "
                "correlations: |R_ij| must be <= sqrt(1-rho_i^2)*sqrt(1-rho_j^2)"
            )
        if _np.linalg.eigvalsh(c_perp).min() < -1e-10:
            raise ValueError(
                "the implied orthogonal-driver correlation matrix "
                "R_ij/(rho_bar_i*rho_bar_j) must be positive semi-definite"
            )


@pytree
class SABRInputs(AbstractMarketInputs):
    """SABR market data (beyond-reference model family, Hagan et al. 2002):
    dF = α F^β dW₁, dα = ν α dW₂, corr(dW₁, dW₂) = ρ, on the T-forward
    F = spot/D(T).  ``alpha`` is the initial stochastic volatility level,
    ``beta`` the CEV backbone exponent (a STATIC field — it is conventionally
    fixed, not calibrated, and appears in non-differentiable branch
    structure), ``rho`` the spot/vol correlation, ``nu`` the vol-of-vol.
    All of (alpha, rho, nu) are pytree leaves → AD smile greeks and
    calibration flow.  ``daycount`` as on :class:`BlackScholesInputs`."""

    reference_date: Any
    rate: Any
    spot: Any
    alpha: Any
    beta: Any = static_field(default=1.0)
    rho: Any = 0.0
    nu: Any = 0.0
    dividend_yield: Any = 0.0
    daycount: Any = static_field(default=ACT365F)

    def __post_init__(self):
        ref = to_ticks(self.reference_date)
        object.__setattr__(self, "reference_date", ref)
        object.__setattr__(self, "rate", _wrap_rate(self.rate, ref, self.daycount))
