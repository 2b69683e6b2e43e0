"""Black-Scholes analytic pricing (forward-measure closed form).

Parity target: reference src/pricing_methods/black_scholes.jl.  The pricer is
fully vectorized: strike/expiry/spot/vol may be arrays, so one call prices a
whole strike×expiry grid in one vectorized op (the reference's scalar closed form is the
degenerate case).  Zero volatility falls back to discounted intrinsic via a
branchless select (black_scholes.jl:53-54).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax.scipy.stats import norm

from ..core.dates import yearfrac
from ..core.problems import AnalyticSolution, PricingProblem
from ..core.solve import AbstractPricingMethod, register_solver
from ..market.rate_curve import df
from ..market.inputs import carry_yield, forward_spot, market_yearfrac
from ..market.vol_surface import get_vol
from ..utils.pytree import pytree

__all__ = [
    "BlackScholesAnalytic",
    "bs_price",
    "bs_digital_price",
    "bs_barrier_price",
    "bs_double_barrier_price",
    "bs_geometric_asian_price",
    "bs_lookback_price",
    "bs_geometry",
]


@pytree
class BlackScholesAnalytic(AbstractPricingMethod):
    """Closed-form Black-Scholes for European vanilla options."""


def bs_geometry(prob: PricingProblem):
    """Shared Black-Scholes geometry (T, K, σ, D, F, √T, d1, d2).

    Single source of truth for the pricer AND the analytic greeks — the vol
    is looked up exactly as the pricer does (surface's own reference date),
    so greeks are derivatives of the price actually produced.
    """
    payoff = prob.payoff
    market = prob.market_inputs
    K = payoff.strike
    sigma = get_vol(market.sigma, payoff.expiry, K)
    T = market_yearfrac(market, payoff.expiry)
    D = df(market.rate, payoff.expiry)
    F = forward_spot(market, T) / D  # carry-adjusted T-forward
    sqrtT = jnp.sqrt(T)
    sigma_safe = jnp.where(sigma > 0, sigma, 1.0)
    d1 = (jnp.log(F / K) + 0.5 * sigma_safe**2 * T) / (sigma_safe * sqrtT)
    d2 = d1 - sigma_safe * sqrtT
    return T, K, sigma, D, F, sqrtT, d1, d2


def bs_price(forward, strike, vol, T, discount, cp):
    """Undiscounted-forward Black formula, vectorized & branchless.

    price = D·cp·(F·N(cp·d1) − K·N(cp·d2)); σ==0 → discounted intrinsic.
    """
    sqrtT = jnp.sqrt(T)
    sigma_safe = jnp.where(vol > 0, vol, 1.0)
    d1 = (jnp.log(forward / strike) + 0.5 * sigma_safe**2 * T) / (sigma_safe * sqrtT)
    d2 = d1 - sigma_safe * sqrtT
    bs = discount * cp * (forward * norm.cdf(cp * d1) - strike * norm.cdf(cp * d2))
    intrinsic = discount * jnp.maximum(cp * (forward - strike), 0.0)
    return jnp.where((vol > 0) & (T > 0), bs, intrinsic)


def bs_digital_price(forward, strike, vol, T, discount, cp, cash=1.0):
    """Cash-or-nothing digital closed form, vectorized & branchless:
    price = D·cash·N(cp·d2); σ==0 or T==0 → discounted indicator."""
    sqrtT = jnp.sqrt(T)
    sigma_safe = jnp.where(vol > 0, vol, 1.0)
    d2 = (jnp.log(forward / strike) - 0.5 * sigma_safe**2 * T) / (sigma_safe * sqrtT)
    bs = discount * cash * norm.cdf(cp * d2)
    intrinsic = discount * cash * jnp.where(cp * (forward - strike) > 0.0, 1.0, 0.0)
    return jnp.where((vol > 0) & (T > 0), bs, intrinsic)


def bs_barrier_price(spot, strike, barrier, vol, T, discount, cp, up: bool, knock_in: bool,
                     rebate=0.0, rebate_at_hit: bool = False, carry=0.0):
    """Reiner-Rubinstein single-barrier closed form (flat rate
    r = −ln(D)/T so the barrier drift matches the curve's terminal
    discount; ``carry`` is the continuous dividend yield q, giving
    cost-of-carry b = r − q: the drift exponent uses μ = b/σ² − ½ and the
    spot legs weight by e^{−qT}, while discounting stays at r).  Computes the KNOCK-IN price from the standard A/B/C/D
    blocks and recovers knock-out by in-out parity (in + out = vanilla at
    zero rebate); an already-touched barrier (S beyond H at t=0) makes the
    in-option vanilla and the out-option worthless.

    ``rebate`` adds the Reiner-Rubinstein rebate legs: knock-in → the E
    block (R paid at expiry iff never touched, E = R·D·P(no touch));
    knock-out with ``rebate_at_hit`` → the F block (R paid at the hit
    time, the one-touch value), else R·D·P(touch) = R·D − E."""
    S, K, H = spot, strike, barrier
    r = -jnp.log(discount) / jnp.maximum(T, 1e-30)
    b = r - carry  # cost of carry
    qf = jnp.exp(-carry * T)  # e^{(b−r)T}: weights every S leg
    sigma_safe = jnp.where(vol > 0, vol, 1.0)
    v = sigma_safe * jnp.sqrt(T)
    mu = b / sigma_safe**2 - 0.5
    eta = -1.0 if up else 1.0

    def vanilla_block(lnarg):
        # cp·[S·e^{−qT}·N(cp·x) − K·D·N(cp·(x−v))], x = lnarg/v + (1+μ)v
        x = lnarg / v + (1.0 + mu) * v
        return cp * (S * qf * norm.cdf(cp * x) - K * discount * norm.cdf(cp * (x - v)))

    hs2mu = (H / S) ** (2.0 * mu)
    hs2mu2 = hs2mu * (H / S) ** 2

    def reflected_block(lnarg):
        # cp·[S·(H/S)^{2μ+2}·N(η·y) − K·D·(H/S)^{2μ}·N(η·(y−v))]
        y = lnarg / v + (1.0 + mu) * v
        return cp * (
            hs2mu2 * S * qf * norm.cdf(eta * y)
            - hs2mu * K * discount * norm.cdf(eta * (y - v))
        )

    A = vanilla_block(jnp.log(S / K))
    B = vanilla_block(jnp.log(S / H))
    C = reflected_block(jnp.log(H * H / (S * K)))
    Dd = reflected_block(jnp.log(H / S))

    k_ge_h = K >= H
    if cp > 0:  # call
        in_price = jnp.where(k_ge_h, A, B - C + Dd) if up else jnp.where(k_ge_h, C, A - B + Dd)
    else:  # put
        in_price = jnp.where(k_ge_h, A - B + Dd, C) if up else jnp.where(k_ge_h, B - C + Dd, A)

    vanilla = bs_price(S * qf / discount, K, vol, T, discount, cp)
    touched = (S >= H) if up else (S <= H)
    in_price = jnp.where(touched, vanilla, jnp.clip(in_price, 0.0, None))
    # clip roundoff: when in ≈ vanilla (e.g. up-out call with K ≥ H, exactly
    # worthless) the subtraction can land at −1e-17
    price = in_price if knock_in else jnp.clip(vanilla - in_price, 0.0, None)

    # rebate legs (per unit rebate): E = D·P(no touch) pays at expiry iff
    # never touched; F = E[e^{−rτ}·1(τ ≤ T)] pays at the hit time
    x2 = jnp.log(S / H) / v + (1.0 + mu) * v
    y2 = jnp.log(H / S) / v + (1.0 + mu) * v
    e_pu = discount * (norm.cdf(eta * (x2 - v)) - hs2mu * norm.cdf(eta * (y2 - v)))
    e_pu = jnp.where(touched, 0.0, jnp.clip(e_pu, 0.0, discount))
    if knock_in:
        price = price + rebate * e_pu
    elif rebate_at_hit:
        lam_h = jnp.sqrt(mu * mu + 2.0 * r / sigma_safe**2)
        # double-where: beyond the barrier the powers can overflow and would
        # poison the masked gradient
        hsl = jnp.where(touched, 1.0, H / S)
        z = jnp.log(hsl) / v + lam_h * v
        f_pu = (hsl ** (mu + lam_h) * norm.cdf(eta * z)
                + hsl ** (mu - lam_h) * norm.cdf(eta * (z - 2.0 * lam_h * v)))
        f_pu = jnp.where(touched, 1.0, jnp.clip(f_pu, 0.0, 1.0))
        price = price + rebate * f_pu
    else:
        price = price + rebate * (discount - e_pu)

    # σ==0 or T==0: the path is the deterministic forward S·e^{rt}, monotone
    # in t, so it touches H iff an endpoint is beyond H; the at-hit rebate
    # discounts at the KNOWN deterministic hit time t_hit = ln(H/S)/r
    # (clipped — touched-at-inception pays immediately, r→0 flat paths only
    # ever touch at inception)
    f_T = S * qf / discount
    det_touch = touched | ((f_T >= H) if up else (f_T <= H))
    det_pay = discount * jnp.maximum(cp * (f_T - K), 0.0)
    det_in = jnp.where(det_touch, det_pay, 0.0)
    if knock_in:
        det = det_in + rebate * discount * jnp.where(det_touch, 0.0, 1.0)
    elif rebate_at_hit:
        b_safe = jnp.where(jnp.abs(b) < 1e-12, 1e-12, b)
        t_hit = jnp.clip(jnp.log(H / S) / b_safe, 0.0, T)
        det = (det_pay - det_in) + rebate * jnp.exp(-r * t_hit) * jnp.where(
            det_touch, 1.0, 0.0
        )
    else:
        det = (det_pay - det_in) + rebate * discount * jnp.where(det_touch, 1.0, 0.0)
    return jnp.where((vol > 0) & (T > 0), price, det)


def bs_geometric_asian_price(spot, strike, vol, T, discount, cp, n: int,
                             carry=0.0):
    """Discrete geometric-average Asian closed form (equally-spaced fixings
    t_i = i·T/n): log A_G is Gaussian with mean ln S + (b − σ²/2)·T(n+1)/(2n)
    (cost-of-carry b = r − q, ``carry`` = q) and variance
    σ²·T·(n+1)(2n+1)/(6n²), so the price is the Black formula at forward
    e^{m+s²/2} with total volatility s."""
    r = -jnp.log(discount) / jnp.maximum(T, 1e-30)
    m = jnp.log(spot) + (r - carry - 0.5 * vol**2) * T * (n + 1) / (2.0 * n)
    s2 = vol**2 * T * (n + 1) * (2 * n + 1) / (6.0 * n * n)
    f_geo = jnp.exp(m + 0.5 * s2)
    # reuse the Black kernel: only vol·√T enters, so pass (vol=s, T=1)
    return bs_price(f_geo, strike, jnp.sqrt(s2), 1.0, discount, cp)


def bs_double_barrier_price(spot, strike, lower, upper, vol, T, discount, cp,
                            knock_in: bool, rebate=0.0,
                            rebate_at_hit: bool = False, carry=0.0,
                            n_images: int = 5):
    """Continuously-monitored double-barrier closed form under Black-Scholes
    with cost of carry b = r − q, derived from the reflection image series
    (the Ikeda-Kunitomo family, built directly rather than transcribed):
    with X = ln(S_T/S), ν = b − σ²/2, α = ν/σ², l = ln(L/S) < 0 < u =
    ln(U/S), c = u − l, the no-exit density is

        f(x) = e^{αx − α²s²/2} · Σ_n [φ_s(x − 2nc) − φ_s(x − (2l − 2nc))]

    so the knock-out price is a ±-signed sum of lognormal partial
    expectations ∫_A^B e^{γx} φ_s(x−m) dx = e^{γm+γ²s²/2}[Φ(·) − Φ(·)],
    each evaluated in LOG space (exp(exponent + logΦ)) — the exponents
    cancel analytically against the Gaussian tails, so far images neither
    overflow nor poison gradients.  Knock-in by in-out parity.

    ``rebate`` pays at expiry: knock-out → R·D·P(exit), knock-in →
    R·D·P(no exit); the double one-touch (``rebate_at_hit``) has no
    closed form here — price it by the bridge MC (first-hit-segment legs).
    A spot already outside (L, U) makes the knock-out pure rebate and the
    knock-in vanilla.  Truncation at ``n_images`` (terms decay like
    e^{−2n²c²/s²}; 5 covers s ≲ 1.5·c to beyond f64 precision).

    MC agreement + single-barrier limits are pinned in
    tests/unit/test_double_barrier.py."""
    if rebate_at_hit:
        raise TypeError(
            "the double one-touch (rebate_at_hit) has no closed form here; "
            "price it by the bridge MC estimator"
        )
    from jax.scipy.special import log_ndtr

    S, K = spot, strike
    r = -jnp.log(discount) / jnp.maximum(T, 1e-30)
    b = r - carry
    qf = jnp.exp(-carry * T)
    sig = jnp.where(vol > 0, vol, 1.0)
    s = sig * jnp.sqrt(T)
    s2 = sig**2 * T
    inside0 = (S > lower) & (S < upper)
    # dead-branch-safe corridor keeps the series' masked gradients finite
    l = jnp.log(jnp.where(inside0, lower, 0.5 * S) / S)
    u = jnp.log(jnp.where(inside0, upper, 2.0 * S) / S)
    c = u - l
    alpha = (b - 0.5 * sig**2) / sig**2
    k = jnp.log(K / S)
    call = cp > 0
    A = jnp.clip(k, l, u) if call else l
    B = u if call else jnp.clip(k, l, u)
    base = -0.5 * alpha**2 * s2

    def series(gamma, lo, hi):
        tot = 0.0
        for n in range(-n_images, n_images + 1):
            for m, sgn in ((2.0 * n * c, 1.0), (2.0 * l - 2.0 * n * c, -1.0)):
                e0 = base + gamma * m + 0.5 * gamma**2 * s2
                z_hi = (hi - m) / s - gamma * s
                z_lo = (lo - m) / s - gamma * s
                tot = tot + sgn * (
                    jnp.exp(e0 + log_ndtr(z_hi)) - jnp.exp(e0 + log_ndtr(z_lo))
                )
        return tot

    ko = discount * cp * (S * series(alpha + 1.0, A, B) - K * series(alpha, A, B))
    p_stay = jnp.clip(series(alpha, l, u), 0.0, 1.0)
    F = S * qf / discount
    vanilla = bs_price(F, K, vol, T, discount, cp)
    if knock_in:
        price = (vanilla - ko) + rebate * discount * p_stay
        price = jnp.where(inside0, price, vanilla)
    else:
        price = ko + rebate * discount * (1.0 - p_stay)
        price = jnp.where(inside0, price, rebate * discount)
    # σ→0 / T→0: the deterministic path S·e^{b·t} is monotone, so its
    # extremes sit at the endpoints
    s_det = S * jnp.exp(b * T)
    touched = (jnp.maximum(S, s_det) >= upper) | (jnp.minimum(S, s_det) <= lower)
    intrinsic = discount * jnp.maximum(cp * (s_det - K), 0.0)
    w_t = jnp.where(touched, 1.0, 0.0)
    if knock_in:
        det = intrinsic * w_t + rebate * discount * (1.0 - w_t)
    else:
        det = intrinsic * (1.0 - w_t) + rebate * discount * w_t
    return jnp.where((vol > 0) & (T > 0), price, det)


def bs_lookback_price(spot, strike, extremum, vol, T, discount, cp,
                      fixed: bool, carry=0.0):
    """Continuously-monitored lookback closed forms under Black-Scholes with
    cost of carry b = r − q (Goldman-Sosin-Gatto floating strike,
    Conze-Viswanathan fixed strike — derived from the drifted-BM running
    extremum law P(M̄ ≤ y) = Φ((y−νT)/s) − e^{2νy/σ²}Φ((−y−νT)/s), not
    transcribed, so the b→0 limits below are exact Taylor limits of the
    same expressions).

    With x the effective reflection level, d1 = (ln(S/x)+(b+σ²/2)T)/(σ√T),
    d2 = d1 − σ√T, β = 2b/σ², D = e^{−rT}, E = e^{(b−r)T} = e^{−qT}:

        A(x) = (σ²/2b)·[(S/x)^{−β}·Φ(−d1+2b√T/σ) − e^{bT}·Φ(−d1)]
        C(x) = (σ²/2b)·[e^{bT}·Φ(d1) − (S/x)^{−β}·Φ(d1−2b√T/σ)]
        floating call (x = m):        S·E·Φ(d1) − m·D·Φ(d2) + S·D·A(m)
        floating put  (x = M):        M·D·Φ(−d2) − S·E·Φ(−d1) + S·D·C(M)
        fixed call (x = max(K, M)):   D·(M−K)⁺ + S·E·Φ(d1) − x·D·Φ(d2) + S·D·C(x)
        fixed put  (x = min(K, m)):   D·(K−m)⁺ + x·D·Φ(−d2) − S·E·Φ(−d1) + S·D·A(x)

    b→0 limits (double-where so the 1/b pole never poisons gradients):
    A₀ = σ√T·φ(d1) − (ln(S/x)+σ²T/2)·Φ(−d1),
    C₀ = σ√T·φ(d1) + (ln(S/x)+σ²T/2)·Φ(d1).

    ``extremum`` is the running max (fixed call / floating put) or min
    (fixed put / floating call), pre-clamped against the spot by the
    caller.  Exactness is pinned against the exact bridge-MC estimator in
    tests/unit/test_lookback.py, including the floating↔fixed parity
    identities."""
    S, K, m = spot, strike, extremum
    r = -jnp.log(discount) / jnp.maximum(T, 1e-30)
    b = r - carry
    E = jnp.exp(-carry * T)  # e^{(b−r)T}
    sqrtT = jnp.sqrt(T)
    sig = jnp.where(vol > 0, vol, 1.0)
    v = sig * sqrtT
    call = cp > 0
    if fixed:
        x = jnp.maximum(K, m) if call else jnp.minimum(K, m)
        head = discount * jnp.maximum(cp * (m - K), 0.0)
    else:
        x = m
        head = 0.0
    d1 = (jnp.log(S / x) + (b + 0.5 * sig**2) * T) / v
    d2 = d1 - v
    # the strange term: σ²/(2b) pole handled by its exact b→0 Taylor limit
    from jax.scipy.special import log_ndtr

    small = jnp.abs(b) * T < 1e-7
    b_safe = jnp.where(small, 1.0, b)
    beta = 2.0 * b_safe / sig**2
    shift = 2.0 * b_safe * sqrtT / sig
    lnSx = jnp.log(S / x)
    half = 0.5 * sig**2 * T
    # (S/x)^{−β}·Φ(y) in log space: β is O(1/σ²), so the power can overflow
    # long before the matching Φ tail underflows; exp(−β·lnSx + logΦ(y)) is
    # finite wherever the product is.  The exponent is zeroed on the dead
    # (small-b) branch so the Taylor limit's masked gradient stays clean.
    expo = jnp.where(small, 0.0, -beta * lnSx)
    if call == fixed:  # fixed call / floating put → C(x)
        gen = (sig**2 / (2.0 * b_safe)) * (
            jnp.exp(b_safe * T) * norm.cdf(d1) - jnp.exp(expo + log_ndtr(d1 - shift))
        )
        lim = v * norm.pdf(d1) + (lnSx + half) * norm.cdf(d1)
    else:  # floating call / fixed put → A(x)
        gen = (sig**2 / (2.0 * b_safe)) * (
            jnp.exp(expo + log_ndtr(-d1 + shift)) - jnp.exp(b_safe * T) * norm.cdf(-d1)
        )
        lim = v * norm.pdf(d1) - (lnSx + half) * norm.cdf(-d1)
    strange = S * discount * jnp.where(small, lim, gen)
    if fixed:
        body = cp * (S * E * norm.cdf(cp * d1) - x * discount * norm.cdf(cp * d2))
    else:
        body = cp * (S * E * norm.cdf(cp * d1) - m * discount * norm.cdf(cp * d2))
    price = head + body + strange
    # σ→0 / T→0: the path is deterministic S·e^{b·t}; its extremum over
    # [0, T] combines with the running one, and the payout discounts back
    run_det = jnp.maximum(m, jnp.maximum(S, S * jnp.exp(b * T))) if (
        call == fixed
    ) else jnp.minimum(m, jnp.minimum(S, S * jnp.exp(b * T)))
    s_det = S * jnp.exp(b * T)
    if fixed:
        det = discount * jnp.maximum(cp * (run_det - K), 0.0)
    else:
        det = discount * cp * (s_det - run_det)
    return jnp.where((vol > 0) & (T > 0), price, det)


def _solve_bs_two_date(prob: PricingProblem, method) -> AnalyticSolution:
    """Two-date closed forms under flat-vol Black-Scholes: compound options
    (Geske 1979, all four variants via the bivariate normal with
    ρ = √(t₁/T₂) and the IFT-differentiable critical spot) and simple
    choosers (max(C, P) at t₁ = call + a put on the t₁-forward, by parity).
    Both need ONE σ across both horizons, so a flat vol surface is
    required — term structures are model choices these forms don't make."""
    from jax.scipy.stats import norm

    from ..core.payoffs import CompoundOption
    from ..market.inputs import carry_yield
    from ..market.vol_surface import FlatVolSurface
    from ..math.bvn import bvn_cdf
    from ..math.rootfind import implicit_root

    payoff = prob.payoff
    market = prob.market_inputs
    if not isinstance(market.sigma, FlatVolSurface):
        raise TypeError(
            "compound/chooser closed forms need a flat vol (one σ spans "
            "both decision and expiry horizons); price surfaces by MC"
        )
    sigma = market.sigma.sigma
    q = carry_yield(market)
    is_compound = isinstance(payoff, CompoundOption)
    t1_ticks = payoff.decision_date if is_compound else payoff.choose_date
    t1 = market_yearfrac(market, t1_ticks)
    T2 = market_yearfrac(market, payoff.expiry)
    D1 = df(market.rate, t1_ticks)
    D2 = df(market.rate, payoff.expiry)
    D12 = D2 / D1
    spot = market.spot

    if not is_compound:
        # chooser = call(K, T₂) + put on X = S_{t₁}e^{−q(T₂−t₁)} struck at
        # K·D(t₁,T₂), expiring at t₁ (parity at the choose date)
        leg1 = bs_price(
            spot * jnp.exp(-q * T2) / D2, payoff.strike, sigma, T2, D2, 1.0
        )
        leg2 = bs_price(
            spot * jnp.exp(-q * T2) / D1, payoff.strike * D12, sigma, t1, D1, -1.0
        )
        return AnalyticSolution(prob, method, leg1 + leg2)

    w1, w2 = payoff.call_put(), payoff.inner_call_put()
    K1, K2 = payoff.strike, payoff.inner_strike
    tau = T2 - t1

    def inner_value(log_s):
        s = jnp.exp(log_s)
        return bs_price(s * jnp.exp(-q * tau) / D12, K2, sigma, tau, D12, w2)

    # Geske critical spot: inner(S*) = K₁, bisected in log-spot (monotone:
    # increasing for an inner call, decreasing for an inner put), IFT
    # gradients through the captured parameters
    log_k2 = jnp.log(K2)
    s_star = jnp.exp(
        implicit_root(lambda x: inner_value(x) - K1, log_k2 - 20.0, log_k2 + 20.0)
    )
    sq1, sq2 = sigma * jnp.sqrt(t1), sigma * jnp.sqrt(T2)
    a1 = (jnp.log(spot * jnp.exp(-q * t1) / (D1 * s_star)) + 0.5 * sigma**2 * t1) / sq1
    a2 = a1 - sq1
    b1 = (jnp.log(spot * jnp.exp(-q * T2) / (D2 * K2)) + 0.5 * sigma**2 * T2) / sq2
    b2 = b1 - sq2
    rho = jnp.sqrt(t1 / T2)
    s12 = w1 * w2
    price = s12 * (
        spot * jnp.exp(-q * T2) * bvn_cdf(s12 * a1, w2 * b1, w1 * rho)
        - K2 * D2 * bvn_cdf(s12 * a2, w2 * b2, w1 * rho)
    ) - w1 * K1 * D1 * norm.cdf(s12 * a2)
    return AnalyticSolution(prob, method, price)


@register_solver(BlackScholesAnalytic)
def _solve_bs_analytic(prob: PricingProblem, method: BlackScholesAnalytic) -> AnalyticSolution:
    payoff = prob.payoff
    market = prob.market_inputs
    from ..core.payoffs import (
        AsianOption,
        BarrierOption,
        DigitalOption,
        DoubleBarrierOption,
        FixedStrike,
        GeometricAverage,
        KnockIn,
        LookbackOption,
        Up,
        VanillaOption,
        require_european,
    )

    require_european(payoff, "BlackScholesAnalytic")

    if getattr(market, "dividends", None) is not None and not isinstance(
        payoff, (VanillaOption, DigitalOption)
    ):
        raise TypeError(
            f"discrete cash dividends reach the closed forms through the "
            f"escrowed terminal law, which is exact for vanillas/digitals "
            f"only; price {type(payoff).__name__} on the PDE or grid-MC "
            f"engines (spot model) instead"
        )

    from ..core.payoffs import (
        BasketOption,
        Cliquet,
        ForwardStartOption,
        SpreadOption,
        VarianceSwap,
    )

    from ..core.payoffs import ChooserOption, CompoundOption, RainbowOption

    if isinstance(payoff, (SpreadOption, BasketOption, RainbowOption)):
        from .multi_asset import solve_multi_asset_analytic

        return solve_multi_asset_analytic(prob, method)

    if isinstance(payoff, (CompoundOption, ChooserOption)):
        return _solve_bs_two_date(prob, method)

    if isinstance(payoff, Cliquet):
        # each period's clipped simple return decomposes as
        # clip(R−1, f, c) = f + (R − (1+f))+ − (R − (1+c))+ — a bull spread
        # on the forward return R over one reset period τ = T/n, whose
        # risk-neutral Black values only need the period forward
        # E[R] = 1/d_per (flat-vol BS; all periods are iid so the sum is n
        # times one period), discounted once at expiry
        from ..market.vol_surface import FlatVolSurface

        if not isinstance(market.sigma, FlatVolSurface):
            raise TypeError(
                "the cliquet closed form needs a flat vol (the forward "
                "smile is model-dependent); price surfaces by MC under "
                "LocalVolDynamics/HestonDynamics"
            )
        sig = market.sigma.sigma
        T_cl = market_yearfrac(market, payoff.expiry)
        D_cl = df(market.rate, payoff.expiry)
        n_per = payoff.observations
        tau = T_cl / n_per
        d_per = D_cl ** (1.0 / n_per)  # per-period discount (flat-rate exact)
        # E[R] = e^{(r−q)τ} under the risk-neutral measure with carry q
        f_per = jnp.exp(-carry_yield(market) * tau) / d_per
        call_f = bs_price(f_per, 1.0 + payoff.local_floor, sig, tau, 1.0, 1.0)
        call_c = bs_price(f_per, 1.0 + payoff.local_cap, sig, tau, 1.0, 1.0)
        per_period = payoff.local_floor + call_f - call_c
        price = D_cl * payoff.notional * n_per * per_period
        return AnalyticSolution(prob, method, price)

    if isinstance(payoff, ForwardStartOption):
        # Rubinstein (1991): S_{t1}-homogeneity + independent lognormal
        # forward return give V = S0 · BlackPrice(F=e^{r·τ}, K=k, σ, τ)·D(t1,T)
        # with τ = T − t1; flat-vol markets only (a forward smile is a model
        # choice this closed form cannot make)
        from ..market.vol_surface import FlatVolSurface

        if not isinstance(market.sigma, FlatVolSurface):
            raise TypeError(
                "forward-start closed form needs a flat vol (the forward "
                "smile is model-dependent); price surfaces by MC under "
                "LocalVolDynamics/HestonDynamics"
            )
        sig = market.sigma.sigma
        t1 = yearfrac(market.reference_date, payoff.start, getattr(market, "daycount", None))
        T_fs = market_yearfrac(market, payoff.expiry)
        tau = T_fs - t1
        D_T = df(market.rate, payoff.expiry)
        D_t1 = df(market.rate, payoff.start)
        d_fwd = D_T / D_t1  # D(t1, T)
        q_fs = carry_yield(market)
        # per-unit-S_{t1} Black price on the forward return R = S_T/S_{t1}:
        # E[R] = e^{(r−q)τ} = e^{−qτ}/d_fwd under the risk-neutral measure;
        # the homogeneity prefactor is the carry-discounted spot e^{−q·t1}·S0
        unit = bs_price(jnp.exp(-q_fs * tau) / d_fwd, payoff.strike_fraction,
                        sig, tau, d_fwd, payoff.call_put())
        price = market.spot * jnp.exp(-q_fs * t1) * unit
        return AnalyticSolution(prob, method, price)

    if isinstance(payoff, VarianceSwap):
        # discrete fair strike under GBM, EXACT: each log return is
        # N(μ·dt, σ²·dt) with μ = r − σ²/2, so E[RV] = σ² + μ²·T/n.
        # Smiley surfaces have no single σ (the log-contract replication
        # lives outside this method) — price those by LocalVolDynamics MC.
        from ..market.vol_surface import FlatVolSurface

        if not isinstance(market.sigma, FlatVolSurface):
            raise TypeError(
                "variance swaps on a non-flat surface have no single-σ "
                "closed form here; use MonteCarlo(LocalVolDynamics(), "
                "EulerMaruyama(), cfg) to price off the smile"
            )
        T_vs = market_yearfrac(market, payoff.expiry)
        D_vs = df(market.rate, payoff.expiry)
        sig = market.sigma.sigma
        r = -jnp.log(D_vs) / jnp.maximum(T_vs, 1e-30)
        mu = r - carry_yield(market) - 0.5 * sig**2
        fair = sig**2 + mu**2 * T_vs / payoff.observations
        price = D_vs * payoff.notional * (fair - payoff.strike_var)
        return AnalyticSolution(prob, method, price)

    K = payoff.strike
    sigma = get_vol(market.sigma, payoff.expiry, K)
    cp = payoff.call_put()
    T = market_yearfrac(market, payoff.expiry)
    D = df(market.rate, payoff.expiry)
    F = forward_spot(market, T) / D

    if isinstance(payoff, AsianOption):
        if not isinstance(payoff.averaging, GeometricAverage):
            raise TypeError(
                "the arithmetic average has no lognormal closed form; "
                "arithmetic Asians price by grid Monte Carlo "
                "(MonteCarlo with config.steps == observations)"
            )
        price = bs_geometric_asian_price(
            market.spot, K, sigma, T, D, cp, payoff.observations,
            carry=carry_yield(market),
        )
    elif isinstance(payoff, BarrierOption):
        price = bs_barrier_price(
            market.spot, K, payoff.barrier, sigma, T, D, cp,
            up=isinstance(payoff.direction, Up),
            knock_in=isinstance(payoff.knock, KnockIn),
            rebate=payoff.rebate, rebate_at_hit=payoff.rebate_at_hit,
            carry=carry_yield(market),
        )
    elif isinstance(payoff, DoubleBarrierOption):
        price = bs_double_barrier_price(
            market.spot, K, payoff.lower, payoff.upper, sigma, T, D, cp,
            knock_in=isinstance(payoff.knock, KnockIn),
            rebate=payoff.rebate, rebate_at_hit=payoff.rebate_at_hit,
            carry=carry_yield(market),
        )
    elif isinstance(payoff, DigitalOption):
        price = bs_digital_price(F, K, sigma, T, D, cp, payoff.cash)
    elif isinstance(payoff, LookbackOption):
        from ..market.vol_surface import FlatVolSurface

        if not isinstance(market.sigma, FlatVolSurface):
            raise TypeError(
                "the lookback closed form needs a flat vol (the extremum "
                "law is whole-path, not one-strike); price surfaces by MC "
                "under LocalVolDynamics/HestonDynamics"
            )
        spot = market.spot
        run = spot if payoff.running_extremum is None else payoff.running_extremum
        ext = (
            jnp.maximum(run, spot) if payoff.uses_maximum
            else jnp.minimum(run, spot)
        )
        price = bs_lookback_price(
            spot, K, ext, market.sigma.sigma, T, D, cp,
            fixed=isinstance(payoff.strike_style, FixedStrike),
            carry=carry_yield(market),
        )
    else:
        price = bs_price(F, K, sigma, T, D, cp)
    return AnalyticSolution(prob, method, price)
