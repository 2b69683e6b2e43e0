"""Exact-transition segmented mixing scheme for Heston — beyond-reference.

The conditional (Romano-Touzi) mixing estimator's remaining error is the
time-discretization bias of the variance leg: a QE path with the trapezoid
∫V proxy carries ≈ 430/n² bp of vanilla bias on the bench market (ADR-008).
This module removes the discretization entirely, in the spirit of the
reference's exact Broadie-Kaya sampler (src/distributions/heston.jl:125-143
noncentral-χ² V_T draw; :150-212 the ∫V|endpoints Laplace transform) but in
a branchless, fixed-trip form:

1. V_T | V_0 — the EXACT CIR transition, sampled as a Poisson(λ/2)-mixed
   Gamma(d/2+N, 2c) (the noncentral-χ² mixture representation): Poisson by
   fixed-trip CDF inversion from one uniform, Gamma by the corrected
   saddlepoint quantile :func:`gamma_qtl` from one normal with the
   small-shape boost Γ(α) ~ Γ(α+1)·U^{1/α}.
2. IV = ∫V | (V_0, V_T) — a Gamma draw matched to the EXACT conditional
   mean/variance, in closed form from derivatives of the Broadie-Kaya
   Laplace transform (heston.jl:150-212).  The only Bessel term needed is
   the ratio I_{ν+1}(z)/I_ν(z), evaluated by a fixed-trip Perron continued
   fraction blended into a 4-term uniform asymptotic tail (≤ 7e-5 rel).
3. J = ∫√V dW_v telescopes through the CIR integral identity
   J = (V_T − V_0 − κθT + κ·IV)/σ, and the payoff closes with the
   conditional Black-Scholes formula (methods/montecarlo.py mixing close).

Measured bias (benchmarks/one_step_exact_mixing.py, 2^18 scrambled-Sobol'
points × 6, four stress markets incl. a Feller-violating one): |bias| ≤
0.31bp at TWO segments with the corrected saddlepoint gamma quantile
(gammasp/pgsp rows; the Wilson-Hilferty rows read up to −1.05bp) — versus
3.4bp for the 11-step QE path at similar per-path cost.  The 2-moment gamma
family needs ≥2 segments (one segment leaves 0.3-17bp, market-dependent);
more than 2 buys nothing measurable.

Gradients: the Poisson count N is a discrete function of (V, κ, σ, Δ), so
RAW pathwise AD through this scheme drops the dependence of the count
distribution on its rate (∂N = 0) and V-leg greeks are badly biased
(measured: σ-greek off ~19×).  The fix is the mixed pathwise/
likelihood-ratio estimator: freeze N, add the per-segment Poisson score
log p(N; λ) = N·log λ − λ (+const) to a per-path log-likelihood, and
differentiate value + sg(value − b)·(logL − sg(logL)) — see
:func:`cir_exact_step_score`.  The framework bakes this surrogate into the
estimator's per-path values (methods/montecarlo._heston_exact_mixing_values)
so plain ``jax.grad`` through ``solve`` is UNBIASED;
methods/mixing_greeks.heston_exact_price_and_greeks returns the full
7-param dict in one call.  Spot/rate/ρ greeks do not touch the V leg and
are exact either way.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = [
    "cir_exact_constants",
    "bessel_ratio",
    "poisson_inv",
    "poisson_kmax",
    "gamma_wh",
    "gamma_qtl",
    "cir_exact_step",
    "cir_exact_step_score",
    "iv_cond_moments",
    "iv_gamma_draw",
]

#: fixed trip counts of the branchless loops (chosen so truncation error is
#: far below fp32 resolution over the reachable (λ, z) range; see module
#: docstring and benchmarks/one_step_exact_mixing.py)
POISSON_KMAX = 32
POISSON_KMAX_CAP = 64
CF_ITERS = 24
CF_SWITCH = 24.0


def poisson_kmax(kappa, theta, sigma, dt, v0, default: int = POISSON_KMAX) -> int:
    """Static Poisson trip count with a provable-tail heuristic.

    Bound the per-segment rate by λ/2 at v_b = m + 6s, where (m, s) are the
    exact CIR transition mean/std started from the worst deterministic level
    max(V0, θ); return the smallest k with P(N > k | λ(v_b)/2) < 1e-8
    (+1 margin, floored at 16).  The truncation-bias budget is then
    ≲ P(V > v_b) + 1e-8 ≪ 0.01bp.

    Raises ValueError when even ``POISSON_KMAX_CAP`` trips cannot meet the
    tail criterion (λ/2 ≳ 40 — e.g. vol-of-vol σ ≲ 0.05 at κΔ ~ 1, where
    the noncentral-χ² is essentially deterministic and its Poisson-mixture
    count explodes): a silently clamped count would price with large hidden
    bias.  Such markets should use ``HestonQE(conditional=True)`` — and
    note FEWER, longer segments lower λ (λ ∝ 1/Δ as κΔ → 0), the opposite
    of the usual more-steps instinct.  Returns ``default`` when the inputs
    are traced (under an outer jit) — the conservative fixed count."""
    import numpy as np

    try:
        k_, th = float(kappa), float(theta)
        s_, d_, v = float(sigma), float(dt), float(v0)
    except Exception:
        return default
    e = np.exp(-k_ * d_)
    em = -np.expm1(-k_ * d_)
    cfac = s_ * s_ * em / (4.0 * k_)
    vw = max(v, th)
    m = vw * e + th * em
    s2 = vw * s_ * s_ * e * em / k_ + th * s_ * s_ * em * em / (2.0 * k_)
    v_b = m + 6.0 * np.sqrt(max(s2, 0.0))
    lam_half = e / (2.0 * cfac) * v_b
    p = np.exp(-lam_half)
    cdf, k = p, 0
    while cdf < 1.0 - 1e-8 and k < POISSON_KMAX_CAP:
        k += 1
        p *= lam_half / k
        cdf += p
    if cdf < 1.0 - 1e-8:
        raise ValueError(
            f"exact CIR transition needs a Poisson trip count beyond "
            f"{POISSON_KMAX_CAP} (rate λ/2 ≈ {lam_half:.0f} at the 6σ "
            f"variance bound; vol-of-vol σ={s_} is too small for κΔ="
            f"{k_ * d_:.2f}) — use HestonQE(conditional=True) for this "
            f"market, or FEWER exact segments (λ grows as Δ shrinks)"
        )
    return int(max(k + 1, 16))


def cir_exact_constants(kappa, theta, sigma, dt):
    """Per-segment scalar constants shared by the transition sampler and the
    conditional ∫V moments (everything path-independent, computed once)."""
    e = jnp.exp(-kappa * dt)
    em = -jnp.expm1(-kappa * dt)
    cfac = sigma**2 * em / (4.0 * kappa)  # noncentral-χ² scale / 2
    d_half = 2.0 * kappa * theta / sigma**2  # half the χ² dof
    t2 = kappa * dt / 2.0
    s = jnp.sinh(t2)
    c1 = jnp.cosh(t2) / s  # coth
    c2 = 1.0 / (s * s)  # csch²
    return dict(
        kappa=kappa, sigma=sigma, dt=dt,
        e=e, cfac=cfac, d_half=d_half, nu=d_half - 1.0,
        t2=t2, c1=c1, c2=c2,
        z_fac=2.0 * kappa / (sigma**2 * s),  # z = z_fac·√(xy)
        lam_fac=e / (2.0 * cfac),  # λ/2 = lam_fac·V
        q=(1.0 - t2 * c1) / kappa,
        p_c=-(dt / kappa) * c1 + (dt * dt / 4.0) * (c1 * c1 + c2),
        inv_sig2=1.0 / sigma**2,
    )


def bessel_ratio(nu, z):
    """I_{ν+1}(z)/I_ν(z), branchless: fixed-trip backward Perron continued
    fraction for z < 24, ratio of 4-term uniform asymptotic series above
    (max rel err ≤ 7e-5 over ν ∈ [−0.55, 3], z ∈ [1e-3, 320])."""
    zc = jnp.minimum(z, CF_SWITCH)
    r = jnp.zeros_like(z)
    for m in range(CF_ITERS, 0, -1):
        r = zc / (2.0 * (nu + m) + zc * r)

    za = jnp.maximum(z, CF_SWITCH)

    def _series(mm, zz):
        mu = 4.0 * mm * mm
        t = 8.0 * zz
        return (1.0 - (mu - 1.0) / t
                + (mu - 1.0) * (mu - 9.0) / (2.0 * t * t)
                - (mu - 1.0) * (mu - 9.0) * (mu - 25.0) / (6.0 * t * t * t))

    asym = _series(nu + 1.0, za) / _series(nu, za)
    return jnp.where(z < CF_SWITCH, r, asym)


def poisson_inv(mu, u, kmax: int = POISSON_KMAX):
    """Poisson(μ) count by CDF inversion from one uniform — a fixed ``kmax``
    trip with a running probability product (counts above kmax clamp; with
    kmax=32 that needs μ ≳ 12, i.e. V ≳ 100·θ on the bench market)."""
    p = jnp.exp(-mu)
    cdf = p
    n = jnp.zeros_like(mu)
    for k in range(1, kmax + 1):
        n = jnp.where(u > cdf, float(k), n)
        p = p * (mu / k)
        cdf = cdf + p
    return n


def gamma_wh(alpha, z):
    """Gamma(α, 1) by the Wilson-Hilferty cube of one standard normal
    (good for α ≳ 1; callers boost small shapes via Γ(α)=Γ(α+1)·U^{1/α})."""
    t = 1.0 - 1.0 / (9.0 * alpha) + z / (3.0 * jnp.sqrt(alpha))
    return alpha * jnp.maximum(t, 0.0) ** 3


# -- corrected saddlepoint gamma quantile ------------------------------------
# Temme's asymptotic inversion of P(α, x) = Φ(z): with λ = x/α and
# η signed by λ−1 via η²/2 = λ − 1 − ln λ, P(α, x) ≈ Φ(η√α), so the draw
# inverts η(z) = z/√α + ε₁(η₀)/α + ε₂/α² + ε₃/α³ and maps back through
# λ(η).  ε₁ = ln(η/(λ−1))/η is Temme's exact first correction (the
# Wilson-Hilferty cube IS this inversion truncated after ε₁ near the
# center — they share the α − 1/3 + 1/(27α) median); the ε₂/ε₃ polynomials
# below are least-squares fits of the remaining defect against scipy's
# gammaincinv over α ∈ [0.8, 100], z ∈ [−6.6, 6.6] (offline study:
# benchmarks/one_step_exact_mixing.py gamma_sp).  Max |P(α, draw) − Φ(z)|
# ≤ 6.4e-5 in range (WH: 1.9e-2 at α=0.8) with graceful extrapolation both
# sides; measured pricing effect: the exact-mixing estimator's transition
# bias collapses to the exact-gammaincinv floor on all four ADR-008 stress
# markets (bench −1.05 → −0.31bp).
GQ_SC = 7.5
GQ_NEWTON = 3  # final λ(η) solve
GQ_NEWTON_E1 = 2  # λ(η₀) solve feeding ε₁ (error enters divided by α; 2 is
#                   measured identical to 3 at the 6.4e-5 contract)
GQ_P2 = (-1.76222600e-02, -2.93765073e-02, 2.14155241e-01, -2.72541844e-01,
         -8.34309734e-01, 1.90338824e+00, 1.60407347e+00, -5.14361722e+00,
         -1.51201354e+00, 7.20404411e+00, 3.65575150e-01, -5.21675853e+00,
         4.56357262e-01, 1.55081017e+00, -2.78395827e-01)
GQ_P3 = (5.39443911e-03, -1.14541171e-02, -3.45087047e-02, 1.30529962e-01,
         4.88113067e-02, -4.25758711e-01, 6.65709220e-02, 5.57799053e-01,
         -1.97560263e-01, -2.55404255e-01, 1.14194771e-01)


def _gq_horner(coeffs, t):
    acc = jnp.asarray(coeffs[-1], dtype=t.dtype) * jnp.ones_like(t)
    for c in coeffs[-2::-1]:
        acc = acc * t + c
    return acc


@functools.partial(jax.custom_jvp, nondiff_argnums=(1,))
def lam_of_eta(eta, trips: int = GQ_NEWTON):
    """Solve λ − 1 − ln λ = η²/2 with sign(η) = sign(λ−1), branchless:
    series for |η| < 0.5, fixed-trip Newton from a cube/exp-tail start else
    (the cube start (1+η/3)³ is the WH polynomial — a few % off, which
    quadratic Newton closes to fp accuracy in 3 trips).

    Differentiation is a custom JVP from the implicit function theorem (see
    ``_lam_of_eta_jvp``) rather than AD through the Newton trips: the
    backward pass of the unrolled iterations spilled log/div residuals per
    path per call (4 calls/segment through gamma_qtl), and the IFT form is
    EXACT for the equation where the unrolled form differentiates the
    approximation."""
    lam_s = 1.0 + eta * (1.0 + eta * (1.0 / 3.0 + eta * (1.0 / 36.0
            + eta * (-1.0 / 270.0 + eta * (1.0 / 4320.0)))))
    cube = jnp.maximum((1.0 + eta / 3.0) ** 3, 1e-12)
    # on the λ<1 branch take the closer of the cube and the deep-tail
    # asymptote λ ≈ e^{−1−η²/2} (both undershoot; max(resid) 4e-10 at 3
    # trips vs 7e-4 for a hard switch)
    lam = jnp.where(eta >= 0.0, cube,
                    jnp.maximum(cube, jnp.exp(-1.0 - 0.5 * eta * eta)))
    tgt = 0.5 * eta * eta
    for _ in range(trips):
        f = lam - 1.0 - jnp.log(jnp.maximum(lam, 1e-30)) - tgt
        den = jnp.where(jnp.abs(lam - 1.0) < 1e-12, 1e-12, lam - 1.0)
        lam = jnp.maximum(lam - f * lam / den, 1e-30)
    return jnp.where(jnp.abs(eta) < 0.5, lam_s, lam)


@lam_of_eta.defjvp
def _lam_of_eta_jvp(trips, primals, tangents):
    """IFT on λ − 1 − ln λ = η²/2:  (1 − 1/λ)·dλ = η·dη  ⇒
    dλ/dη = η·λ/(λ − 1); the 0/0 at η → 0 is closed by the series branch's
    own derivative (matching the primal's |η| < 0.5 switch)."""
    (eta,) = primals
    (deta,) = tangents
    lam = lam_of_eta(eta, trips)
    dser = 1.0 + eta * (2.0 / 3.0 + eta * (1.0 / 12.0
           + eta * (-2.0 / 135.0 + eta * (1.0 / 864.0))))
    den = jnp.where(jnp.abs(lam - 1.0) < 1e-12, 1e-12, lam - 1.0)
    dlam = jnp.where(jnp.abs(eta) < 0.5, dser, eta * lam / den)
    return lam, dlam * deta


def gamma_qtl(alpha, z):
    """Gamma(α, 1) quantile at Φ(z) by the corrected saddlepoint inversion —
    branchless, fixed-trip, smooth in α (pathwise AD flows); the drop-in
    higher-accuracy replacement for :func:`gamma_wh` (same (α, z) contract).
    """
    inv_a = 1.0 / alpha
    eta0 = z * jnp.sqrt(inv_a)
    lam0 = lam_of_eta(eta0, GQ_NEWTON_E1)
    w = lam0 - 1.0
    safe = jnp.abs(eta0) >= 0.1
    w_s = jnp.where(safe, w, 1.0)
    eta_s = jnp.where(safe, eta0, 1.0)
    e1 = jnp.where(
        safe,
        jnp.log(jnp.maximum(eta_s / w_s, 1e-30)) / eta_s,
        -1.0 / 3.0 + eta0 / 36.0 + eta0 * eta0 / 1620.0,
    )
    t = jnp.clip(eta0 * (1.0 / GQ_SC), -1.0, 1.0)
    q2 = _gq_horner(GQ_P2, t)
    q3 = _gq_horner(GQ_P3, t)
    eta = eta0 + inv_a * (e1 + inv_a * (q2 + inv_a * q3))
    return alpha * lam_of_eta(eta)


def cir_exact_step_score(x, u_pois, z_gam, u_boost, c, kmax: int = POISSON_KMAX):
    """One exact CIR transition V_t = x → V_{t+Δ} plus the Poisson score.

    Returns ``(y, log_lik)`` where ``log_lik = N·log λ − λ`` (the N!-term is
    parameter-free and dropped) with the count N gradient-frozen: summed over
    segments this is the per-path log-likelihood of the frozen counts, whose
    gradient is the likelihood-ratio correction that plain pathwise AD
    misses.  λ is floored at 1e-30 inside the log only (a WH cube clamped to
    zero makes the next λ exactly 0, where N = 0 and the true term is 0)."""
    lam = x * c["lam_fac"]
    n = jax.lax.stop_gradient(poisson_inv(lam, u_pois, kmax))
    log_lik = n * jnp.log(jnp.maximum(lam, 1e-30)) - lam
    alpha = c["d_half"] + n
    u_safe = jnp.maximum(u_boost, 1e-300)
    g = gamma_qtl(alpha + 1.0, z_gam) * u_safe ** (1.0 / alpha)
    return 2.0 * c["cfac"] * g, log_lik


def cir_exact_step(x, u_pois, z_gam, u_boost, c, kmax: int = POISSON_KMAX):
    """One exact CIR transition V_t = x → V_{t+Δ} from (uniform, normal,
    uniform), via the Poisson-Gamma mixture of the noncentral χ² (the
    unused score term is dead-code-eliminated by XLA)."""
    return cir_exact_step_score(x, u_pois, z_gam, u_boost, c, kmax)[0]


def iv_cond_moments(x, y, c):
    """Exact conditional (mean, variance) of ∫_t^{t+Δ} V ds given the
    endpoints V_t = x, V_{t+Δ} = y — first two derivatives of the
    Broadie-Kaya Laplace transform (heston.jl:150-212) at a = 0, expressed
    through W = z·I_{ν+1}(z)/I_ν(z) + ν with z = (2κ/σ²)·√(xy)/sinh(κΔ/2).

    Variance is clamped to ≥ 1e-18 (fp roundoff can cross zero when the
    bridge is nearly deterministic)."""
    kappa, dt = c["kappa"], c["dt"]
    t2, c1, c2 = c["t2"], c["c1"], c["c2"]
    # positive floor, NOT 0: at xy = 0 exactly (a Wilson-Hilferty cube clamp)
    # sqrt's infinite derivative meets a zero cotangent and AD yields NaN;
    # max(xy, 1e-30) zeroes the branch derivative instead (the analytic chain
    # dW/d(xy) is bounded, so the value is unaffected)
    z = c["z_fac"] * jnp.sqrt(jnp.maximum(x * y, 1e-30))
    W = z * bessel_ratio(c["nu"], z) + c["nu"]
    q, p = c["q"], c["p_c"]
    xy = (x + y) * c["inv_sig2"]
    l1 = 1.0 / kappa - (dt / 2.0) * c1 - xy * (c1 - t2 * c2) + W * q
    l2 = (-1.0 / (kappa * kappa) + (dt * dt / 4.0) * c2
          + xy * (dt * c2 - kappa * (dt * dt / 2.0) * c2 * c1)
          + (z * z + c["nu"] ** 2 - W - W * W) * q * q + W * p)
    sig2 = c["sigma"] ** 2
    m1 = -(sig2 / kappa) * l1
    s2 = (sig2 / kappa) * (sig2 / kappa) * (l2 - l1 / kappa)
    return jnp.maximum(m1, 1e-12), jnp.maximum(s2, 1e-18)


def iv_gamma_draw(m1, s2, z):
    """Moment-matched Gamma draw of ∫V | endpoints from one normal
    (corrected saddlepoint quantile; the matched shapes m1²/s2 are ≳ 1 in
    practice, inside gamma_qtl's fitted range)."""
    shape = m1 * m1 / s2
    scale = s2 / m1
    return jnp.maximum(scale * gamma_qtl(shape, z), 1e-12)
