"""Complex-argument modified Bessel log I_ν(z) — the hardest numeric kernel.

Replaces SpecialFunctions.besseli at the reference's Broadie-Kaya call sites
(src/distributions/heston.jl:174,207) with a branch-tracking log-space
implementation usable inside jit/vmap/scan.  The argument is given in
log-polar form (|z|, θ) with θ an *unwrapped* (continuous) angle, exactly the
quantity the reference's angle-unwrapping loop maintains (heston.jl:184-238).

Two regimes, selected per-lane by *computed* error estimates:

1. **Power series** I_ν(z) = (z/2)^ν Σ_k (z²/4)^k/(k! Γ(ν+k+1)), evaluated
   log-sum-exp-stabilized (no overflow for any |z|).  Its f64 error is
   eps·C where the cancellation ratio C = Σ|t_k|/|Σt_k| has the closed form
   log C = Re[η(ν,|z|) − η(ν,z)]  (η below) — large only when |z| ≳ ν with
   z² near the negative real axis.
2. **Uniform large-p expansion** (p = √(ν²+z²), the Debye expansion
   rewritten in inverse powers of p so it is valid for large ν *or* large
   |z|):

       I_ν(z) ≈ [e^η Σ_k ũ_k(t²)/p^k  +  M·i·e^{iπν}·e^{−η} Σ_k (−1)^k ũ_k(t²)/p^k]
                 / (√(2π)·√p),
       η = p + ν·log(z/(ν+p)),  t = ν/p,  ũ_k(t²) = u_k(t)/t^k,

   with the u_k Debye polynomials derived *exactly* at import time from the
   DLMF 10.41.4 recurrence (no hand-copied coefficient tables).  The
   recessive (second) exponential is born across the Stokes line emanating
   from the turning point z = iν, located at Im(2η) = νπ — verified
   empirically against scipy.special.iv — and is switched on with Berry
   error-function smoothing M = ½·erfc(−(Im 2η − νπ)/√(4|Re η|)).

A third branch covers the Airy wedge near the turning point z ≈ iν, where
neither expansion is f64-accurate for large ν: stable downward recurrence in
the order, seeded by the uniform expansion at ν+64 (where p is large again).

Accuracy (pinned by tests/unit/test_besseli.py against scipy.special.iv):
≤3e-10 relative over ν ∈ [−0.9, 200], |z| ∈ [0.05, 500], all angles —
including the turning wedge.  Everything is complex128, evaluated on the
device like the rest of the Broadie-Kaya sampler.
"""

from __future__ import annotations

from fractions import Fraction

import jax
import jax.numpy as jnp
from jax.scipy.special import erfc, gammaln

__all__ = ["log_besseli_complex"]

_N_UNIFORM = 12  # ũ_0..ũ_11


def _derive_debye_polys(nmax: int):
    """u_0 = 1;  u_{k+1}(t) = t²(1−t²)/2·u_k'(t) + (1/8)∫₀ᵗ(1−5s²)u_k(s)ds
    (DLMF 10.41.4), kept as exact rationals; returned as ũ_k coefficient
    lists in the variable x = t² (ũ_k(x) = u_k(t)/t^k)."""
    us = [{0: Fraction(1)}]
    for _ in range(nmax - 1):
        u = us[-1]
        du = {e - 1: c * e for e, c in u.items() if e > 0}
        new: dict = {}
        for e, c in du.items():  # t²(1−t²)/2 · u'
            new[e + 2] = new.get(e + 2, Fraction(0)) + c / 2
            new[e + 4] = new.get(e + 4, Fraction(0)) - c / 2
        for e, c in u.items():  # (1/8)∫(1−5s²)u ds
            new[e + 1] = new.get(e + 1, Fraction(0)) + c / Fraction(8 * (e + 1))
            new[e + 3] = new.get(e + 3, Fraction(0)) - 5 * c / Fraction(8 * (e + 3))
        us.append({e: c for e, c in new.items() if c != 0})
    # ũ_k(x): u_k powers are k, k+2, …, 3k → x-powers 0..k
    return [
        [float(u.get(k + 2 * m, Fraction(0))) for m in range(k + 1)]
        for k, u in enumerate(us)
    ]


_UTILDE = _derive_debye_polys(_N_UNIFORM)
# sum of |coeffs| of the first dropped term — the uniform branch's error scale
_UTILDE_NEXT_MAG = sum(abs(c) for c in _derive_debye_polys(_N_UNIFORM + 1)[-1])


def _ut(k, x):
    """ũ_k(x) by Horner."""
    acc = jnp.zeros_like(x) + _UTILDE[k][-1]
    for c in reversed(_UTILDE[k][:-1]):
        acc = acc * x + c
    return acc


def _eta(nu, z, p):
    return p + nu * jnp.log(z / (nu + p))


_SERIES_ZMAX = 600.0  # |z| beyond which the u_k recurrence would overflow f64


def _log_iv_series(nu, z, n_terms):
    """Power series by multiplicative term recurrence
    u_{k+1} = u_k·(z²/4)/((k+1)(ν+k+1)), S = e^{−lnΓ(ν+1)}·Σu_k
    (one complex multiply per term — ~10× cheaper than log-space exp).
    Returns (log I, log-relative-error est).  |u_k| peaks at ≈e^{|z|}, so
    lanes with |z| > 600 are clamped and flagged unusable (the uniform or
    recurrence branch always wins there anyway)."""
    za_true = jnp.abs(z)
    clamped = za_true > _SERIES_ZMAX
    z = jnp.where(clamped, z * (_SERIES_ZMAX / za_true), z)
    r = z * z / 4.0

    def body(k, carry):
        t, S, S_abs = carry
        t = t * (r / ((k + 1.0) * (nu + k + 1.0)))
        return t, S + t, S_abs + jnp.abs(t)

    one = jnp.ones_like(r)
    t, S, S_abs = jax.lax.fori_loop(
        0, n_terms - 1, body, (one, one, jnp.abs(one)), unroll=16
    )
    log_S = jnp.log(S) - gammaln(nu + 1.0)
    log_iv = nu * jnp.log(z / 2.0) + log_S
    # cancellation has the CLOSED FORM log C = Re[η(ν,|z|) − η(ν,z)]
    # (C = Σ|t_k|/|Σt_k| = I_ν(|z|)/|I_ν(z)| asymptotically) — never measure
    # it against the computed S, which is pure noise exactly when C is large.
    za = jnp.abs(z)
    pa = jnp.sqrt(nu * nu + za * za)
    pz = jnp.sqrt(nu * nu + z * z)
    log_cancel = jnp.maximum(_eta(nu, za, pa) - jnp.real(_eta(nu, z, pz)), 0.0)
    log_trunc = jnp.log(jnp.abs(t) / jnp.abs(S) + 1e-300)
    log_err = jnp.maximum(log_cancel + jnp.log(3e-14), log_trunc)
    log_err = jnp.where(jnp.logical_or(log_cancel > 33.0, clamped), jnp.inf, log_err)
    return log_iv, log_err


def _log_iv_uniform(nu, z):
    """Uniform large-p expansion with Berry-smoothed recessive exponential;
    valid for θ = arg z ∈ [0, π/2].  Returns (log I, log-relative-error est)."""
    p = jnp.sqrt(nu * nu + z * z)
    x = (nu / p) ** 2
    eta = _eta(nu, z, p)
    pk = p[..., None] ** (-jnp.arange(_N_UNIFORM))
    uts = jnp.stack([_ut(k, x) for k in range(_N_UNIFORM)], axis=-1)
    S1 = jnp.sum(uts * pk, axis=-1)
    S2 = jnp.sum(uts * pk * (-1.0) ** jnp.arange(_N_UNIFORM), axis=-1)
    # Stokes line from the turning point z = iν sits at Im(2η) = νπ
    re2, im2 = 2.0 * jnp.real(eta), 2.0 * jnp.imag(eta)
    berry = (im2 - nu * jnp.pi) / jnp.sqrt(2.0 * jnp.abs(re2) + 1e-30)
    M = 0.5 * erfc(-berry)
    # the recessive exponential genuinely exists only outside the monotonic
    # region (Re 2η ≳ 0); a stray small-M · huge-e^{−2η} product is spurious
    live = (M > 1e-14) & (re2 > -5.0)
    expo = jnp.where(live, -2.0 * eta, 0.0)
    rec = jnp.where(live, M * jnp.exp(expo), 0.0)
    C = 1j * jnp.exp(1j * jnp.pi * nu)
    log_iv = (
        eta
        + jnp.log(S1 + C * rec * S2)
        - 0.5 * jnp.log(2.0 * jnp.pi)
        - 0.5 * jnp.log(p)
    )
    log_p = jnp.log(jnp.abs(p) + 1e-300)
    log_err_trunc = jnp.log(_UTILDE_NEXT_MAG) - _N_UNIFORM * log_p
    # near the Stokes line the erfc-smoothed multiplier is uncertain by
    # ~½erfc(|berry|−1), contributing relative error ΔM·e^{−2Reη}; deep in
    # the monotonic region (re2 ≤ −5) the recessive is identically absent
    dM = 0.5 * erfc(jnp.abs(berry) - 1.0)
    log_err_stokes = jnp.where(re2 > -5.0, jnp.log(dM + 1e-300) - re2, -jnp.inf)
    return log_iv, jnp.maximum(log_err_trunc, log_err_stokes)


_RECUR_SHIFT = 64  # order shift; seeds have p' = sqrt((nu+m)^2+z^2) >= m


def _log_iv_recurrence(nu, z, m: int = _RECUR_SHIFT):
    """Downward recurrence in order: I_{k−1}(z) = (2k/z)·I_k(z) + I_{k+1}(z),
    seeded at orders ν+m, ν+m+1 by the uniform expansion (where
    p' = √((ν+m)²+z²) is large even at ν's turning point z ≈ iν).  I is the
    dominant solution as the order decreases, so the recurrence is stable;
    it covers the Airy wedge near the turning point for large ν, where
    neither the series nor the direct uniform expansion is f64-accurate.

    Returns (log I_ν, log-relative-error est = seed error + roundoff)."""
    lo_a, err_a = _log_iv_uniform(nu + m + 1.0, z)  # I_{ν+m+1}
    lo_b, err_b = _log_iv_uniform(nu + m, z)  # I_{ν+m}
    s0 = jnp.real(lo_b)
    a = jnp.exp(lo_a - s0)  # higher order
    b = jnp.exp(lo_b - s0)  # lower order

    def body(i, carry):
        a, b, shift = carry  # a = I_{k+1}, b = I_k with k = ν+m−i
        k = nu + m - i
        new = (2.0 * k / z) * b + a  # I_{k−1}
        mag = jnp.abs(new)
        fac = jnp.where(mag > 1e120, 1e-120, 1.0)
        return b * fac, new * fac, shift - jnp.log(fac)

    a, b, shift = jax.lax.fori_loop(
        0, m, body, (a, b, jnp.zeros(jnp.shape(s0), jnp.float64)), unroll=16
    )
    log_iv = jnp.log(b) + shift + s0
    err = jnp.maximum(err_a, err_b) + jnp.log(float(m))
    return log_iv, err


def _log_iv_upper(nu, z_abs, theta, n_terms):
    """log I_ν(|z|·e^{iθ}) for θ ∈ [0, π/2]: min-error of the three branches."""
    z = z_abs * jnp.exp(1j * theta)
    lo_s, err_s = _log_iv_series(nu, z, n_terms)
    lo_u, err_u = _log_iv_uniform(nu, z)
    lo_r, err_r = _log_iv_recurrence(nu, z)
    best_su = jnp.where(err_s <= err_u, lo_s, lo_u)
    err_su = jnp.minimum(err_s, err_u)
    return jnp.where(err_su <= err_r, best_su, lo_r)


def log_besseli_complex(nu, z_abs, theta, n_terms: int = 96):
    """log I_ν(z) for z = |z|·e^{iθ} with θ an *unwrapped* (continuous) angle
    and real order ν > −1.

    Branch continuity: the multivaluedness of I_ν enters only through
    I_ν(z·e^{imπ}) = e^{imνπ}·I_ν(z), so the unwrapped angle is folded to the
    principal branch and the exact phase correction iν·(θ − θ_principal) is
    re-applied — the same correction the reference computes as
    ``log(besseli(ν, z)) + iν(θ_unwrapped − θ)`` (heston.jl:220-238).
    """
    z_abs = jnp.maximum(jnp.asarray(z_abs, jnp.float64), 1e-300)
    theta = jnp.asarray(theta, jnp.float64)
    theta_p = theta - 2.0 * jnp.pi * jnp.round(theta / (2.0 * jnp.pi))  # [−π, π]
    corr = 1j * nu * (theta - theta_p)

    neg = theta_p < 0.0
    b = jnp.abs(theta_p)  # [0, π]
    refl = b > 0.5 * jnp.pi
    # θ ∈ (π/2, π]: z = z'·e^{iπ} with arg z' = b − π ∈ (−π/2, 0], so
    # I(z) = e^{iνπ}·I(z') and conj-fold z' to the upper quadrant (π − b).
    b_up = jnp.where(refl, jnp.pi - b, b)  # [0, π/2]
    lo_up = _log_iv_upper(nu, z_abs, b_up, n_terms)
    lo_b = jnp.where(refl, 1j * nu * jnp.pi + jnp.conj(lo_up), lo_up)
    return corr + jnp.where(neg, jnp.conj(lo_b), lo_b)
