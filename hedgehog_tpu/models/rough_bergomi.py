"""Rough Bergomi model (Bayer-Friz-Gatheral 2016) — exact-Volterra simulation.

Beyond-reference model family (the reference covers BS + Heston;
src/distributions/heston.jl is its only stochastic-vol
model).  Rough Bergomi is the canonical *rough volatility* model:

    V_t = xi0 · exp(η·Z_t − ½η²·t^{2H}),
    Z_t = √(2H) ∫_0^t (t−s)^{H−1/2} dW1_s          (Riemann-Liouville fBM)
    dS/S = (r − q) dt + √V_t (ρ dW1 + √(1−ρ²) dW⊥)

with Hurst index H ∈ (0, ½] — H ≈ 0.05-0.15 reproduces the power-law ATM
skew term structure (∝ T^{H−½}) equity markets show.  V is non-Markovian:
there is no finite-dimensional SDE state, no characteristic function, and
no closed-form vanilla price — Monte Carlo IS the pricing method, which is
exactly why the model belongs in an accelerator framework.

Design
------
The standard simulation scheme in the literature is the *hybrid scheme*
(Bennedsen-Lunde-Pakkanen 2017): truncate the singular kernel, convolve by
FFT — O(n log n) per path, chosen because on CPUs an O(n²) dense approach
is "too slow".  On an accelerator that trade is backwards: a
(2n × 2n) @ (2n × paths) matmul is cheap at n ≲ 512, so this module draws the joint Gaussian vector

    X = (ΔW1_0, …, ΔW1_{n−1},  Z_{t_1}, …, Z_{t_n})

EXACTLY from its analytic covariance via one Cholesky factor computed at
trace time and one matmul per megabatch.  The gridpoint law of (V, W1) is
then *exact* (no kernel-truncation bias, unlike the hybrid scheme); the
only remaining discretization is the left-point Riemann sum for
(∫V dt, ∫√V dW1).  The left-point rule makes

    E[ exp(ρ·Σ√V_k ΔW_k − ½ρ²·ΣV_k Δt) ] = 1     (exactly, each factor
                                                   is a conditional GBM)

so the mixing estimator's effective forward is unbiased at ANY step count
and put-call parity holds to MC error.

Covariances (t_j grid points, [t_i, t_{i+1}] increments, s ≤ t):

    Cov(ΔW_i, ΔW_j)   = Δt·δ_ij
    Cov(Z_t, ΔW_i)    = √(2H)/(H+½) · [(t−t_i)^{H+½} − (t−t_{i+1})_+^{H+½}]
    Var(Z_t)          = t^{2H}
    Cov(Z_s, Z_t)     = 2H ∫_0^s (s−u)^{H−1/2}(t−u)^{H−1/2} du
                      = 2H·s^{H+½}/(H+½) · ∫_0^1 (t−s+s·y^{1/(H+½)})^{H−1/2} dy

where the last line substitutes (s−u) = s·y^{1/(H+½)} to absorb the
integrable endpoint singularity — the transformed integrand is smooth on
[0, 1], so a fixed Gauss-Legendre rule (``quad_nodes``) converges fast and
stays differentiable in H (the framework's lens/AD contract: ∂price/∂H —
roughness vega — is one `jax.grad` away).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from ..utils.pytree import pytree

__all__ = [
    "ForwardVarianceCurve",
    "volterra_cov",
    "volterra_chol",
    "rbergomi_variance",
]

_QUAD_NODES = 64


def _leggauss01(nodes: int):
    x, w = np.polynomial.legendre.leggauss(nodes)
    return jnp.asarray((x + 1.0) / 2.0), jnp.asarray(w / 2.0)


def _pow(base, expo):
    """base**expo with an AD-safe base==0 branch (0**e · log 0 → nan guard)."""
    pos = base > 0.0
    safe = jnp.where(pos, base, 1.0)
    return jnp.where(pos, safe**expo, 0.0)


def volterra_cov(hurst, times, quad_nodes: int = _QUAD_NODES):
    """Joint covariance of (ΔW_0..ΔW_{n−1}, Z_{t_1}..Z_{t_n}), shape (2n, 2n).

    ``times``: strictly increasing grid t_1 < … < t_n (t_0 = 0 implied);
    Z_{t_k} = √(2H)∫_0^{t_k}(t_k−s)^{H−1/2} dW_s, ΔW_i = W_{t_{i+1}} − W_{t_i}.
    Differentiable in ``hurst`` (the roughness greek flows through the
    Gauss-Legendre panel and the Cholesky downstream)."""
    t = jnp.asarray(times)
    n = t.shape[0]
    t0 = jnp.concatenate([jnp.zeros((1,), t.dtype), t[:-1]])  # left endpoints
    dt = t - t0
    h = hurst
    hp = h + 0.5

    a_block = jnp.diag(dt)

    # B[j, i] = Cov(Z_{t_{j+1}}, ΔW_i): the kernel integrated over [t_i, t_{i+1}]
    d_l = t[:, None] - t0[None, :]
    d_r = t[:, None] - t[None, :]
    b_block = (
        jnp.sqrt(2.0 * h) / hp * (_pow(d_l, hp) - _pow(jnp.maximum(d_r, 0.0), hp))
    )
    b_block = jnp.where(d_l > 0.0, b_block, 0.0)

    # C[j, k] = Cov(Z_{t_{j+1}}, Z_{t_{k+1}}); closed-form diagonal t^{2H},
    # Gauss-Legendre panel (singularity absorbed) off the diagonal.
    y, w = _leggauss01(quad_nodes)
    s = jnp.minimum(t[:, None], t[None, :])
    tt = jnp.maximum(t[:, None], t[None, :])
    gap = tt - s
    yp = _pow(y, 1.0 / hp)  # (q,)
    base = gap[..., None] + s[..., None] * yp  # (n, n, q), > 0 off-diagonal
    # AD guard: on the diagonal (gap == 0) the panel integrand is singular at
    # y = 0; the where keeps those lanes finite, the closed form replaces them
    integ = _pow(jnp.where(gap[..., None] > 0.0, base, 1.0), h - 0.5)
    panel = jnp.sum(integ * w, axis=-1)
    c_off = 2.0 * h / hp * _pow(s, hp) * panel
    c_block = jnp.where(gap > 0.0, c_off, _pow(tt, 2.0 * h))

    top = jnp.concatenate([a_block, b_block.T], axis=1)
    bot = jnp.concatenate([b_block, c_block], axis=1)
    cov = jnp.concatenate([top, bot], axis=0)
    return 0.5 * (cov + cov.T)


def volterra_chol(hurst, horizon, steps: int, quad_nodes: int = _QUAD_NODES):
    """Lower Cholesky factor (2n × 2n) of :func:`volterra_cov` on the uniform
    grid t_k = k·T/n — the one-time setup for exact joint (ΔW, Z) draws:
    X = L @ ξ, ξ ~ N(0, I).  A tiny relative jitter keeps the factorization
    stable in float32 (the matrix is analytically PD)."""
    t = (jnp.arange(1, steps + 1) / steps) * horizon
    cov = volterra_cov(hurst, t, quad_nodes=quad_nodes)
    jitter = 1e-12 * jnp.max(jnp.diag(cov))
    return jnp.linalg.cholesky(cov + jitter * jnp.eye(2 * steps, dtype=cov.dtype))


def rbergomi_variance(market, z, t_left):
    """Instantaneous variance at the grid LEFT points from exact Volterra
    samples: V_k = ξ₀(t_k)·exp(η·Z_{t_k} − ½η²·t_k^{2H}) with Z_0 = 0 — the
    exponential-martingale normalization makes E[V_t] = ξ₀(t) exactly
    (``xi0`` scalar = flat forward variance; a
    :class:`ForwardVarianceCurve` = the practitioner fit to the
    variance-swap strip).  ``z``: (..., n) with z[..., 0] ≡ Z_0 = 0."""
    dt_ = jnp.asarray(z).dtype  # follow the draw dtype (the fp32=True path)
    eta = jnp.asarray(market.eta, dt_)
    t2h = _pow(jnp.asarray(t_left, dt_), jnp.asarray(2.0 * market.hurst, dt_))
    xi0 = market.xi0
    level = xi0(t_left) if isinstance(xi0, ForwardVarianceCurve) else xi0
    return jnp.asarray(level, dt_) * jnp.exp(eta * z - 0.5 * eta**2 * t2h)


@pytree
class ForwardVarianceCurve:
    """Piecewise-linear forward-variance term structure ξ₀(t) for rough
    Bergomi (E[V_t] = ξ₀(t) by the exponential-martingale normalization):
    ``tenors`` (year fractions, increasing) and ``xi`` (variance levels,
    e.g. squared vol-swap marks) are BOTH pytree leaves — bucketed
    variance-curve vegas ∂price/∂ξᵢ come from one ``jax.grad``, the
    rates-curve key-rate idiom applied to the variance curve.  Flat
    extrapolation outside the spine."""

    tenors: object
    xi: object

    def __call__(self, t):
        return jnp.interp(
            jnp.asarray(t), jnp.asarray(self.tenors), jnp.asarray(self.xi)
        )
