"""SVI (stochastic-volatility-inspired) implied-volatility surface.

Beyond the reference's flat/rect surfaces (src/market_inputs/vol_surface.jl):
the raw-SVI slice parameterization of Gatheral, the industry-standard smooth
smile, with the Gatheral-Jacquier no-arbitrage diagnostics and a batched
differentiable slice calibration.

Each expiry slice carries TOTAL VARIANCE in log-forward-moneyness
``k = log(K / F_t)``:

    w(k) = a + b · (ρ·(k − m) + sqrt((k − m)² + σ²))        (raw SVI)

and the surface interpolates total variance LINEARLY IN TIME at fixed
moneyness between slices (the standard construction — it preserves calendar
monotonicity whenever the slices themselves are ordered); outside the tenor
range total variance scales proportionally with t (constant-IV-in-k
extrapolation), which keeps w > 0 and calendar order.

Design: slice evaluation is closed-form (vmaps/jits trivially; no
tables), the no-arb diagnostics are exact derivatives of w (hand-written,
so they also hold under AD), and calibration is ONE vmapped bounded L-BFGS
over all slices (math/optimize.py) rather than a per-slice Python loop —
the same batched-solve idiom as calibration/implied.py.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..core.dates import ACT365F, to_ticks, yearfrac
from ..utils.pytree import pytree, static_field

__all__ = [
    "SVIVolSurface",
    "svi_total_variance",
    "svi_butterfly_margin",
    "svi_calendar_margin",
    "check_svi_arbitrage",
    "calibrate_svi_slices",
]


def svi_total_variance(params, k):
    """Raw-SVI total variance w(k); ``params = (a, b, rho, m, sigma)``
    broadcasting against ``k``."""
    a, b, rho, m, sigma = params
    km = jnp.asarray(k) - m
    return a + b * (rho * km + jnp.sqrt(km * km + sigma * sigma))


def _svi_w_dw_d2w(params, k):
    """w, w', w'' of a raw-SVI slice — closed forms (the hypotenuse
    derivative), used by the butterfly diagnostic and Dupire composition."""
    a, b, rho, m, sigma = params
    km = jnp.asarray(k) - m
    root = jnp.sqrt(km * km + sigma * sigma)
    w = a + b * (rho * km + root)
    dw = b * (rho + km / root)
    d2w = b * sigma * sigma / (root * root * root)
    return w, dw, d2w


def svi_butterfly_margin(params, k_grid):
    """Gatheral-Jacquier butterfly density factor

        g(k) = (1 − k·w′/(2w))² − (w′²/4)·(1/w + 1/4) + w″/2

    evaluated on ``k_grid``; the slice is butterfly-arbitrage-free iff
    g ≥ 0 (and w > 0) everywhere.  Returns the pointwise margin
    ``min(g, w)`` so ONE sign test covers both conditions; differentiable,
    so it can also ride calibration losses as a soft penalty."""
    w, dw, d2w = _svi_w_dw_d2w(params, k_grid)
    w_safe = jnp.maximum(w, 1e-12)
    g = (
        (1.0 - k_grid * dw / (2.0 * w_safe)) ** 2
        - 0.25 * dw * dw * (1.0 / w_safe + 0.25)
        + 0.5 * d2w
    )
    return jnp.minimum(g, w)


def svi_calendar_margin(params_slices, k_grid):
    """Minimum of w_{i+1}(k) − w_i(k) over adjacent slices on ``k_grid`` —
    ≥ 0 iff total variance is non-decreasing in maturity at fixed moneyness
    (no calendar arbitrage, Gatheral-Jacquier Lemma 2.1).  ``params_slices``
    has shape (n, 5)."""
    w = jax.vmap(lambda p: svi_total_variance(tuple(p), k_grid))(params_slices)
    return jnp.min(jnp.diff(w, axis=0)) if w.shape[0] > 1 else jnp.inf


@pytree
class SVIVolSurface:
    """Raw-SVI implied-vol surface: one (a, b, ρ, m, σ) slice per tenor.

    ``tenors`` are year fractions from ``reference_date`` (increasing);
    ``params`` has shape (n, 5); ``forwards`` are the T-forward levels
    F(tenor) fixing the moneyness convention k = log(K/F) (log-forward is
    interpolated linearly in t between tenors, i.e. a flat forward-rate
    bridge).  Composes with every pricer through ``get_vol`` exactly like
    Flat/Rect surfaces."""

    reference_date: Any
    tenors: Any
    params: Any
    forwards: Any
    daycount: Any = static_field(default=ACT365F)

    def __post_init__(self):
        object.__setattr__(self, "reference_date", to_ticks(self.reference_date))

    def forward_at(self, t):
        """F(t): linear log-forward interpolation, flat-forward-rate
        extrapolation from the outermost segments."""
        logf = jnp.log(jnp.asarray(self.forwards))
        tt = jnp.asarray(self.tenors)
        if tt.shape[0] == 1:
            return jnp.exp(logf[0] * jnp.ones_like(jnp.asarray(t, jnp.float64)))
        # jnp.interp clamps; extend the end slopes manually for t outside
        t = jnp.asarray(t, jnp.float64)
        inner = jnp.interp(t, tt, logf)
        lo = logf[0] + (logf[1] - logf[0]) / (tt[1] - tt[0]) * (t - tt[0])
        hi = logf[-1] + (logf[-1] - logf[-2]) / (tt[-1] - tt[-2]) * (t - tt[-1])
        out = jnp.where(t < tt[0], lo, jnp.where(t > tt[-1], hi, inner))
        return jnp.exp(out)

    def total_variance(self, t, strike):
        """w(t, k) with k = log(strike / F(t)): linear-in-t interpolation of
        the slice total variances at fixed k; proportional-in-t scaling
        outside the tenor range.  ``t`` is a SCALAR (strike may be any
        shape); vmap over expiries for time batches — a raw array ``t``
        would broadcast against the strike axis, not pair with it."""
        t = jnp.asarray(t, jnp.float64)
        if t.ndim > 0:
            raise TypeError(
                "SVIVolSurface.total_variance takes a scalar t; vmap over "
                "expiries for batched lookups"
            )
        k = jnp.log(jnp.asarray(strike, jnp.float64) / self.forward_at(t))
        tt = jnp.asarray(self.tenors)
        p = jnp.asarray(self.params)
        w_slices = jax.vmap(lambda row: svi_total_variance(tuple(row), k))(p)

        if tt.shape[0] == 1:
            return w_slices[0] * (t / tt[0])

        idx = jnp.clip(jnp.searchsorted(tt, t, side="right") - 1, 0, tt.shape[0] - 2)
        t0, t1 = tt[idx], tt[idx + 1]
        w0 = jnp.take(w_slices, idx, axis=0)
        w1 = jnp.take(w_slices, idx + 1, axis=0)
        frac = (t - t0) / (t1 - t0)
        inner = w0 + frac * (w1 - w0)
        below = w_slices[0] * (t / tt[0])
        above = w_slices[-1] * (t / tt[-1])
        return jnp.where(t < tt[0], below, jnp.where(t > tt[-1], above, inner))

    def vol_yf(self, t, strike):
        t = jnp.asarray(t, jnp.float64)
        w = self.total_variance(t, strike)
        return jnp.sqrt(jnp.maximum(w, 1e-14) / jnp.maximum(t, 1e-12))


def check_svi_arbitrage(surface: SVIVolSurface, *, k_lo=-1.5, k_hi=1.5, n=241):
    """No-arbitrage diagnostics on a moneyness grid: returns
    ``(butterfly_margin, calendar_margin)`` — per-slice min of the
    Gatheral-Jacquier g-margin, and the global calendar margin.  Both must
    be ≥ 0 for a clean surface; negative values localize the violation
    (differentiable, so they can be penalized during calibration)."""
    k_grid = jnp.linspace(k_lo, k_hi, n)
    p = jnp.asarray(surface.params)
    bf = jax.vmap(lambda row: jnp.min(svi_butterfly_margin(tuple(row), k_grid)))(p)
    cal = svi_calendar_margin(p, k_grid)
    return bf, cal


# ---- calibration -----------------------------------------------------------

# numpy (NOT jnp) on purpose: module-scope jnp.array executes on the default
# device backend at `import hedgehog_tpu`, which must stay computation-free
# so the multichip dryrun can bootstrap to CPU when the accelerator runtime
# is broken.  Converted to device arrays at call time below.
_DEF_LB = np.array([-0.5, 1e-6, -0.999, -2.0, 1e-4])
_DEF_UB = np.array([1.0, 5.0, 0.999, 2.0, 3.0])


def calibrate_svi_slices(
    tenors, forwards, strikes, ivs, *,
    x0=None, lb=None, ub=None, weights=None,
    butterfly_penalty: float = 0.0, max_iters: int = 300,
):
    """Fit one raw-SVI slice per tenor to implied vols — ALL slices in one
    vmapped bounded L-BFGS (math/optimize.py), the batched-solve idiom of
    calibration/implied.py (vs the reference's per-point serial loop,
    vol_surface.jl:215-233).

    ``strikes`` (n, m) or (m,), ``ivs`` (n, m); the loss per slice is the
    squared total-variance residual (market w = iv²·t), optionally weighted,
    plus ``butterfly_penalty · relu(−margin)²`` on the fitted slice when a
    positive penalty is given.  Returns ``(params (n,5), loss (n,),
    converged (n,))``."""
    from ..math.optimize import minimize_lbfgs

    tenors = jnp.asarray(tenors, jnp.float64)
    forwards = jnp.asarray(forwards, jnp.float64)
    ivs = jnp.asarray(ivs, jnp.float64)
    strikes = jnp.asarray(strikes, jnp.float64)
    if strikes.ndim == 1:
        strikes = jnp.broadcast_to(strikes, ivs.shape)
    k = jnp.log(strikes / forwards[:, None])
    w_mkt = ivs * ivs * tenors[:, None]
    wts = (
        jnp.ones_like(w_mkt)
        if weights is None
        # same broadcast contract as strikes: (m,) per-strike weights apply
        # to every slice
        else jnp.broadcast_to(jnp.asarray(weights, jnp.float64), w_mkt.shape)
    )

    lb = _DEF_LB if lb is None else jnp.asarray(lb, jnp.float64)
    ub = _DEF_UB if ub is None else jnp.asarray(ub, jnp.float64)
    if x0 is None:
        # moment-style initial guess per slice: level from the ATM variance,
        # wings from the observed half-spread, m at the smile minimum
        w_min = jnp.min(w_mkt, axis=1)
        k_at_min = jnp.take_along_axis(
            k, jnp.argmin(w_mkt, axis=1)[:, None], axis=1
        )[:, 0]
        span = jnp.maximum(jnp.max(w_mkt, axis=1) - w_min, 1e-6)
        x0 = jnp.stack(
            [
                0.8 * w_min,
                span / jnp.maximum(jnp.max(jnp.abs(k), axis=1), 0.1),
                jnp.zeros_like(w_min),
                k_at_min,
                0.1 * jnp.ones_like(w_min),
            ],
            axis=1,
        )
    else:
        x0 = jnp.broadcast_to(jnp.asarray(x0, jnp.float64), (tenors.shape[0], 5))

    def fit_one(x0_row, k_row, w_row, wt_row):
        def loss(p):
            resid = svi_total_variance(tuple(p), k_row) - w_row
            out = jnp.sum(wt_row * resid * resid)
            if butterfly_penalty > 0.0:
                margin = svi_butterfly_margin(tuple(p), k_row)
                out = out + butterfly_penalty * jnp.sum(
                    jnp.maximum(-margin, 0.0) ** 2
                )
            return out

        res = minimize_lbfgs(loss, x0_row, lb, ub, max_iters=max_iters)
        return res.x, res.loss, res.converged

    params, loss, conv = jax.vmap(fit_one)(x0, k, w_mkt, wts)
    return params, loss, conv
