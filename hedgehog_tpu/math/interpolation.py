"""1-D and nested 2-D interpolation with constant (clamped) extrapolation.

Jit-friendly replacement for the reference's DataInterpolations.jl usage
(reference src/market_inputs/rate_curve.jl:76, vol_surface.jl:37-46):
LinearInterpolation / CubicSpline with ExtrapolationType.Constant.

Design: interpolators are *functions of the knot data*, not stateful objects.
Coefficients (for cubic) are recomputed inside the evaluation so that AD flows
from knot values to interpolated outputs — this is what makes lens-bumped
curves (ZeroRateSpineLens) differentiable without a "builder closure".
Everything is jit/vmap-safe: fixed shapes, no data-dependent control flow.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["interp1d", "interp2d_nested", "INTERP_KINDS"]

INTERP_KINDS = ("linear", "quadratic", "cubic")


def _natural_cubic_second_derivs(xs, ys):
    """Second derivatives M_i of the natural cubic spline through (xs, ys).

    Thomas tridiagonal solve (math/linalg.py): plain arithmetic, no LU
    custom call.
    """
    from .linalg import tridiag_solve

    n = xs.shape[0]
    h = xs[1:] - xs[:-1]  # (n-1,)
    # Interior equations: h[i-1] M[i-1] + 2(h[i-1]+h[i]) M[i] + h[i] M[i+1] = rhs
    # Natural boundaries: M[0] = M[n-1] = 0.
    dl = jnp.concatenate([jnp.zeros((1,), ys.dtype), h[:-1], jnp.zeros((1,), ys.dtype)])
    d = jnp.concatenate(
        [jnp.ones((1,), ys.dtype), 2.0 * (h[:-1] + h[1:]), jnp.ones((1,), ys.dtype)]
    )
    du = jnp.concatenate([jnp.zeros((1,), ys.dtype), h[1:], jnp.zeros((1,), ys.dtype)])
    slope = (ys[1:] - ys[:-1]) / h
    rhs = jnp.concatenate(
        [jnp.zeros((1,), ys.dtype), 6.0 * (slope[1:] - slope[:-1]), jnp.zeros((1,), ys.dtype)]
    )
    return tridiag_solve(dl, d, du, rhs)


def interp1d(x, xs, ys, kind: str = "linear"):
    """Evaluate a 1-D interpolant of (xs, ys) at x, clamping outside [xs0, xsN].

    - ``kind='linear'``: piecewise linear (matches LinearInterpolation +
      constant extrapolation).
    - ``kind='cubic'``: natural cubic spline (matches CubicSpline + constant
      extrapolation).

    ``x`` may be scalar or any-shaped array; broadcasting over x.
    Degenerate single-knot data returns ys[0].
    """
    xs = jnp.asarray(xs)
    ys = jnp.asarray(ys)
    x = jnp.asarray(x)
    if xs.shape[0] == 1:
        return jnp.broadcast_to(ys[0], x.shape)
    xq = jnp.clip(x, xs[0], xs[-1])
    if kind == "linear":
        return jnp.interp(xq, xs, ys)
    if kind == "quadratic":
        if xs.shape[0] == 2:
            return jnp.interp(xq, xs, ys)
        # Lagrange quadratic through the three knots around the query interval
        # (QuadraticInterpolation parity, reference rate-curve tests use it).
        i = jnp.clip(jnp.searchsorted(xs, xq, side="right") - 1, 1, xs.shape[0] - 2)
        x0, x1, x2 = xs[i - 1], xs[i], xs[i + 1]
        y0, y1, y2 = ys[i - 1], ys[i], ys[i + 1]
        l0 = (xq - x1) * (xq - x2) / ((x0 - x1) * (x0 - x2))
        l1 = (xq - x0) * (xq - x2) / ((x1 - x0) * (x1 - x2))
        l2 = (xq - x0) * (xq - x1) / ((x2 - x0) * (x2 - x1))
        return y0 * l0 + y1 * l1 + y2 * l2
    if kind == "cubic":
        M = _natural_cubic_second_derivs(xs, ys)
        return _cubic_eval(xq, xs, ys, M)
    raise ValueError(f"unknown interpolation kind {kind!r}; expected one of {INTERP_KINDS}")


def _cubic_eval(xq, xs, ys, M):
    """Evaluate a natural cubic spline from precomputed second derivatives M
    (xq must already be clamped to [xs[0], xs[-1]])."""
    i = jnp.clip(jnp.searchsorted(xs, xq, side="right") - 1, 0, xs.shape[0] - 2)
    x0, x1 = xs[i], xs[i + 1]
    h = x1 - x0
    t0 = (x1 - xq) / h
    t1 = (xq - x0) / h
    return (
        t0 * ys[i]
        + t1 * ys[i + 1]
        + ((t0**3 - t0) * M[i] + (t1**3 - t1) * M[i + 1]) * (h**2) / 6.0
    )


def interp2d_nested(x, y, x_vals, y_vals, values, kind_x: str = "linear", kind_y: str = "linear"):
    """Nested 1-D interpolation on a rectangular grid, clamped on both axes.

    Semantics match the reference Interpolator2D (src/market_inputs/
    vol_surface.jl:12-57): first interpolate each x-row along y, then
    interpolate the resulting column along x.  ``values`` has shape
    (len(x_vals), len(y_vals)); x/y are scalars or broadcastable arrays
    (array queries — e.g. a whole strike grid — are vmapped pointwise).
    """
    import jax

    values = jnp.asarray(values)
    y_vals_arr = jnp.asarray(y_vals)
    x = jnp.asarray(x)
    y = jnp.asarray(y)

    if kind_y == "cubic" and y_vals_arr.shape[0] > 1:
        # hoist the per-row tridiagonal solves out of the query vmap: the
        # spline coefficients depend only on the grid, not on the queries
        Ms = jax.vmap(lambda row: _natural_cubic_second_derivs(y_vals_arr, row))(values)

        def rows_at(yq):
            yc = jnp.clip(yq, y_vals_arr[0], y_vals_arr[-1])
            return jax.vmap(lambda row, M: _cubic_eval(yc, y_vals_arr, row, M))(values, Ms)

    else:

        def rows_at(yq):
            return jax.vmap(lambda row: interp1d(yq, y_vals, row, kind=kind_y))(values)

    def scalar_query(xq, yq):
        return interp1d(xq, x_vals, rows_at(yq), kind=kind_x)

    if x.ndim == 0 and y.ndim == 0:
        return scalar_query(x, y)
    xb, yb = jnp.broadcast_arrays(x, y)
    flat = jax.vmap(scalar_query)(xb.ravel(), yb.ravel())
    return flat.reshape(xb.shape)
