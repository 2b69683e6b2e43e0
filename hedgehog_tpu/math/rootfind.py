"""Batched, differentiable bracketed root-finding.

Jit-friendly replacement for the reference's NonlinearSolve/Roots usage
(calibration.jl:143-144 Brent on a fixed bracket; sample_from_cf.jl:105-135
Newton→bisection fallback chain).  Design per SURVEY §7:

- the iteration is a fixed-trip-count ``lax.while_loop``-free ``fori_loop``
  bisection (branchless, vectorizes over any batch of instruments — one XLA
  program inverts a whole vol surface);
- differentiability comes from the implicit function theorem, implemented as
  **one differentiable Newton polish** on top of the gradient-stopped solve:
  ``x* − f(x*)/f'(x*)`` has the exact IFT Jacobian ``−f_θ/f_x`` in both
  forward and reverse mode, with no unrolled-loop tape.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["bisect_root", "implicit_root", "implicit_root_full", "RootResult"]


class RootResult(NamedTuple):
    """Root plus the diagnostics the solve produced for free."""

    root: jnp.ndarray
    converged: jnp.ndarray  # a sign change existed on the initial bracket
    residual: jnp.ndarray  # f at the bisection root (pre-polish)


def _bisect_root_impl(f: Callable, lo, hi, iters: int):
    """Bisection core: returns (root, bracketed_mask)."""
    lo = jnp.asarray(lo, jnp.float64)
    hi = jnp.asarray(hi, jnp.float64)
    f_lo0 = f(lo)
    f_hi0 = f(hi)

    def body(_, carry):
        lo, hi, f_lo = carry
        mid = 0.5 * (lo + hi)
        f_mid = f(mid)
        go_left = jnp.sign(f_mid) == jnp.sign(f_lo)
        new_lo = jnp.where(go_left, mid, lo)
        new_f_lo = jnp.where(go_left, f_mid, f_lo)
        new_hi = jnp.where(go_left, hi, mid)
        return new_lo, new_hi, new_f_lo

    lo_f, hi_f, _ = jax.lax.fori_loop(0, iters, body, (lo, hi, f_lo0))
    x = 0.5 * (lo_f + hi_f)
    # No-sign-change fallback: pick the better endpoint.
    bracketed = jnp.sign(f_lo0) != jnp.sign(f_hi0)
    better_endpoint = jnp.where(jnp.abs(f_lo0) < jnp.abs(f_hi0), lo, hi)
    return jnp.where(bracketed, x, better_endpoint), bracketed


def bisect_root(f: Callable, lo, hi, iters: int = 80):
    """Root of scalar-monotone ``f`` on [lo, hi] by bisection (primal only).

    ``f`` must be vectorized; ``lo``/``hi`` may be arrays (batched brackets).
    With 80 iterations the bracket shrinks by 2^-80 ≈ 1e-24 — beyond f64.
    If f(lo) and f(hi) share a sign, returns the endpoint with smaller |f|
    (the reference's clamp-with-warn fallback, sample_from_cf.jl:124-127).
    """
    return _bisect_root_impl(f, lo, hi, iters)[0]


def implicit_root(f: Callable, lo, hi, iters: int = 80):
    """Differentiable bracketed root: bisection primal + IFT-correct gradients.

    Returns x with value ``x* − f(x*)/f_x(x*)`` where x* is the (gradient-
    stopped) bisection root: the polish leaves the primal at the root (f≈0)
    while its derivative w.r.t. any traced parameter captured in ``f`` equals
    the implicit-function-theorem sensitivity ``−f_θ/f_x``.
    """
    return implicit_root_full(f, lo, hi, iters).root


def implicit_root_full(f: Callable, lo, hi, iters: int = 80) -> RootResult:
    """:func:`implicit_root` plus free diagnostics (no extra ``f`` evals):
    ``converged`` = a sign change existed on the bracket (without one the
    result is the clamp endpoint, calibration.jl:126-145 semantics), and
    ``residual`` = f at the bisection root — already computed by the Newton
    polish, so reporting it costs nothing."""
    root, bracketed = _bisect_root_impl(f, lo, hi, iters)
    x_star = jax.lax.stop_gradient(root)
    bracketed = jax.lax.stop_gradient(bracketed)

    # One Newton step, fully on the tape.
    fx, f_prime = jax.jvp(f, (x_star,), (jnp.ones_like(x_star),))
    safe = jnp.where(jnp.abs(f_prime) > 1e-300, f_prime, 1.0)
    polished = x_star - fx / safe
    # Unbracketed targets (e.g. a quote outside the attainable price range)
    # must not be extrapolated by the polish: return the clamp endpoint, the
    # reference's fall-back-with-warn behavior (sample_from_cf.jl:124-127).
    return RootResult(
        root=jnp.where(bracketed, polished, x_star),
        converged=bracketed,
        residual=jax.lax.stop_gradient(fx),
    )
