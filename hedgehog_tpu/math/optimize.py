"""Box-bounded L-BFGS for calibration.

Jit-friendly replacement for the reference's Optimization.jl + OptimizationOptimJL
LBFGS with AutoForwardDiff and mandatory box bounds for Heston
(calibration.jl:74-98, examples/heston_calib.jl:109-117).

Bounds are enforced by a smooth sigmoid reparameterization
``x = lb + (ub−lb)·σ(y)`` so the inner optimizer (optax.lbfgs with zoom
linesearch) runs unconstrained; gradients come from ``jax.value_and_grad``
through the full pricing pipeline.  The optimization runs in a bounded
``lax.while_loop`` with early exit and honest convergence diagnostics —
jit-able and vmappable, but NOT reverse-differentiable through the loop
(optax's zoom linesearch is itself a while_loop, so unrolling would not
help).  To differentiate quantities downstream of a calibration, use
:func:`argmin_ift`, which reattaches gradients to the solved optimum via
the implicit function theorem — the multivariate sibling of
math/rootfind.py's ``implicit_root``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import optax

__all__ = ["minimize_lbfgs", "LBFGSResult", "argmin_ift"]


def argmin_ift(fun: Callable, x_star, args):
    """Differentiable view of a solved optimum (implicit function theorem).

    Given ``x_star ≈ argmin_x fun(x, args)`` from ANY optimizer (e.g.
    :func:`minimize_lbfgs`, whose while_loop is not reverse-differentiable),
    returns ``x_star`` re-attached to the autodiff graph of ``args`` via the
    first-order condition ∇ₓf(x*, args) = 0:

        dx*/dargs = −H⁻¹ · ∂²f/∂x∂args,   H = ∇²ₓf(x*, args),

    implemented as a custom VJP with one dense Hessian solve (calibration
    parameter vectors are small, ≤ ~10).  The returned value equals
    ``x_star`` exactly; only its gradients change.  Typical use::

        res  = minimize_lbfgs(lambda x: loss(x, args), x0, lb, ub)
        x_d  = argmin_ift(loss, res.x, args)      # differentiable optimum
        risk = jax.grad(lambda a: downstream(argmin_ift(loss, res.x, a)))

    Accuracy of the gradients degrades with the optimizer's residual
    ‖∇ₓf(x*)‖ — check ``res.converged`` first.  For box-constrained solves
    the IFT is valid while the optimum is interior (active bounds make the
    first-order condition inequality-constrained).
    """

    @jax.custom_vjp
    def _attach(x_star, args):
        return x_star

    def _fwd(x_star, args):
        return x_star, (x_star, args)

    def _bwd(res, g):
        x_star, args = res
        H = jax.hessian(fun, argnums=0)(x_star, args)
        n = x_star.size
        # Plain-arithmetic solve (math/linalg.py) instead of the LU custom
        # call of jnp.linalg.solve, so it also batches under vmapped
        # cotangents (e.g. jax.jacobian of a calibrated optimum).  The
        # Hessian at an interior optimum is SPD;
        # symmetrize + ridge guard the nearly-converged case.
        from .linalg import cholesky_solve_small

        Hs = 0.5 * (H.reshape(n, n) + H.reshape(n, n).T)
        Hs = Hs + 1e-12 * jnp.eye(n, dtype=Hs.dtype) * jnp.trace(Hs)
        w = cholesky_solve_small(Hs, g.reshape(n)).reshape(x_star.shape)
        _, vjp_args = jax.vjp(lambda a: jax.grad(fun, argnums=0)(x_star, a), args)
        (g_args,) = vjp_args(-w)
        return jnp.zeros_like(x_star), g_args

    _attach.defvjp(_fwd, _bwd)
    return _attach(x_star, args)


class LBFGSResult(NamedTuple):
    x: jnp.ndarray
    loss: jnp.ndarray
    iterations: jnp.ndarray
    converged: jnp.ndarray


_LOGIT_CLIP = 1e-8


def _to_unconstrained(x, lb, ub):
    t = jnp.clip((x - lb) / (ub - lb), _LOGIT_CLIP, 1.0 - _LOGIT_CLIP)
    return jnp.log(t) - jnp.log1p(-t)


def _to_constrained(y, lb, ub):
    return lb + (ub - lb) * jax.nn.sigmoid(y)


def minimize_lbfgs(
    fun: Callable,
    x0,
    lb=None,
    ub=None,
    *,
    max_iters: int = 200,
    grad_tol: float = 1e-8,
    f_rel_tol: float = 1e-12,
) -> LBFGSResult:
    """Minimize ``fun(x)`` with optional elementwise box bounds.

    Runs a bounded ``lax.while_loop`` with early exit — mirroring Optim.jl's
    behavior behind the reference's calibration (calibration.jl:74-98):

    - ``converged`` is True iff an exit criterion fired before ``max_iters``:
      gradient inf-norm < ``grad_tol`` (Optim's g_tol-style test) OR relative
      objective change ≤ ``f_rel_tol``·max(1, |f|) between iterations — the
      criterion realistic MC/Fourier calibrations actually meet.
    - ``iterations`` is the real count of L-BFGS steps taken.

    Returns the best iterate seen, in the original (constrained) space.
    The optimization is NOT reverse-differentiable (the loop — and optax's
    zoom linesearch inside it — are while_loops); to differentiate
    quantities downstream of a calibration, reattach gradients to the
    solved optimum with :func:`argmin_ift` (implicit function theorem).
    """
    x0 = jnp.asarray(x0, jnp.float64)
    bounded = lb is not None or ub is not None
    if bounded:
        lb = jnp.broadcast_to(jnp.asarray(-1e6 if lb is None else lb, jnp.float64), x0.shape)
        ub = jnp.broadcast_to(jnp.asarray(1e6 if ub is None else ub, jnp.float64), x0.shape)

        def obj(y):
            return fun(_to_constrained(y, lb, ub))

        y0 = _to_unconstrained(x0, lb, ub)
    else:

        def obj(y):
            return fun(y)

        y0 = x0

    solver = optax.lbfgs()
    value_and_grad = optax.value_and_grad_from_state(obj)
    state0 = solver.init(y0)

    def cond(carry):
        _, _, _, _, _, it, done = carry
        return jnp.logical_and(~done, it < max_iters)

    def body(carry):
        y, state, best_y, best_val, prev_val, it, _ = carry
        value, grad = value_and_grad(y, state=state)
        updates, state = solver.update(grad, state, y, value=value, grad=grad, value_fn=obj)
        y_new = optax.apply_updates(y, updates)
        better = value < best_val
        best_y = jnp.where(better, y, best_y)
        best_val = jnp.minimum(value, best_val)
        g_small = jnp.max(jnp.abs(grad)) < grad_tol
        f_stalled = jnp.abs(prev_val - value) <= f_rel_tol * jnp.maximum(1.0, jnp.abs(value))
        done = jnp.logical_or(g_small, f_stalled)
        return (y_new, state, best_y, best_val, value, it + 1, done)

    init = (y0, state0, y0, obj(y0), jnp.inf, jnp.asarray(0), jnp.asarray(False))
    y_final, _, best_y, best_val, _, iters, done = jax.lax.while_loop(cond, body, init)
    final_val = obj(y_final)
    take_final = final_val <= best_val
    y_out = jnp.where(take_final, y_final, best_y)
    loss = jnp.where(take_final, final_val, best_val)
    x_out = _to_constrained(y_out, lb, ub) if bounded else y_out
    return LBFGSResult(x=x_out, loss=loss, iterations=iters, converged=done)
