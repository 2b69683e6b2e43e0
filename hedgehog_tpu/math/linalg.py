"""Tiny structured linear solvers in plain arithmetic.

The systems we actually solve are tiny and structured, so they get direct
implementations in plain arithmetic (add/mul/div) instead of the general
LU-based ``jnp.linalg.solve``: fully fusible, batched over leading axes and
f64 everywhere:

- ``cholesky_solve_small``: unrolled Cholesky for static-size SPD systems
  (LSM normal equations, (degree+1)² ≤ 8²);
- ``tridiag_solve``: Thomas algorithm as a ``lax.scan`` (natural cubic spline
  coefficients);
- ``tridiag_solve_pcr``: parallel cyclic reduction — ⌈log₂n⌉ fully
  vectorized elimination stages instead of a length-n sequential sweep,
  the wide solver for the PDE engine's per-time-step systems (a Thomas
  scan of n≈500 scalar steps is latency-bound; PCR is ~9 wide stages) and
  batched over leading axes.

All are differentiable (pure jnp ops, no custom primitives).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

__all__ = ["cholesky_solve_small", "tridiag_solve", "tridiag_solve_pcr"]


def cholesky_solve_small(A, b):
    """Solve SPD ``A x = b`` for static n = A.shape[-1] (unrolled, n ≤ ~12).

    A must be symmetric positive definite (callers add a ridge).
    """
    n = A.shape[-1]
    L = jnp.zeros_like(A)
    for j in range(n):
        s = A[j, j] - sum(L[j, k] ** 2 for k in range(j))
        ljj = jnp.sqrt(jnp.maximum(s, 1e-300))
        L = L.at[j, j].set(ljj)
        for i in range(j + 1, n):
            s = A[i, j] - sum(L[i, k] * L[j, k] for k in range(j))
            L = L.at[i, j].set(s / ljj)
    # forward substitution L y = b
    y = jnp.zeros_like(b)
    for i in range(n):
        s = b[i] - sum(L[i, k] * y[k] for k in range(i))
        y = y.at[i].set(s / L[i, i])
    # back substitution Lᵀ x = y
    x = jnp.zeros_like(b)
    for i in reversed(range(n)):
        s = y[i] - sum(L[k, i] * x[k] for k in range(i + 1, n))
        x = x.at[i].set(s / L[i, i])
    return x


def tridiag_solve(dl, d, du, b):
    """Thomas algorithm for a tridiagonal system (lax.scan sweeps).

    ``dl``/``du`` are the sub/super-diagonals (length n, with dl[0] and
    du[-1] ignored), ``d`` the diagonal, ``b`` the rhs.
    """
    du = jnp.asarray(du).at[-1].set(0.0)  # unused, zero defensively

    def fwd(carry, inp):
        c_prev, dben_prev = carry
        dl_i, d_i, du_i, b_i = inp
        denom = d_i - dl_i * c_prev
        c_i = du_i / denom
        dben_i = (b_i - dl_i * dben_prev) / denom
        return (c_i, dben_i), (c_i, dben_i)

    inputs = (
        jnp.concatenate([jnp.zeros((1,), d.dtype), dl[1:]]),
        d,
        du,
        b,
    )
    _, (c, dben) = jax.lax.scan(fwd, (jnp.zeros((), d.dtype), jnp.zeros((), d.dtype)),
                                jax.tree.map(jnp.asarray, inputs))

    def back(x_next, inp):
        c_i, dben_i = inp
        x_i = dben_i - c_i * x_next
        return x_i, x_i

    _, xs = jax.lax.scan(back, jnp.zeros((), d.dtype), (c, dben), reverse=True)
    return xs


def tridiag_solve_pcr(dl, d, du, b):
    """Tridiagonal solve by parallel cyclic reduction over the LAST axis.

    ``dl``/``du`` are the sub/super-diagonals (same length n as ``d``, with
    ``dl[..., 0]`` and ``du[..., -1]`` ignored), ``b`` the right-hand side;
    leading axes batch.  Each of the ⌈log₂n⌉ stages eliminates the
    distance-s neighbors of every row simultaneously:

        row_i ← row_i − (dl_i/d_{i−s})·row_{i−s} − (du_i/d_{i+s})·row_{i+s}

    which squares the coupling distance, so after ⌈log₂n⌉ stages the system
    is diagonal and ``x = b/d``.  Out-of-range neighbors read padded
    identity rows (d=1, dl=du=b=0), making every stage shape-static and
    branch-free.  Stable for the diagonally-dominant / M-matrix systems the
    PDE stepper produces (Péclet-upwinded theta-scheme); ~n·log n flops on
    ⌈log₂n⌉ wide stages vs the Thomas scan's n sequential steps.
    """
    dl, d, du, b = jnp.broadcast_arrays(
        jnp.asarray(dl), jnp.asarray(d), jnp.asarray(du), jnp.asarray(b)
    )
    n = d.shape[-1]
    stages = max(1, math.ceil(math.log2(n))) if n > 1 else 0
    # defensive: the ignored corner entries must not couple padding rows in
    dl = dl.at[..., 0].set(0.0)
    du = du.at[..., -1].set(0.0)

    def shift(a, s, fill):
        # a[..., i − s] (s > 0: from the left) / a[..., i + s] (s < 0),
        # out-of-range slots reading ``fill``
        rolled = jnp.roll(a, s, axis=-1)
        i = jnp.arange(n)
        valid = (i >= s) if s > 0 else (i < n + s)
        return jnp.where(valid, rolled, fill)

    s = 1
    for _ in range(stages):
        d_m, dl_m, du_m, b_m = (shift(a, s, f) for a, f in
                                ((d, 1.0), (dl, 0.0), (du, 0.0), (b, 0.0)))
        d_p, dl_p, du_p, b_p = (shift(a, -s, f) for a, f in
                                ((d, 1.0), (dl, 0.0), (du, 0.0), (b, 0.0)))
        alpha = -dl / d_m
        gamma = -du / d_p
        d = d + alpha * du_m + gamma * dl_p
        b = b + alpha * b_m + gamma * b_p
        dl = alpha * dl_m
        du = gamma * du_p
        s *= 2
    return b / d
