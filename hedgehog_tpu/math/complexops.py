"""Split-complex arithmetic: complex math as (re, im) real-array pairs.

The characteristic-function math in explicit real pairs — plain f32/f64
elementwise ops (mul/div/exp/log/atan2/sqrt), fully fusible and
differentiable.  This is the ``engine="pair"`` alternative of
methods/carr_madan.py; the native complex128 engine is the default on every
backend.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

__all__ = ["cmul", "cdiv", "cexp", "clog", "csqrt", "cabs2"]

Pair = Tuple[jnp.ndarray, jnp.ndarray]


def cmul(a: Pair, b: Pair) -> Pair:
    ar, ai = a
    br, bi = b
    return ar * br - ai * bi, ar * bi + ai * br


def cabs2(a: Pair):
    ar, ai = a
    return ar * ar + ai * ai


def cdiv(a: Pair, b: Pair) -> Pair:
    ar, ai = a
    br, bi = b
    inv = 1.0 / (br * br + bi * bi)
    return (ar * br + ai * bi) * inv, (ai * br - ar * bi) * inv


def cexp(a: Pair) -> Pair:
    ar, ai = a
    e = jnp.exp(ar)
    return e * jnp.cos(ai), e * jnp.sin(ai)


def clog(a: Pair) -> Pair:
    """Principal branch: log|z| + i·atan2(im, re)."""
    ar, ai = a
    return 0.5 * jnp.log(cabs2(a)), jnp.arctan2(ai, ar)


def csqrt(a: Pair) -> Pair:
    """Principal square root via half-angle (√r·cos(θ/2), √r·sin(θ/2))."""
    r = jnp.sqrt(jnp.sqrt(cabs2(a)))
    theta = 0.5 * jnp.arctan2(a[1], a[0])
    return r * jnp.cos(theta), r * jnp.sin(theta)
