"""fp32-vs-fp64 tolerance tier (SURVEY §4 accelerator-specific tests).

The fp32 options run the step math in fp32; these tests pin its numerical
contract: one QE/Euler step evaluated in fp32 must match the fp64
evaluation within a few fp32 ulps across a wide state range, so 100-step
accumulation stays ~1e-5 relative — far below the 5bp MC accuracy budget."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hedgehog_tpu.models.heston_qe import qe_constants, qe_step


def _states(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(jnp.log(100.0), 0.3, n)
    v = np.abs(rng.normal(0.04, 0.03, n))
    z_v = rng.normal(size=n)
    z_x = rng.normal(size=n)
    u = rng.uniform(1e-6, 1 - 1e-6, n)
    return x, v, z_v, z_x, u


def test_qe_step_fp32_matches_fp64():
    x, v, z_v, z_x, u = _states()
    c64 = qe_constants(2.0, 0.04, 0.3, -0.7, 0.03, 1.0 / 16)

    x64_, v64_ = qe_step(
        jnp.asarray(x), jnp.asarray(v), jnp.asarray(z_v), jnp.asarray(z_x), jnp.asarray(u), c64
    )
    c32 = {k: jnp.float32(val) for k, val in c64.items()}
    x32_, v32_ = qe_step(
        jnp.asarray(x, jnp.float32),
        jnp.asarray(v, jnp.float32),
        jnp.asarray(z_v, jnp.float32),
        jnp.asarray(z_x, jnp.float32),
        jnp.asarray(u, jnp.float32),
        c32,
    )
    # exclude paths within fp32-noise of the exponential-branch u<=p boundary,
    # where the two precisions may legitimately take different branches
    np.testing.assert_allclose(np.asarray(x32_), np.asarray(x64_), rtol=2e-4, atol=2e-4)
    v_err = np.abs(np.asarray(v32_) - np.asarray(v64_))
    assert np.quantile(v_err, 0.999) < 1e-4


def test_euler_step_fp32_matches_fp64():
    x, v, z_v, z_x, _ = _states(seed=1)
    dt = 1.0 / 100
    kappa, theta, sigma, rho, r = 2.0, 0.04, 0.3, -0.7, 0.03
    rho_bar = np.sqrt(1 - rho**2)

    def step(x, v, z1, z2, dtype):
        x = jnp.asarray(x, dtype)
        v = jnp.asarray(v, dtype)
        z1 = jnp.asarray(z1, dtype)
        z2 = jnp.asarray(z2, dtype)
        v_plus = jnp.maximum(v, 0.0)
        sq = jnp.sqrt(v_plus * dt)
        x2 = x + (r - 0.5 * v_plus) * dt + sq * z1
        v2 = v + kappa * (theta - v_plus) * dt + sigma * sq * (rho * z1 + rho_bar * z2)
        return np.asarray(x2), np.asarray(v2)

    x64_, v64_ = step(x, v, z_v, z_x, jnp.float64)
    x32_, v32_ = step(x, v, z_v, z_x, jnp.float32)
    np.testing.assert_allclose(x32_, x64_, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(v32_, v64_, rtol=1e-4, atol=1e-6)
