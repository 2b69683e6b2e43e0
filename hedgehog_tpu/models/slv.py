"""Stochastic-local-volatility (SLV) — beyond-reference model family.

The production equity/FX smile model the reference's roadmap never reaches
(its surface machinery, src/market_inputs/vol_surface.jl, stops at implied
vols; docs/src/derivatives_pricing_roadmap.md lists local vol as future
work).  SLV marries Heston variance with a state-dependent leverage so the
model reprices the whole vanilla surface EXACTLY (in the particle limit)
while keeping stochastic forward smiles:

    dS/S = (r − q) dt + L(t, S) · √V dW₁
    dV   = κ(θ − V) dt + m·σ_v · √V dW₂,      corr(dW₁, dW₂) = ρ

Gyöngy/Dupire matching fixes the leverage:  L²(t, S) = σ_loc²(t, S) /
E[V_t | S_t = S], with σ_loc the Dupire local vol of the market implied
surface (models/local_vol.py).  ``m`` is the mixing fraction (how much of
the smile dynamics is stochastic): m = 0 collapses to pure local vol,
m = 1 is full Heston vol-of-vol; vanillas are repriced at EVERY m.

The calibration (`calibrate_leverage`) is the Guyon & Henry-Labordère
particle method re-designed around matmuls: ONE `lax.scan`
over time steps carries the particle cloud (logS, V); each step estimates
E[V | S] on a fixed log-spot grid by a Nadaraya-Watson Gaussian-kernel
regression — two (bins × paths) matmuls, i.e. the per-step interaction is
a pair of dense contractions instead of sorted binning — then
advances the particles with the freshly fixed leverage row.  Everything is
fixed-shape, jit-able, and differentiable end to end (the calibrated
leverage is itself a smooth function of spot/rate/Heston params, so
`jax.grad` through calibrate→price gives model-consistent greeks).

No closed-form characteristic function exists for SLV (leverage breaks
affinity), so `CarrMadan` rejects it; pricing runs through
``MonteCarlo(SLVDynamics(), EulerMaruyama(), cfg)`` and composes with every
grid consumer (Asians, bridge barriers, lookbacks, LSM American).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from ..market.inputs import BlackScholesInputs, carry_yield, market_yearfrac
from ..market.rate_curve import df_yf
from .dynamics import cir_family_euler_update
from ..utils.pytree import pytree, static_field

__all__ = ["LeverageSurface", "leverage_at", "calibrate_leverage"]

#: conditional-variance floor: E[V|S] below this (possible in far wings
#: where the kernel weights vanish) is floored, not allowed to blow L up
_EV_FLOOR = 1e-6
#: leverage cap — far-wing Dupire vols over near-zero E[V|S] are clipped so
#: one bad grid node cannot destabilise the whole particle cloud
_L_MAX = 25.0


@pytree
class LeverageSurface:
    """Calibrated leverage table L(t_k, x_j) on (time-step left endpoints ×
    log-spot nodes).  Piecewise-constant in t over the calibration segments
    (exactly how the calibration itself used it), linear in log-spot with
    clamped extrapolation."""

    t_grid: Any  # (n_steps,) left endpoints t_0=0 .. t_{n-1}
    x_grid: Any  # (n_bins,) log-spot nodes
    values: Any  # (n_steps, n_bins)


def leverage_at(lev: LeverageSurface, t, x):
    """L(t, x) for scalar time ``t`` and a log-spot array ``x`` —
    zero-order hold in t (the calibration's own convention), linear and
    clamped in x."""
    k = jnp.clip(
        jnp.searchsorted(lev.t_grid, t, side="right") - 1, 0, lev.t_grid.shape[0] - 1
    )
    row = jax.lax.dynamic_index_in_dim(lev.values, k, axis=0, keepdims=False)
    return jnp.interp(x, lev.x_grid, row)


def _conditional_variance(x, v, x_grid, bandwidth, shrink=1e-2):
    """Nadaraya-Watson E[V | logS = x_grid] from the particle cloud —
    two (bins × paths) contractions.  A ``shrink``-weighted prior at
    the cloud mean regularizes wing nodes the cloud barely visits (a node
    carrying less than ~``shrink`` particles' worth of kernel mass reads
    as the unconditional mean instead of one far particle's V — keeps the
    leverage wings bounded and the estimate smooth/differentiable)."""
    w = jnp.exp(-0.5 * ((x_grid[:, None] - x[None, :]) / bandwidth) ** 2)
    den = jnp.sum(w, axis=1)
    num = w @ v
    v_bar = jnp.mean(v)
    return (num + shrink * v_bar) / (den + shrink)


def calibrate_leverage(
    market,
    horizon,
    *,
    steps: int = 64,
    paths: int = 32768,
    bins: int = 65,
    seed: int = 0,
    bandwidth_mult: float = 1.5,
    width_sigmas: float = 5.0,
):
    """Particle-method leverage calibration (Guyon & Henry-Labordère 2012)
    for an :class:`~hedgehog_tpu.market.inputs.SLVInputs` market: returns a
    :class:`LeverageSurface` over [0, T(horizon)] such that the SLV model
    reprices the market's vanilla surface.

    One jit-able `lax.scan`: at each step k the particle cloud (logS, V)
    yields E[V | S] on a fixed log-spot grid (Gaussian-kernel regression,
    bandwidth = ``bandwidth_mult``·std(x)·paths^(−1/5) — Silverman rate),
    the leverage row L_k = σ_Dupire(t_k, ·)/√E[V|·] is fixed, and the cloud
    advances one full-truncation Euler step under it.  At k = 0 the
    conditional variance is exactly V0 (no regression noise).

    Differentiable end to end — spot/rate/surface/Heston-parameter
    gradients flow through the calibration into any SLV price."""
    from .local_vol import dupire_local_vol

    T = market_yearfrac(market, horizon)
    bs_market = BlackScholesInputs(
        market.reference_date,
        market.rate,
        market.spot,
        market.sigma_surface,
        dividend_yield=carry_yield(market),
        daycount=market.daycount,
    )
    dt = T / steps
    sqrt_dt = jnp.sqrt(dt)
    q = carry_yield(market)
    t_left = jnp.arange(steps) * dt
    d_grid = df_yf(market.rate, jnp.arange(steps + 1) * dt)
    fwd = jnp.log(d_grid[:-1] / d_grid[1:]) / dt - q

    # log-spot grid: centred on the horizon forward, wide enough for the
    # terminal cloud under the ATM vol
    x0 = jnp.log(market.spot)
    sig_atm = _atm_vol(bs_market, T)
    drift_T = jnp.log(d_grid[0] / d_grid[-1]) - q * T
    half_width = width_sigmas * sig_atm * jnp.sqrt(T)
    x_grid = x0 + drift_T / 2 + jnp.linspace(-half_width, half_width, bins)

    sig_v = market.mixing * market.sigma
    kappa, theta, rho, v0 = market.kappa, market.theta, market.rho, market.V0
    rho_bar = jnp.sqrt(1.0 - rho**2)

    sig_loc_grid = jax.vmap(
        jax.vmap(dupire_local_vol, in_axes=(None, None, 0)), in_axes=(None, 0, None)
    )(bs_market, t_left, jnp.exp(x_grid))  # (steps, bins)

    key = jax.random.PRNGKey(seed)
    z = jax.random.normal(key, (steps, 2, paths), dtype=jnp.float64)
    h_rate = bandwidth_mult * float(paths) ** (-0.2)

    xp0 = jnp.full((paths,), x0)
    vp0 = jnp.full((paths,), v0)

    def step(carry, inp):
        x, v, first = carry
        zk, fk, sig_loc_row = inp
        v_plus = jnp.maximum(v, 0.0)
        # E[V|S]: exact at t=0 (degenerate cloud), kernel regression after
        bandwidth = jnp.maximum(h_rate * jnp.std(x), 1e-4)
        ev = jnp.where(
            first,
            jnp.full(x_grid.shape, v0),
            _conditional_variance(x, v_plus, x_grid, bandwidth),
        )
        l_row = jnp.clip(
            sig_loc_row / jnp.sqrt(jnp.maximum(ev, _EV_FLOOR)), 0.0, _L_MAX
        )
        # advance the cloud under the just-fixed leverage row — the SAME
        # update the pricing stepper uses (models/dynamics.py), so the
        # calibrated and simulated models cannot drift apart
        x_new, v_new = cir_family_euler_update(
            x, v, zk[0], zk[1], lev_x=jnp.interp(x, x_grid, l_row), fk=fk,
            kappa=kappa, theta=theta, sig_v=sig_v, rho=rho, rho_bar=rho_bar,
            dt=dt, sqrt_dt=sqrt_dt,
        )
        return (x_new, v_new, jnp.zeros_like(first)), l_row

    (_, _, _), rows = jax.lax.scan(
        step, (xp0, vp0, jnp.asarray(True)), (z, fwd, sig_loc_grid)
    )
    return LeverageSurface(t_grid=t_left, x_grid=x_grid, values=rows)


def _atm_vol(bs_market, T):
    from ..market.vol_surface import get_vol_yf

    fwd = bs_market.spot * jnp.exp(-carry_yield(bs_market) * T) / df_yf(
        bs_market.rate, T
    )
    return get_vol_yf(bs_market.sigma, T, fwd)
