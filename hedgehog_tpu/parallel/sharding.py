"""Multi-chip scaling: path-sharded Monte Carlo over a jax.sharding.Mesh.

The distributed story of the framework (SURVEY §2c): this domain is
embarrassingly parallel across *paths* and *instruments*.  We shard the path
axis with ``shard_map``; per-device RNG streams are derived by
folding the device index into the base key (zero communication for sampling),
and the only collective is the ``psum`` of payoff sums — exactly the
"path sharding + RNG stream discipline + psum reduction" recipe.  The LSM
regression's (degree+1)² normal equations are the second (tiny) psum.

Everything here is differentiable: ``jax.grad`` through ``shard_map``/psum
gives sharded pathwise Greeks and calibration gradients.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..core.problems import PricingProblem
from ..market.rate_curve import df
from ..methods.montecarlo import MonteCarlo, mc_path_values

__all__ = [
    "make_paths_mesh",
    "sharded_mc_price",
    "sharded_mc_price_fn",
    "sharded_lsm_price",
    "sharded_lsm_price_fn",
    "sharded_surface_fn",
]


def make_paths_mesh(devices=None, axis_name: str = "paths") -> Mesh:
    """1-D mesh over all (or the given) devices with a ``paths`` axis."""
    import numpy as np

    devices = jax.devices() if devices is None else devices
    return Mesh(np.asarray(devices), (axis_name,))


def _local_method(method: MonteCarlo, n_dev: int) -> MonteCarlo:
    cfg = method.config
    if cfg.trajectories % n_dev != 0:
        raise ValueError(
            f"trajectories ({cfg.trajectories}) must divide evenly over {n_dev} devices"
        )
    if cfg.qmc and cfg.trajectories > 2**30:
        # the in-device guard in math/sobol.py cannot fire on traced offsets,
        # so the global period check lives here where sizes are Python ints
        raise ValueError(
            f"Sobol' sequence period is 2^30 points; total trajectories "
            f"({cfg.trajectories}) would wrap and duplicate points"
        )
    local_cfg = dataclasses.replace(cfg, trajectories=cfg.trajectories // n_dev)
    return dataclasses.replace(method, config=local_cfg)


def _device_key_and_offset(cfg, idx, axis_name_unused=None):
    """Per-device RNG coordinates.

    PRNG: fold the device index into the key (independent streams).
    QMC: every device must share ONE key (one randomized Sobol' sequence) and
    instead take a disjoint point-offset slice — re-keying per device would
    replicate the first N/D points.
    """
    if cfg.qmc:
        return jax.random.PRNGKey(cfg.seed), idx * cfg.trajectories
    return jax.random.fold_in(jax.random.PRNGKey(cfg.seed), idx), idx * cfg.trajectories


def sharded_mc_price_fn(method: MonteCarlo, mesh: Mesh, axis_name: str = "paths"):
    """Build ``price(prob) -> scalar`` with the path axis sharded over ``mesh``.

    The returned function is jit-able and differentiable w.r.t. any traced
    leaf of ``prob`` (spot, Heston params, curve pillars, …): the reduction
    is a psum whose transpose XLA handles natively.
    """
    n_dev = mesh.shape[axis_name]
    local = _local_method(method, n_dev)
    total_paths = method.config.trajectories

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(),),  # problem replicated; path axis is implicit in RNG
        out_specs=P(),
        check_vma=False,
    )
    def price(prob: PricingProblem):
        idx = jax.lax.axis_index(axis_name)
        key, offset = _device_key_and_offset(local.config, idx)
        # per-path values (terminal payoffs OR conditional-MC vanilla values);
        # sum over the path axis only so array-strike grids keep their axis
        values = mc_path_values(prob, local, key=key, point_offset=offset)
        local_sum = jnp.sum(values, axis=-1)
        total = jax.lax.psum(local_sum, axis_name)
        discount = df(prob.market_inputs.rate, prob.payoff.expiry)
        return discount * total / total_paths

    return price


def sharded_mc_price(prob: PricingProblem, method: MonteCarlo, mesh: Optional[Mesh] = None):
    """Price a European option with paths sharded across all devices."""
    mesh = mesh or make_paths_mesh()
    return sharded_mc_price_fn(method, mesh)(prob)


def sharded_surface_fn(method: MonteCarlo, mesh: Mesh, axis_name: str = "paths"):
    """Build ``surface(market, expiries, strikes) -> (n_exp, m)`` with the
    path axis of :func:`hedgehog_tpu.heston_surface_mc` sharded over ``mesh``.

    Same RNG/QMC stream discipline as the sharded vanilla pricer: PRNG runs
    fold the device index into the key; QMC runs slice ONE Sobol' sequence
    disjointly, so sharded == unsharded to summation order.  The whole
    surface reduces with a single psum (the per-device partial surfaces are
    already means over local paths — psum-average them)."""
    from ..methods.montecarlo import heston_surface_mc

    n_dev = mesh.shape[axis_name]
    local = _local_method(method, n_dev)

    def surface(market, expiries, strikes):
        @partial(shard_map, mesh=mesh, in_specs=(P(),), out_specs=P(), check_vma=False)
        def _run(strikes_arr):
            idx = jax.lax.axis_index(axis_name)
            key, offset = _device_key_and_offset(local.config, idx)
            local_surf = heston_surface_mc(
                market, expiries, strikes_arr, local.config,
                key=key, point_offset=offset, strategy=local.strategy,
            )
            return jax.lax.pmean(local_surf, axis_name)

        return _run(jnp.asarray(strikes))

    return surface


def sharded_lsm_price_fn(method, mesh: Mesh, axis_name: str = "paths"):
    """Build a path-sharded LSM American pricer over ``mesh``.

    The price grid is simulated device-locally (independent RNG streams); the
    per-step continuation regression runs GLOBALLY via two psum'ed
    (degree+1)² normal-equation reductions — the framework's one genuinely
    communicating algorithm (SURVEY §5), the closest analog of sequence
    parallelism this domain has.
    """
    from ..methods.lsm import (
        LSM,
        _flatten_grid,
        _is_conditional,
        _lsm_setup,
        lsm_backward_induction,
        rb_terminal_value,
    )
    from ..methods.montecarlo import simulate_conditional_grid, simulate_price_grid

    assert isinstance(method, LSM)
    n_dev = mesh.shape[axis_name]
    local_mc = _local_method(method.mc_method, n_dev)
    total_paths_factor = n_dev
    conditional = _is_conditional(method.mc_method)

    def price(prob: PricingProblem):
        from ..core.payoffs import BarrierOption

        if isinstance(prob.payoff, BarrierOption):
            # the sharded induction below carries no survival state, so a
            # knock-out would silently price as the plain American vanilla
            # (BarrierOption.__call__ is the UNCONDITIONAL intrinsic)
            raise TypeError(
                "sharded LSM does not carry the barrier survival state; "
                "price American knock-outs through solve(problem, LSM(...)) "
                "on a single device"
            )
        log_disc, strike_scale = _lsm_setup(prob, method)
        from ..methods.lsm import _exercise_mask

        ex_mask = _exercise_mask(prob, method)  # Bermudan gate (None = American)

        @partial(shard_map, mesh=mesh, in_specs=(P(),), out_specs=P(), check_vma=False)
        def inner(prob):
            idx = jax.lax.axis_index(axis_name)
            key, offset = _device_key_and_offset(local_mc.config, idx)
            if conditional:
                s_grid, v_grid = simulate_conditional_grid(
                    prob, local_mc.config, key=key, point_offset=offset
                )
                spots, vols = _flatten_grid(s_grid), _flatten_grid(v_grid)
                terminal = (
                    rb_terminal_value(prob, spots, vols)
                    if method.rao_blackwell else None
                )
            else:
                grid = simulate_price_grid(
                    prob, local_mc, key=key, point_offset=offset
                )  # (g, steps+1, P_local)
                spots, vols, terminal = _flatten_grid(grid), None, None
            tau, value = lsm_backward_induction(
                spots, prob.payoff, log_disc, method.degree, strike_scale,
                psum_axis=axis_name, vols=vols, terminal_value=terminal,
                exercise_mask=ex_mask,
            )
            local_sum = jnp.sum(jnp.exp(tau * log_disc) * value)
            total = jax.lax.psum(local_sum, axis_name)
            return total / (spots.shape[1] * total_paths_factor)

        return inner(prob)

    return price


def sharded_lsm_price(prob: PricingProblem, method, mesh: Optional[Mesh] = None):
    """Price an American option via LSM with paths sharded across devices."""
    mesh = mesh or make_paths_mesh()
    return sharded_lsm_price_fn(method, mesh)(prob)
