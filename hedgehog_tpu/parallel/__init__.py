"""Multi-chip parallelism: path-sharded MC/LSM over a jax.sharding.Mesh."""

from .sharding import (
    make_paths_mesh,
    sharded_lsm_price,
    sharded_lsm_price_fn,
    sharded_mc_price,
    sharded_mc_price_fn,
    sharded_surface_fn,
)

__all__ = [
    "make_paths_mesh",
    "sharded_mc_price",
    "sharded_mc_price_fn",
    "sharded_lsm_price",
    "sharded_lsm_price_fn",
    "sharded_surface_fn",
]
