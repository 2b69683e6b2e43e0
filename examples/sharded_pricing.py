"""Multi-device path-sharded Monte Carlo (one program over several GPUs).

Run on CPU with virtual devices to see the mechanics:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python examples/sharded_pricing.py
"""

import datetime as dt
import time

import jax

import hedgehog_tpu as hh
from hedgehog_tpu.parallel.sharding import make_paths_mesh, sharded_mc_price_fn

REF = dt.date(2024, 1, 1)
EXPIRY = dt.date(2025, 1, 1)


def main():
    print(f"devices: {jax.devices()}")
    mesh = make_paths_mesh()
    n_dev = len(jax.devices())

    market = hh.HestonInputs(REF, 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
    opt = hh.VanillaOption(100.0, EXPIRY, hh.European(), hh.Call(), hh.Spot())
    prob = hh.PricingProblem(opt, market)

    cfg = hh.SimulationConfig(
        trajectories=n_dev * 50_000, steps=64, seed=0, variance_reduction=hh.Antithetic()
    )
    method = hh.MonteCarlo(hh.HestonDynamics(), hh.EulerMaruyama(), cfg)
    price_fn = jax.jit(sharded_mc_price_fn(method, mesh))

    price = float(price_fn(prob))  # compile + run
    t0 = time.time()
    price = float(price_fn(prob))
    elapsed = time.time() - t0
    total = 2 * cfg.trajectories * cfg.steps
    cm = float(hh.solve(prob, hh.CarrMadan(1.0, 32.0, hh.HestonDynamics())).price)
    print(
        f"sharded MC over {n_dev} devices: price={price:.4f} (CM {cm:.4f}, "
        f"rel {abs(price-cm)/cm:.2%}) | {elapsed*1e3:.0f} ms, "
        f"{2*cfg.trajectories/elapsed/1e6:.1f} Mpaths/s aggregate"
    )

    # sharded greeks: grad flows through the psum
    delta = jax.grad(lambda s: price_fn(hh.SpotLens().set(prob, s)))(100.0)
    print(f"sharded pathwise delta: {float(delta):.4f}")


if __name__ == "__main__":
    main()
