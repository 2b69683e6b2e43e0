#!/usr/bin/env python
"""Benchmark headline: Heston exact-mixing Monte Carlo throughput on one GPU.

Prices the bench market's ATM call with the exact-transition mixing
estimator (2 segments, antithetic, f64) through ``jit(hh.solve)`` at 2^24
antithetic pairs per dispatch, checks the price against the Carr-Madan
oracle (evaluated on the device, outside the timed window), and prints ONE
JSON line:

  {"metric": ..., "value": paths_per_sec, "unit": "paths/s", ...}

Diagnostics follow on stderr: the flagship greek-vector cost ratio, a
batched Black-Scholes price+greeks book, the 17×3 Heston surface
calibration and the grid engines, each at the precision ``solve`` serves by
default.  The first stderr line names the card and its power limit.  Needs
a GPU: exits non-zero when JAX finds none.
"""

import datetime as dt
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp

import hedgehog_tpu as hh
from hedgehog_tpu.utils.compile_cache import enable_compilation_cache

EXACT_SEGMENTS = 2  # exact-transition mixing segments (sub-bp scheme bias)
N_PAIRS = 1 << 24  # antithetic pairs per dispatch (2^25 paths)
REPS = 10

REF = dt.date(2024, 1, 1)
EXPIRY = dt.date(2025, 1, 1)  # T = 366/365
R, SPOT, STRIKE = 0.03, 100.0, 100.0
HESTON = dict(V0=0.04, kappa=2.0, theta=0.04, sigma=0.3, rho=-0.7)


def card_line() -> str:
    """``name, power.limit`` of the first GPU, from nvidia-smi."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def require_gpu():
    """The first JAX device; raises SystemExit unless it is a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX's default device is {dev.platform}")
    return dev


def bench_problem():
    market = hh.HestonInputs(REF, R, SPOT, *HESTON.values())
    payoff = hh.VanillaOption(STRIKE, EXPIRY, hh.European(), hh.Call(), hh.Spot())
    return hh.PricingProblem(payoff, market)


def flagship_greek_ratio(n_pairs: int = 2**19, steps: int = 10,
                         conditional: bool = False, exact: bool = False):
    """time(full 7-param gradient) / time(price) for the Heston pure-JAX
    Monte Carlo price (greeks_agreement.jl:170-241 semantics: fixed RNG,
    pathwise derivative).  ``conditional=True`` measures the mixing
    estimator's forward-mode greeks; ``exact=True`` the exact-transition
    flagship via the mixed pathwise/likelihood-ratio estimator
    (heston_exact_price_and_greeks).  Returns (ratio, t_price, t_grad)."""
    cfg = hh.SimulationConfig(
        trajectories=n_pairs, steps=steps, variance_reduction=hh.Antithetic(), seed=0
    )
    strat = hh.HestonExactMixing() if exact else hh.HestonQE(conditional=conditional)
    method = hh.MonteCarlo(hh.HestonDynamics(), strat, cfg)
    payoff = bench_problem().payoff

    def problem(params):
        spot, v0, kappa, theta, sigma, rho, r = params
        return hh.PricingProblem(payoff, hh.HestonInputs(REF, r, spot, v0, kappa, theta, sigma, rho))

    def price(params):
        return hh.solve(problem(params), method).price

    params = tuple(
        jnp.float64(x)
        for x in (SPOT, HESTON["V0"], HESTON["kappa"], HESTON["theta"],
                  HESTON["sigma"], HESTON["rho"], R)
    )
    if exact or conditional:
        from hedgehog_tpu.methods.mixing_greeks import (
            GREEK_ORDER,
            heston_exact_price_and_greeks,
            heston_mixing_price_and_greeks,
        )

        greeks_fn = heston_exact_price_and_greeks if exact else heston_mixing_price_and_greeks

        def value_and_greeks(params):
            p, g = greeks_fn(problem(params), method)
            return p, jnp.stack([g[k] for k in GREEK_ORDER])

        grad_jit = jax.jit(value_and_greeks)
    else:
        grad_jit = jax.jit(jax.value_and_grad(price))
    price_jit = jax.jit(price)
    jax.block_until_ready(price_jit(params))  # compile
    jax.block_until_ready(grad_jit(params))

    def best_of(fn, reps=8):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(reps):
                out = fn(params)
            jax.block_until_ready(out)
            times.append((time.perf_counter() - t0) / reps)
        return min(times)

    t_price = best_of(price_jit)
    t_grad = best_of(grad_jit)
    return t_grad / t_price, t_price, t_grad


def batched_bs_price_greeks(n_opts: int = 2**18):
    """One jitted vmap of value_and_grad over ``n_opts`` strikes: Black-Scholes
    price plus (delta, vega, rho) per option.  Returns (strikes, spot,
    sigma, r, T, fn) with fn(spot, sigma, r) -> (prices, (delta, vega, rho))."""
    from hedgehog_tpu.methods.black_scholes import bs_price

    T = float(hh.yearfrac(REF, EXPIRY))
    strikes = jnp.linspace(50.0, 150.0, n_opts)

    def one_price(K, spot, sigma, r):
        D = jnp.exp(-r * T)
        return bs_price(spot / D, K, sigma, T, D, 1.0)

    @jax.jit
    def priced_greeked(spot, sigma, r):
        f = lambda K: jax.value_and_grad(one_price, argnums=(1, 2, 3))(K, spot, sigma, r)
        return jax.vmap(f)(strikes)

    return strikes, SPOT, 0.2, R, T, priced_greeked


def calibrate_heston_surface():
    """The reference's 17-strike × 3-expiry Heston surface calibration
    (test/unit/calibration.jl:53-95) through the differentiable Carr-Madan
    pricer with bounded L-BFGS.  Timed post-compile (a second solve).
    Returns dict(wall_s, iterations, rmse, converged)."""
    import numpy as np

    true = dict(V0=0.010201, kappa=6.21, theta=0.019, sigma=0.61, rho=-0.7)
    r, S0 = 0.0319, 100.0
    market = hh.HestonInputs(REF, r, S0, *true.values())
    strikes = np.arange(60.0, 141.0, 5.0)  # 17 strikes
    expiries = [REF + dt.timedelta(days=d) for d in (90, 180, 365)]
    payoffs = [
        hh.VanillaOption(float(K), e, hh.European(), hh.Call(), hh.Spot())
        for e in expiries
        for K in strikes
    ]
    method = hh.CarrMadan(1.0, 32.0, hh.HestonDynamics())
    basket = hh.solve(hh.BasketPricingProblem(payoffs, market), method)
    quotes = jnp.stack([s.price for s in basket.solutions])
    lenses = tuple(
        hh.FieldLens(f"market_inputs.{n}") for n in ("V0", "kappa", "theta", "sigma", "rho")
    )
    lb = jnp.asarray([1e-5, 1e-3, 1e-5, 1e-3, -0.99])
    ub = jnp.asarray([1.0, 20.0, 1.0, 5.0, 0.99])
    guess = [0.02, 3.0, 0.03, 0.4, -0.3]

    def calibrate():
        calib = hh.CalibrationProblem(
            hh.BasketPricingProblem(payoffs, hh.HestonInputs(REF, r, S0, *guess)),
            quotes, jnp.asarray(guess), method, lenses,
        )
        return hh.solve(calib, hh.OptimizerAlgo(max_iters=300), lb=lb, ub=ub)

    jax.block_until_ready(calibrate().u)  # compile + converge once
    t0 = time.perf_counter()
    res = calibrate()
    jax.block_until_ready(res.u)
    wall = time.perf_counter() - t0
    fitted = hh.HestonInputs(REF, r, S0, *[float(v) for v in res.u])
    fit = hh.solve(hh.BasketPricingProblem(payoffs, fitted), method)
    fit_prices = jnp.stack([s.price for s in fit.solutions])
    rmse = float(jnp.sqrt(jnp.mean((fit_prices - quotes) ** 2)))
    return dict(wall_s=wall, iterations=int(res.iterations), rmse=rmse,
                converged=bool(res.converged))


def grid_engines(h_market):
    """(name, engine, market, payoff_of_strike, n_options) for the book
    sizes the grid engines serve."""
    bs_mkt = hh.BlackScholesInputs(REF, R, SPOT, 0.2)

    def am_put(k):
        return hh.VanillaOption(k, EXPIRY, hh.American(), hh.Put(), hh.Spot())

    def eur_call(k):
        return hh.VanillaOption(k, EXPIRY, hh.European(), hh.Call(), hh.Spot())

    return [
        ("PDE-1D 256x128 BS American put",
         hh.PDEMethod(space_steps=256, time_steps=128), bs_mkt, am_put, 256),
        ("CRR-1024 BS American put",
         hh.CoxRossRubinsteinMethod(1024), bs_mkt, am_put, 256),
        ("Carr-Madan Heston European call",
         hh.CarrMadan(1.0, 32.0, hh.HestonDynamics()), h_market, eur_call, 256),
        ("ADI-2D 128x48x64 Heston American put",
         hh.PDEMethod(hh.HestonDynamics(), space_steps=128, time_steps=64,
                      var_steps=48), h_market, am_put, 8),
    ]


def book_fn(engine, market, mk_payoff):
    """jit(vmap) of the price over a strike book: fn(strikes) -> prices."""
    def one(k):
        return hh.solve(hh.PricingProblem(mk_payoff(k), market), engine).price

    return jax.jit(jax.vmap(one))


def time_book(engine, market, mk_payoff, strikes, reps: int = 3):
    """Price a strike book in one jit(vmap) dispatch; returns (prices,
    compile_s, seconds per book)."""
    fn = book_fn(engine, market, mk_payoff)
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(strikes))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(strikes)
    jax.block_until_ready(out)
    return out, compile_s, (time.perf_counter() - t0) / reps


def main() -> None:
    enable_compilation_cache()
    dev = require_gpu()
    sys.stderr.write(f"# card: {card_line()}\n")
    sys.stderr.flush()
    prob = bench_problem()
    cm_price = float(hh.solve(prob, hh.CarrMadan(1.0, 32.0, hh.HestonDynamics())).price)

    cfg = hh.SimulationConfig(trajectories=N_PAIRS, steps=EXACT_SEGMENTS,
                              variance_reduction=hh.Antithetic(), seed=0)
    method = hh.MonteCarlo(hh.HestonDynamics(), hh.HestonExactMixing(), cfg)
    price_fn = jax.jit(lambda p: hh.solve(p, method).price)
    jax.block_until_ready(price_fn(prob))  # compile
    t0 = time.perf_counter()
    prices = [price_fn(prob) for _ in range(REPS)]
    jax.block_until_ready(prices)
    elapsed = time.perf_counter() - t0
    paths_per_sec = 2 * N_PAIRS * REPS / elapsed
    mc_price = float(prices[-1])
    err_bp = abs(mc_price - cm_price) / cm_price * 1e4
    sys.stderr.write(
        f"# exact_mixing{EXACT_SEGMENTS} solve f64: pairs/dispatch={N_PAIRS} reps={REPS} "
        f"elapsed={elapsed:.3f}s mc={mc_price:.5f} cm={cm_price:.5f} err={err_bp:.2f}bp\n"
    )
    print(json.dumps({
        "metric": f"heston_exact_mixing{EXACT_SEGMENTS}_mc_paths_per_sec_err{err_bp:.1f}bp",
        "value": paths_per_sec,
        "unit": "paths/s",
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "count": len(jax.devices()),
    }), flush=True)

    ratio, t_price, t_grad = flagship_greek_ratio(steps=EXACT_SEGMENTS, exact=True)
    sys.stderr.write(
        f"# greek vector, exact-transition flagship (2^19 pairs, pathwise + "
        f"likelihood-ratio): price={t_price*1e3:.2f}ms grad={t_grad*1e3:.2f}ms "
        f"ratio={ratio:.2f}\n"
    )

    strikes, spot, sigma, r, _, priced_greeked = batched_bs_price_greeks()
    jax.block_until_ready(priced_greeked(spot, sigma, r))
    t0 = time.perf_counter()
    for _ in range(5):
        out = priced_greeked(spot, sigma, r)
    jax.block_until_ready(out)
    sys.stderr.write(
        f"# batched BS price+greeks (delta/vega/rho, f64): "
        f"{5 * strikes.shape[0] / (time.perf_counter() - t0):.3e} options/s\n"
    )

    cal = calibrate_heston_surface()
    sys.stderr.write(
        f"# Heston surface calibration (17x3, Carr-Madan + bounded LBFGS): "
        f"{cal['wall_s']*1e3:.0f} ms, {cal['iterations']} iters, "
        f"RMSE={cal['rmse']:.2e}, converged={cal['converged']}\n"
    )

    for name, engine, mkt, mk_payoff, n_opts in grid_engines(prob.market_inputs):
        _, _, sec = time_book(engine, mkt, mk_payoff, jnp.linspace(60.0, 140.0, n_opts))
        sys.stderr.write(
            f"# grid engine {name}: {n_opts} options in {sec*1e3:.1f} ms "
            f"= {n_opts/sec:.2e} options/s (f64)\n"
        )


if __name__ == "__main__":
    main()
