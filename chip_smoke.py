#!/usr/bin/env python
"""End-to-end smoke run of hedgehog_tpu on one NVIDIA GPU.

    python chip_smoke.py                # one card: phases a-c
    python chip_smoke.py --four-cards   # four cards: the path-sharded phases

Phases (one card), each printing one JSON line that names the device:

a. the flagship price through ``hh.solve``: exact-transition mixing, 2
   segments, antithetic, 2^24 pairs (pure-JAX f64), against Carr-Madan on
   the device (|mc − cm| ≤ 4·stderr + 0.5 bp);
b. the flagship 7-greek vector (``heston_exact_price_and_greeks``, 2^20
   pairs): finite, delta and vega within 2% of ``jax.grad`` of Carr-Madan;
c. the rest of the library through ``solve`` at book sizes: batched
   Black-Scholes price+greeks, CRR and PDE American puts, a Carr-Madan
   strike grid (both engines, timed in turns), ADI-2D, Heston LSM,
   Broadie-Kaya and the 17×3 Heston surface calibration, each with its
   check.

Timings are medians of turns, each ending in ``block_until_ready``.

``--four-cards`` runs only the sharded path and what it is compared with:
``__graft_entry__._dryrun_multichip_impl(4)`` (phases 1-4, each replayed on
one device) and ``sharded_mc_price`` of phase (a)'s problem against the
one-card solve, the two timed in turns.

Any failed check raises, so the script exits non-zero without its final
line.  The last line of stdout is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Without a GPU it exits non-zero before any phase.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import time

import jax
import jax.numpy as jnp
import numpy as np

import bench
import hedgehog_tpu as hh
from hedgehog_tpu.utils.compile_cache import enable_compilation_cache

SEGMENTS = 2
FLAGSHIP_PAIRS = 1 << 24
GREEK_PAIRS = 1 << 20
TIMING_REPS = 10  # timed turns per candidate; the median is reported
BS_BOOK = 1 << 18
GRID_BOOK = 256
ADI_STRIKES = (80.0, 85.0, 90.0, 95.0, 100.0, 105.0, 110.0, 120.0)
LSM_PATHS, LSM_STEPS = 1 << 18, 50
BK_PATHS = 1 << 14
BIAS_BP = 0.5  # covers the 2-segment scheme's documented −0.33 bp bias


def emit(phase: str, **fields) -> None:
    dev = jax.devices()[0]
    print(json.dumps({"phase": phase, "platform": dev.platform,
                      "device_kind": dev.device_kind, "count": len(jax.devices()),
                      **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def peak_bytes(device) -> int:
    return device.memory_stats()["peak_bytes_in_use"]


def timed(fn, *args):
    """(result, seconds) of one call that ends in block_until_ready."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def in_turns(cands, *args):
    """Time each warm candidate TIMING_REPS times, one turn of every
    candidate after another; returns ({name: median s}, {name: [s, ...]})."""
    times = {name: [] for name in cands}
    for _ in range(TIMING_REPS):
        for name, fn in cands.items():
            times[name].append(timed(fn, *args)[1])
    return {name: statistics.median(t) for name, t in times.items()}, times


def flagship_method(n_pairs: int):
    cfg = hh.SimulationConfig(trajectories=n_pairs, steps=SEGMENTS,
                              variance_reduction=hh.Antithetic(), seed=0)
    return hh.MonteCarlo(hh.HestonDynamics(), hh.HestonExactMixing(), cfg)


def solve_stats_fn(method):
    """jit(prob -> (price, stderr)) through hh.solve; stderr from the
    spread of the discounted antithetic pair means."""
    def stats(prob):
        sol = hh.solve(prob, method)
        pair = jnp.mean(sol.ensemble, axis=0)
        disc = sol.price / jnp.mean(pair)
        return sol.price, disc * jnp.std(pair, ddof=1) / math.sqrt(pair.shape[-1])

    return jax.jit(stats)


def carr_madan_price(prob):
    return float(hh.solve(prob, hh.CarrMadan(1.0, 32.0, hh.HestonDynamics())).price)


def phase_a(prob, cm):
    fn = solve_stats_fn(flagship_method(FLAGSHIP_PAIRS))
    t0 = time.perf_counter()
    compiled = fn.lower(prob).compile()
    compile_s = time.perf_counter() - t0
    price, se = (float(x) for x in timed(compiled, prob)[0])
    med, _ = in_turns({"solve": compiled}, prob)
    tol = 4.0 * se + BIAS_BP * 1e-4 * cm
    emit("a_flagship_solve", pairs=FLAGSHIP_PAIRS, segments=SEGMENTS, precision="f64",
         price=price, stderr=se, carr_madan=cm, diff_bp=(price - cm) / cm * 1e4,
         tol=tol, warm_solve_s=med["solve"], compile_s=compile_s,
         peak_bytes_in_use=peak_bytes(jax.devices()[0]))
    check(abs(price - cm) <= tol, f"flagship price {price} vs Carr-Madan {cm} (tol {tol})")


def phase_b(prob):
    from hedgehog_tpu.methods.mixing_greeks import GREEK_ORDER, heston_exact_price_and_greeks

    method = flagship_method(GREEK_PAIRS)
    price_fn = jax.jit(lambda p: hh.solve(p, method).price)
    greeks_fn = jax.jit(lambda p: heston_exact_price_and_greeks(p, method))
    cm_method = hh.CarrMadan(1.0, 32.0, hh.HestonDynamics())
    cm_grad = jax.jit(jax.grad(
        lambda s, v0: hh.solve(hh.SpotLens().set(
            hh.FieldLens("market_inputs.V0").set(prob, v0), s), cm_method).price,
        argnums=(0, 1)))
    timed(price_fn, prob)  # compile
    price, greeks = timed(greeks_fn, prob)[0]
    med, _ = in_turns({"price": price_fn, "greeks": greeks_fn}, prob)
    greeks = {k: float(greeks[k]) for k in GREEK_ORDER}
    cm_delta, cm_vega = (float(g) for g in cm_grad(prob.market_inputs.spot,
                                                    prob.market_inputs.V0))
    tp, tg = med["price"], med["greeks"]
    emit("b_flagship_greeks", pairs=GREEK_PAIRS, precision="f64", price=float(price),
         greeks=greeks, carr_madan_delta=cm_delta, carr_madan_vega_v0=cm_vega,
         price_s=tp, greeks_s=tg, greeks_over_price=tg / tp)
    check(all(math.isfinite(v) for v in greeks.values()), f"non-finite greeks {greeks}")
    check(abs(greeks["spot"] - cm_delta) <= 0.02 * abs(cm_delta),
          f"delta {greeks['spot']} vs Carr-Madan {cm_delta}")
    check(abs(greeks["V0"] - cm_vega) <= 0.02 * abs(cm_vega),
          f"V0 vega {greeks['V0']} vs Carr-Madan {cm_vega}")


def phase_c():
    from scipy.stats import norm

    h_market = bench.bench_problem().market_inputs

    # batched Black-Scholes price + (delta, vega, rho) against the closed forms
    strikes, spot, sigma, r, T, fn = bench.batched_bs_price_greeks(BS_BOOK)
    timed(fn, spot, sigma, r)
    (price, (delta, vega, rho)), sec = timed(fn, spot, sigma, r)
    K = np.asarray(strikes)
    d1 = (np.log(spot / K) + (r + 0.5 * sigma**2) * T) / (sigma * np.sqrt(T))
    d2 = d1 - sigma * np.sqrt(T)
    want = dict(price=spot * norm.cdf(d1) - K * np.exp(-r * T) * norm.cdf(d2),
                delta=norm.cdf(d1), vega=spot * norm.pdf(d1) * np.sqrt(T),
                rho=K * T * np.exp(-r * T) * norm.cdf(d2))
    got = dict(price=price, delta=delta, vega=vega, rho=rho)
    err = {k: float(np.max(np.abs(np.asarray(got[k]) - want[k]))) for k in want}
    emit("c_batched_bs", options=BS_BOOK, precision="f64", seconds=sec,
         options_per_s=BS_BOOK / sec, max_abs_err=err)
    check(max(err.values()) < 1e-8, f"batched BS off the closed forms: {err}")

    # grid engines over strike books, at the precision solve serves by default
    engines = {name: (eng, mkt, mk) for name, eng, mkt, mk, _ in bench.grid_engines(h_market)}
    book = jnp.linspace(60.0, 140.0, GRID_BOOK)
    prices = {}
    for name in ("CRR-1024 BS American put", "PDE-1D 256x128 BS American put"):
        eng, mkt, mk = engines[name]
        prices[name], compile_s, sec = bench.time_book(eng, mkt, mk, book)
        emit("c_grid_engine", engine=name, options=GRID_BOOK, precision="f64",
             seconds=sec, compile_s=compile_s, options_per_s=GRID_BOOK / sec)
    gap = float(jnp.max(jnp.abs(prices["CRR-1024 BS American put"]
                                - prices["PDE-1D 256x128 BS American put"])))
    emit("c_crr_vs_pde", max_abs_diff=gap)
    check(gap <= 1e-2, f"CRR and PDE American puts differ by {gap}")

    _, mkt, mk = engines["Carr-Madan Heston European call"]
    cm_fns = {kind: bench.book_fn(hh.CarrMadan(1.0, 32.0, hh.HestonDynamics(), engine=kind),
                                  mkt, mk)
              for kind in ("complex", "pair")}
    cm_books = {kind: timed(fn, book)[0] for kind, fn in cm_fns.items()}  # compile
    med, times = in_turns(cm_fns, book)
    emit("c_carr_madan_grid", options=GRID_BOOK, precision="f64", median_s=med,
         times_s=times, options_per_s={k: GRID_BOOK / v for k, v in med.items()})
    gap = float(jnp.max(jnp.abs(cm_books["complex"] - cm_books["pair"])))
    check(gap < 1e-8 and bool(jnp.all(jnp.isfinite(cm_books["complex"]))),
          f"Carr-Madan engines differ by {gap}")

    eng, mkt, mk = engines["ADI-2D 128x48x64 Heston American put"]
    adi, compile_s, sec = bench.time_book(eng, mkt, mk, jnp.asarray(ADI_STRIKES))
    emit("c_adi2d", strikes=list(ADI_STRIKES), prices=[float(p) for p in adi],
         precision="f64", seconds=sec, compile_s=compile_s)
    check(bool(jnp.all(jnp.isfinite(adi))), "ADI-2D prices not finite")

    # LSM American put under Heston against the ADI-2D price at K = 100, on
    # the conditional grid (variance in the regression basis, Rao-Blackwell)
    lsm = hh.LSM(hh.MonteCarlo(hh.HestonDynamics(), hh.HestonQE(conditional=True),
                               hh.SimulationConfig(trajectories=LSM_PATHS, steps=LSM_STEPS,
                                                   variance_reduction=hh.Antithetic(),
                                                   seed=0)), degree=3)
    put = hh.PricingProblem(mk(100.0), h_market)
    lsm_fn = jax.jit(lambda p: hh.solve(p, lsm).price)
    lsm_price, compile_s = timed(lsm_fn, put)
    lsm_price, sec = timed(lsm_fn, put)
    adi_atm = float(adi[ADI_STRIKES.index(100.0)])
    rel = abs(float(lsm_price) - adi_atm) / adi_atm
    emit("c_lsm_heston", paths=LSM_PATHS, steps=LSM_STEPS, precision="f64",
         price=float(lsm_price), adi2d=adi_atm, rel_diff=rel, seconds=sec,
         first_call_s=compile_s)
    check(rel <= 0.01, f"LSM {float(lsm_price)} vs ADI-2D {adi_atm}")

    # Broadie-Kaya exact sampler on the device
    bk = hh.MonteCarlo(hh.HestonDynamics(), hh.HestonBroadieKaya(),
                       hh.SimulationConfig(trajectories=BK_PATHS, steps=1,
                                           variance_reduction=hh.Antithetic(), seed=0))
    prob = bench.bench_problem()
    bk_fn = jax.jit(lambda p: hh.solve(p, bk).price)
    cm = carr_madan_price(prob)
    bk_price, compile_s = timed(bk_fn, prob)
    bk_price, sec = timed(bk_fn, prob)
    samples = hh.simulate_terminal_prices(prob, bk)
    pay = np.asarray(jnp.mean(jnp.maximum(samples - bench.STRIKE, 0.0), axis=0))
    se = float(np.exp(-bench.R * float(hh.yearfrac(bench.REF, bench.EXPIRY)))
               * pay.std(ddof=1) / math.sqrt(BK_PATHS))
    emit("c_broadie_kaya", paths=BK_PATHS, precision="f64", price=float(bk_price),
         carr_madan=cm, stderr=se, seconds=sec, first_call_s=compile_s,
         on_device=str(bk_price.devices()))
    check(abs(float(bk_price) - cm) <= 4.0 * se, f"Broadie-Kaya {float(bk_price)} vs {cm}")

    cal = bench.calibrate_heston_surface()
    emit("c_calibration", quotes=51, precision="f64", **cal)
    check(cal["converged"] and cal["rmse"] <= 1e-3, f"calibration {cal}")


def four_cards():
    import __graft_entry__ as graft
    from hedgehog_tpu.parallel import make_paths_mesh, sharded_mc_price

    devices = jax.devices()
    check(len(devices) >= 4 and all(d.platform == "gpu" for d in devices[:4]),
          f"--four-cards needs four GPUs, JAX sees {devices}")
    results = graft._dryrun_multichip_impl(4)
    for name, value in results.items():
        ids = sorted(d.id for d in value.sharding.device_set)
        emit(f"four_{name}", device_set=ids, value=np.asarray(value).tolist())
        check(len(ids) == 4, f"{name} ran on devices {ids}")

    prob = bench.bench_problem()
    method = flagship_method(FLAGSHIP_PAIRS)
    mesh = make_paths_mesh(devices[:4])
    sharded = jax.jit(lambda p: sharded_mc_price(p, method, mesh))
    one = solve_stats_fn(method)
    p4, (p1, se) = timed(sharded, prob)[0], timed(one, prob)[0]  # compile
    ids = sorted(d.id for d in p4.sharding.device_set)
    p4, p1, se = float(p4), float(p1), float(se)
    med, times = in_turns({"sharded": sharded, "one_card": one}, prob)
    peaks = [peak_bytes(d) for d in devices[:4]]
    emit("four_sharded_flagship", pairs=FLAGSHIP_PAIRS, sharded_price=p4, one_card_price=p1,
         stderr_one_card=se, median_s=med, times_s=times,
         one_card_over_sharded=med["one_card"] / med["sharded"], device_set=ids,
         peak_bytes_in_use=peaks)
    check(len(ids) == 4, f"sharded flagship ran on devices {ids}")
    # independent per-device streams: statistical agreement, sqrt(2)·4 stderr
    check(abs(p4 - p1) <= 4.0 * math.sqrt(2.0) * se + BIAS_BP * 1e-4 * p1,
          f"sharded {p4} vs one-card {p1}")
    check(all(p > 0 for p in peaks), f"a card did no work: {peaks}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the path-sharded phases on four GPUs")
    args = ap.parse_args()
    enable_compilation_cache()
    dev = bench.require_gpu()
    print(f"card: {bench.card_line()}", flush=True)
    if args.four_cards:
        four_cards()
    else:
        prob = bench.bench_problem()
        cm = carr_madan_price(prob)
        phase_a(prob, cm)
        phase_b(prob)
        phase_c()
    print(json.dumps({"ok": True, "device": {"platform": dev.platform,
                                             "kind": dev.device_kind,
                                             "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
