"""Monte Carlo pricing engine: dynamics × strategy × config.

Parity target: reference src/pricing_methods/montecarlo.jl (dynamics/strategy/
variance-reduction taxonomy, SimulationConfig, exact vs Euler-Maruyama paths,
antithetic variates, payoff reduction, discounted mean price).

Accelerator design (replaces StochasticDiffEq/DiffEqNoiseProcess, SURVEY §2b):

- **Megabatch simulation**: one ``lax.scan`` over time steps carrying a
  ``(paths,)`` state vector — all paths advance in lockstep.  No
  per-trajectory solver objects; the path axis is the vectorized axis and (in
  ``hedgehog_tpu.parallel``) the sharded axis.
- **Counter-based RNG**: a single static integer seed derives a Threefry key;
  normals are deterministic functions of (seed, step, path).  The reference's
  per-trajectory seed vector (montecarlo.jl:58-79) exists for reproducibility;
  "same config ⇒ same price" holds here by construction and any path is
  re-derivable from (seed, path index) — the checkpoint/recovery story of
  SURVEY §5.
- **Antithetic = negated normals**: flipping the Brownian grid (montecarlo.jl:
  252-263) or the σ → −σ exact-GBM trick (:270-284) are both exactly
  "negate the standard normals"; we simulate N pairs (2N paths, like the
  reference) and average payoffs pairwise.
- **Differentiable**: with the RNG held fixed, ``jax.grad`` through
  simulate→payoff→discount gives pathwise Greeks (the ForwardDiff-through-
  seeded-MC trick of greeks_agreement.jl:170-241).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from ..core.dates import yearfrac
from ..core.payoffs import require_european
from ..core.problems import MonteCarloSolution, PricingProblem
from ..core.solve import AbstractPricingMethod, register_solver
from ..market.rate_curve import df, df_yf, zero_rate_yf
from ..market.inputs import carry_yield, market_yearfrac
from ..market.vol_surface import FlatVolSurface, get_vol
from ..models.dynamics import (
    BatesDynamics,
    CEVDynamics,
    HestonDynamics,
    KouJumpDynamics,
    VarianceGammaDynamics,
    LognormalDynamics,
    LocalVolDynamics,
    MertonJumpDynamics,
    NormalDynamics,
    HestonHullWhiteDynamics,
    RoughBergomiDynamics,
    SABRDynamics,
    SLVDynamics,
    lognormal_terminal_law,
)
from ..utils.pytree import pytree, static_field

__all__ = [
    "SimulationConfig",
    "MonteCarlo",
    "EulerMaruyama",
    "HestonQE",
    "BlackScholesExact",
    "HestonBroadieKaya",
    "MertonExact",
    "KouExact",
    "VarianceGammaExact",
    "BachelierExact",
    "RoughBergomiMixing",
    "NoVarianceReduction",
    "Antithetic",
    "simulate_terminal_prices",
    "simulate_price_grid",
    "simulate_conditional_values",
    "mc_path_values",
    "heston_surface_mc",
    "rbergomi_surface_mc",
    "heston_variance_swap_strike",
    "brownian_bridge_extremum",
    "double_bridge_survival_factors",
]


# ------------------ Variance reduction ------------------


class VarianceReductionStrategy:
    pass


@pytree
class NoVarianceReduction(VarianceReductionStrategy):
    pass


@pytree
class Antithetic(VarianceReductionStrategy):
    pass


# ------------------ Strategies ------------------


class SimulationStrategy:
    pass


@pytree
class EulerMaruyama(SimulationStrategy):
    """Euler-Maruyama log-space stepping."""


@pytree
class HestonQE(SimulationStrategy):
    """Andersen Quadratic-Exponential discretization (QE-M) — near-exact
    per-step CIR moments, sub-bp vanilla bias at ~8-16 steps vs ~100 for
    Euler. Beyond-reference capability (see models/heston_qe.py).

    ``conditional=True`` switches European vanilla pricing to the
    Romano-Touzi conditional (mixing) Monte Carlo estimator: only the
    variance path is simulated (one normal + one uniform per step) and each
    path is finished with the conditional Black-Scholes closed form — logS_T
    given the V path is exactly normal via the CIR integral identity.
    ~1.7× cheaper per step, ~12× lower payoff variance at |ρ|≈0.7, and a
    smooth (kink-free) estimator, so pathwise AD greeks lose the
    discontinuity noise.  Terminal samples do not exist under this
    estimator: it prices through ``solve`` / ``mc_path_values`` only."""

    martingale_correction: bool = static_field(default=True)
    conditional: bool = static_field(default=False)


class ExactSimulation(SimulationStrategy):
    pass


@pytree
class BlackScholesExact(ExactSimulation):
    """Exact terminal lognormal draw (no path discretization error)."""


@pytree
class HestonBroadieKaya(ExactSimulation):
    """Exact Heston terminal sampling (Broadie-Kaya)."""

    cf_terms: int = static_field(default=128)
    inversion_iters: int = static_field(default=64)


@pytree
class MertonExact(ExactSimulation):
    """Exact Merton jump-diffusion terminal sampling (beyond-reference model
    family; pair with MertonJumpDynamics/MertonInputs): Poisson jump count
    by fixed-trip CDF inversion from one uniform, then the conditional
    normal close logS_T | N — three draws per path, no discretization error.

    Greeks: the count N is a discrete function of the intensity λ, so the
    per-path payoffs carry the frozen-count Poisson likelihood-ratio
    surrogate (same construction as HestonExactMixing's transition score) —
    plain ``jax.grad`` through ``solve`` is unbiased in ALL seven market
    parameters including λ."""


@pytree
class KouExact(ExactSimulation):
    """Exact Kou double-exponential jump-diffusion terminal sampling
    (beyond-reference model family; pair with KouJumpDynamics/KouInputs):
    Poisson jump count by fixed-trip CDF inversion, each jump size by the
    piecewise double-exponential inverse CDF from one uniform, plus the
    exact diffusion normal — no discretization error.

    Greeks: the count and the up/down branch are discrete, so pathwise AD
    misses the (λ, p_up) sensitivities — differentiate the Carr-Madan CF
    route for jump-parameter greeks (smooth in all five)."""


@pytree
class VarianceGammaExact(ExactSimulation):
    """Exact Variance Gamma terminal sampling (beyond-reference model
    family; pair with VarianceGammaDynamics/VarianceGammaInputs): one gamma
    subordinator draw G ~ Gamma(T/ν, ν) plus one normal —
    logS += (r−q+ω)T + θG + σ√G·Z, no discretization error.  PRNG gamma
    draws use jax.random.gamma (exact, implicitly differentiable); the
    Sobol' stream inverts the corrected-saddlepoint gamma quantile
    (models/heston_exact.gamma_qtl — smooth, ≲bp-accurate for shape
    T/ν ≳ 0.25; very small shapes prefer the PRNG stream)."""


@pytree
class BachelierExact(ExactSimulation):
    """Exact Bachelier terminal draw (beyond-reference model family; pair
    with NormalDynamics/BachelierInputs): S_T = F + σ_N√T·Z in one normal
    draw — no discretization error, negative terminal prices allowed (the
    point of the normal model)."""


@pytree
class HestonExactMixing(ExactSimulation):
    """Exact-transition segmented mixing estimator (models/heston_exact.py):
    exact noncentral-χ² CIR transitions + gamma-matched exact conditional
    ∫V moments (both drawn through the corrected saddlepoint gamma
    quantile, ADR-008 addendum 3) + conditional Black-Scholes close.
    |bias| ≤ 0.31bp at ``config.steps = 2`` segments (the recommended
    setting) at roughly the per-path cost of an 11-step QE mixing run
    (which carries ~3.4bp) — the European *price* flagship.

    Like HestonQE(conditional=True) it never materializes terminal samples;
    it prices through ``solve`` / ``mc_path_values`` only.  The per-path
    values carry the frozen-count Poisson likelihood-ratio surrogate, so
    ``jax.grad`` through ``solve`` is unbiased despite the discrete count
    (see models/heston_exact.py)."""


@pytree
class RoughBergomiMixing(ExactSimulation):
    """Exact-Volterra mixing estimator for rough Bergomi (beyond-reference
    model family; pair with RoughBergomiDynamics/RoughBergomiInputs; scheme
    in models/rough_bergomi.py): the joint Gaussian (ΔW₁, Z) vector is
    drawn EXACTLY from its analytic covariance — one Cholesky at trace
    time, one matmul per batch — then each variance path closes with
    the conditional Black-Scholes formula (Romano-Touzi: logS_T | W₁-path
    is exactly normal).  The only discretization is the left-point Riemann
    sum for (∫V, ∫√V dW₁), which keeps the effective forward exactly
    unbiased; ``config.steps`` is the grid size n (Cholesky is (2n)²).

    Like the Heston mixing strategies it never materializes terminal
    samples; smooth per-path values → pathwise AD greeks including
    ∂price/∂H (the covariance panel is differentiable in the Hurst
    index).  ``quad_nodes`` sizes the Gauss-Legendre panel behind the
    Z-covariance (64 ≈ 1e-11 accurate for H ∈ [0.03, 0.5]).

    ``fp32=True`` runs the BULK work (Gaussian draws, the Volterra
    matmul, the variance/(∫V, ∫√V dW) accumulation) in float32, with the
    matmuls at ``precision=HIGHEST`` (no TF32), while the covariance +
    Cholesky (tiny, conditioning-sensitive) and the final conditional-BS
    close stay f64.  Prices agree with the f64 path to ~1e-4 relative
    (tests/unit/test_rough_bergomi.py)."""

    quad_nodes: int = static_field(default=64)
    fp32: bool = static_field(default=False)


@pytree
class SimulationConfig:
    """MC run configuration (montecarlo.jl:58-79).

    ``seed`` is the base of the counter-based RNG stream (replaces the
    reference's per-trajectory seed vector; see module docstring).

    ``qmc=True`` replaces iid draws with a digitally-shifted Sobol' sequence
    (math/sobol.py) in the pure-JAX samplers (exact GBM, Euler, QE): near
    O(N⁻¹) error decay for smooth payoffs — beyond-reference capability.
    The seed selects the randomization, so re-seeding gives independent
    unbiased estimates for confidence intervals.
    """

    trajectories: int = static_field(default=10_000)
    steps: int = static_field(default=1)
    variance_reduction: VarianceReductionStrategy = static_field(default=NoVarianceReduction())
    seed: int = static_field(default=0)
    qmc: bool = static_field(default=False)

    def __post_init__(self):
        # Sobol' period guard at the single-device boundary too (the sharded
        # path re-checks the GLOBAL count in parallel/sharding._local_method;
        # the in-device guard in math/sobol.py cannot fire on traced offsets)
        if self.qmc and self.trajectories > 2**30:
            raise ValueError(
                f"Sobol' sequence period is 2^30 points; trajectories "
                f"({self.trajectories}) would wrap and duplicate points"
            )


@pytree
class MonteCarlo(AbstractPricingMethod):
    dynamics: Any = static_field(default=LognormalDynamics())
    strategy: Any = static_field(default=BlackScholesExact())
    config: SimulationConfig = static_field(default=SimulationConfig())


# ------------------ Normal draws ------------------


def _normals(key, shape, antithetic_pair: bool):
    """Standard normals from a (possibly traced) PRNG key; under antithetic
    pairing returns the (Z, -Z) stack along a leading axis of 2."""
    z = jax.random.normal(key, shape, dtype=jnp.float64)
    if antithetic_pair:
        return jnp.stack([z, -z])
    return z[None]


def _base_key(config: "SimulationConfig", key):
    """Resolve the RNG key: explicit traced key (sharded callers fold in their
    device index) or the config's static seed."""
    return jax.random.PRNGKey(config.seed) if key is None else key


def _qmc_normals(key, steps: int, comps: int, paths: int, skip=0):
    """(steps, comps, paths) standard normals from a randomized Sobol' grid
    (dimension = step-major × component; path = point index; ``skip`` gives
    sharded devices disjoint slices of one sequence)."""
    from jax.scipy.special import ndtri

    from ..math.sobol import sobol_uniforms

    u = sobol_uniforms(key, paths, steps * comps, skip=skip)  # (paths, dims)
    z = ndtri(u)
    return jnp.moveaxis(z.reshape(paths, steps, comps), 0, -1)


def _two_factor_grid_normals(config: "SimulationConfig", key, dt, point_offset):
    """(g, steps, 2, paths) standard normals driving a two-factor Euler
    grid: plain PRNG draws, or — under QMC — Brownian-bridge-ordered Sobol'
    normals (BOTH driving Brownians bridged; Sobol' dims interleave as
    (W1_level, W2_level) per construction step).  Antithetic = the (Z, −Z)
    group stack.  Shared by the Heston and SLV steppers so the QMC/VR
    conventions cannot drift apart."""
    steps = config.steps
    anti = isinstance(config.variance_reduction, Antithetic)
    if config.qmc:
        from ..math.brownian_bridge import brownian_bridge_increments

        zq = _qmc_normals(key, steps, 2, config.trajectories, skip=point_offset)
        dw = jax.vmap(
            lambda zf: brownian_bridge_increments(zf.T, dt, steps).T,
            in_axes=1, out_axes=1,
        )(zq)
        zb = dw / jnp.sqrt(dt)
        return jnp.stack([zb, -zb]) if anti else zb[None]
    return _normals(key, (steps, 2, config.trajectories), anti)


def _qmc_normals_and_uniforms(key, steps: int, n_normal: int, paths: int, skip=0):
    """Normals (steps, n_normal, paths) plus one uniform stream (steps, paths)
    from a single Sobol' grid — the QE draw layout."""
    from jax.scipy.special import ndtri

    from ..math.sobol import sobol_uniforms

    comps = n_normal + 1
    u = sobol_uniforms(key, paths, steps * comps, skip=skip)  # (paths, dims)
    u = u.reshape(paths, steps, comps)
    z = ndtri(u[..., :n_normal])
    return jnp.moveaxis(z, 0, -1), jnp.moveaxis(u[..., n_normal], 0, -1)


# ------------------ Per-model simulation kernels (pure JAX) ------------------


def _require_no_dividend_schedule(market, what: str):
    """Raise when a discrete-dividend schedule reaches an estimator whose
    math assumes a dividend-free path law (single-bridge shortcuts,
    Dupire surfaces, return-convention products) — never silently ignore
    scheduled cash dividends."""
    if getattr(market, "dividends", None) is not None:
        raise TypeError(
            f"{what} does not support a discrete DividendSchedule; "
            "price the spot model on EulerMaruyama grids (ex-date drops), "
            "or strip the schedule if the dividend-free law is intended"
        )


def _sim_params(prob: PricingProblem):
    market = prob.market_inputs
    T = market_yearfrac(market, prob.payoff.expiry)
    # Reference drift rate: zero rate "at time 0" (montecarlo.jl:176, :200) —
    # constant-extrapolated first pillar for spine curves, the rate for flat.
    r0 = zero_rate_yf(market.rate, 0.0) - carry_yield(market)
    return market, T, r0


def _gbm_exact_terminal(prob, config, key, point_offset=0) -> jnp.ndarray:
    """(n_groups, paths) terminal prices via one exact lognormal draw."""
    anti = isinstance(config.variance_reduction, Antithetic)
    if config.qmc:
        zb = _qmc_normals(key, 1, 1, config.trajectories, skip=point_offset)[0, 0]
        z = jnp.stack([zb, -zb]) if anti else zb[None]
    else:
        z = _normals(key, (config.trajectories,), anti)
    mean, std = lognormal_terminal_law(prob.market_inputs, prob.payoff.expiry)
    return jnp.exp(mean + std * z)


def _kou_jump_size(u, p, e1, e2):
    """Double-exponential jump size from one uniform by the piecewise
    inverse CDF: u < 1−p → ln(u/(1−p))/η₂ (downward), else
    −ln((1−u)/p)/η₁ (upward).  Double-where keeps the dead branch's log
    argument positive so masked gradients stay clean."""
    down = u < (1.0 - p)
    u_dn = jnp.where(down, u, 1.0 - p)
    u_up = jnp.where(down, p, 1.0 - u)
    return jnp.where(
        down,
        jnp.log(jnp.maximum(u_dn / (1.0 - p), 1e-300)) / e2,
        -jnp.log(jnp.maximum(u_up / p, 1e-300)) / e1,
    )


def _kou_jump_sum(u_count, u_sizes, rate, p, e1, e2, kmax: int):
    """Compound-Poisson double-exponential jump sum: N = poisson_inv(rate,
    u_count) and Σ_{j<N} J(u_sizes[j]) via a fixed ``kmax``-trip masked sum
    (u_sizes leading axis = trip).  The count is gradient-stopped (discrete);
    sizes keep their (η₁, η₂) pathwise gradients."""
    from ..models.heston_exact import poisson_inv

    n = jax.lax.stop_gradient(poisson_inv(rate, u_count, kmax))
    sizes = _kou_jump_size(u_sizes, p, e1, e2)  # (kmax, ...)
    j_idx = jnp.arange(kmax, dtype=jnp.float64).reshape(
        (kmax,) + (1,) * (sizes.ndim - 1)
    )
    return jnp.sum(jnp.where(j_idx < n[None], sizes, 0.0), axis=0)


def _kou_exact_terminal(prob, config, key, point_offset=0):
    """(n_groups, paths) exact Kou terminal prices: exact diffusion normal
    + compound-Poisson double-exponential jump sum."""
    from ..models.dynamics import kou_terminal_params

    market = prob.market_inputs
    log_s0, r, T, sigma, lam, p, e1, e2, kbar = kou_terminal_params(
        market, prob.payoff.expiry
    )
    kmax = _merton_poisson_trips(lam * T, default=64)
    anti = isinstance(config.variance_reduction, Antithetic)
    paths = config.trajectories
    base = _base_key(config, key)
    if config.qmc:
        from jax.scipy.special import ndtri

        from ..math.sobol import sobol_uniforms

        # dims: 1 diffusion normal + 1 count uniform + kmax size uniforms
        us = sobol_uniforms(base, paths, 2 + kmax, skip=point_offset).T
        z_d = ndtri(us[0])
        u_c, u_s = us[1], us[2:]
    else:
        k_z, k_c, k_s = jax.random.split(base, 3)
        z_d = jax.random.normal(k_z, (paths,), dtype=jnp.float64)
        u_c = jax.random.uniform(k_c, (paths,), dtype=jnp.float64)
        u_s = jax.random.uniform(k_s, (kmax, paths), dtype=jnp.float64)
    if anti:
        z_d = jnp.stack([z_d, -z_d])
        u_c = jnp.stack([u_c, 1.0 - u_c])
        u_s = jnp.stack([u_s, 1.0 - u_s], axis=1)  # (kmax, g, paths)
    else:
        z_d, u_c, u_s = z_d[None], u_c[None], u_s[:, None]

    jumps = _kou_jump_sum(u_c, u_s, lam * T, p, e1, e2, kmax)
    x = (log_s0 + (r - 0.5 * sigma**2 - lam * kbar) * T
         + sigma * jnp.sqrt(T) * z_d + jumps)
    return jnp.exp(x)


def _kou_euler_paths(prob, config, key, *, return_grid: bool, point_offset=0):
    """Kou paths: per step one EXACT log increment (diffusion normal +
    per-step compound-Poisson double-exponential jump sum), so the terminal
    law is exact at ANY step count — the grid serves Asian fixings and LSM
    exercise, like the Merton grid.  Brownian-bridge barrier corrections do
    NOT apply between jump grids."""
    from ..models.dynamics import kou_terminal_params

    market = prob.market_inputs
    log_s0, r, T, sigma, lam, p, e1, e2, kbar = kou_terminal_params(
        market, prob.payoff.expiry
    )
    # grids need the carry in the PER-STEP drift (see _merton_euler_paths)
    log_s0 = jnp.log(market.spot)
    r = r - carry_yield(market)
    steps = config.steps
    dt = T / steps
    kmax = _merton_poisson_trips(lam * dt, default=16)
    anti = isinstance(config.variance_reduction, Antithetic)
    paths = config.trajectories
    base = _base_key(config, key)
    n_dims = 2 + kmax
    if config.qmc:
        from jax.scipy.special import ndtri

        from ..math.sobol import sobol_uniforms

        us = sobol_uniforms(base, paths, steps * n_dims, skip=point_offset)
        us = jnp.moveaxis(us.reshape(paths, steps, n_dims), 0, -1)
        z_d = ndtri(us[:, 0])
        u_c, u_s = us[:, 1], us[:, 2:]  # (steps, paths), (steps, kmax, paths)
    else:
        k_z, k_c, k_s = jax.random.split(base, 3)
        z_d = jax.random.normal(k_z, (steps, paths), dtype=jnp.float64)
        u_c = jax.random.uniform(k_c, (steps, paths), dtype=jnp.float64)
        u_s = jax.random.uniform(k_s, (steps, kmax, paths), dtype=jnp.float64)
    if anti:
        z_d = jnp.stack([z_d, -z_d], axis=1)
        u_c = jnp.stack([u_c, 1.0 - u_c], axis=1)
        u_s = jnp.stack([u_s, 1.0 - u_s], axis=2)  # (steps, kmax, g, paths)
    else:
        z_d, u_c, u_s = z_d[:, None], u_c[:, None], u_s[:, :, None]

    drift = (r - 0.5 * sigma**2 - lam * kbar) * dt
    vol_dt = sigma * jnp.sqrt(dt)
    x0 = jnp.full((z_d.shape[1], paths), log_s0 * jnp.ones(()))

    def step(x, inp):
        zdk, uck, usk = inp
        jumps = _kou_jump_sum(uck, usk, lam * dt, p, e1, e2, kmax)
        x_new = x + drift + vol_dt * zdk + jumps
        return x_new, (x_new if return_grid else None)

    x_T, xs = jax.lax.scan(step, x0, (z_d, u_c, u_s))
    if return_grid:
        grid = jnp.concatenate([x0[None], xs], axis=0)
        return jnp.exp(jnp.moveaxis(grid, 0, 1))
    return jnp.exp(x_T)


def _vg_increments(key, alpha, nu, n_draws, paths, qmc: bool, point_offset=0):
    """(G, Z) gamma-subordinator increments Gamma(alpha, scale=ν) and unit
    normals, shapes (n_draws, paths).  PRNG = jax.random.gamma (exact).
    QMC draws through the corrected-saddlepoint gamma quantile
    (models/heston_exact.gamma_qtl), which is accurate for shape ≥ 1 but
    COLLAPSES at small shapes (measured −77% price bias at α = 0.08 on a
    50-step VG grid) — so small/traced shapes use the BOOSTING identity
    G_α = G_{α+1}·U^{1/α} (exact in distribution for every α > 0, smooth
    in α): one extra Sobol' uniform lifts the quantile evaluation to shape
    α+1 ≥ 1 where it is sub-bp."""
    if qmc:
        from ..models.heston_exact import gamma_qtl

        z, u_boost = _qmc_normals_and_uniforms(
            key, n_draws, 2, paths, skip=point_offset
        )
        z_g, z_n = z[:, 0, :], z[:, 1, :]
        try:
            fast = float(alpha) >= 1.0
        except Exception:  # traced shape (e.g. grad over ν): boosted path
            fast = False
        if fast:
            g = gamma_qtl(alpha, z_g) * nu
        else:
            g = gamma_qtl(alpha + 1.0, z_g) * u_boost ** (1.0 / alpha) * nu
        return g, z_n
    k_g, k_z = jax.random.split(key)
    g = jax.random.gamma(k_g, alpha, (n_draws, paths), dtype=jnp.float64) * nu
    z = jax.random.normal(k_z, (n_draws, paths), dtype=jnp.float64)
    return g, z


def _vg_exact_terminal(prob, config, key, point_offset=0):
    """(n_groups, paths) exact VG terminal prices.  Antithetic pairs SHARE
    the subordinator draw and negate the conditional normal (the same
    conditional-Gaussian mirroring as Broadie-Kaya, heston.jl:296-297)."""
    from ..models.dynamics import vg_terminal_params

    market = prob.market_inputs
    log_s0, r, T, sigma, nu, theta, omega = vg_terminal_params(
        market, prob.payoff.expiry
    )
    anti = isinstance(config.variance_reduction, Antithetic)
    paths = config.trajectories
    g, z = _vg_increments(_base_key(config, key), T / nu, nu, 1, paths,
                          config.qmc, point_offset)
    g, z = g[0], z[0]
    zg = jnp.stack([z, -z]) if anti else z[None]
    x = (log_s0 + (r + omega) * T
         + theta * g[None] + sigma * jnp.sqrt(g)[None] * zg)
    return jnp.exp(x)


def _vg_euler_paths(prob, config, key, *, return_grid: bool, point_offset=0):
    """VG paths: per step one EXACT Lévy increment (gamma subordinator +
    conditional normal) — terminal exact at ANY step count; the grid serves
    Asian fixings and LSM exercise.  No Brownian-bridge barrier correction
    (pure-jump paths)."""
    from ..models.dynamics import vg_terminal_params

    market = prob.market_inputs
    log_s0, r, T, sigma, nu, theta, omega = vg_terminal_params(
        market, prob.payoff.expiry
    )
    # grids carry the dividend in the per-step drift (see _merton_euler_paths)
    log_s0 = jnp.log(market.spot)
    r = r - carry_yield(market)
    steps = config.steps
    dt = T / steps
    anti = isinstance(config.variance_reduction, Antithetic)
    paths = config.trajectories
    g, z = _vg_increments(_base_key(config, key), dt / nu, nu, steps, paths,
                          config.qmc, point_offset)
    if anti:
        zg = jnp.stack([z, -z], axis=1)  # (steps, g, paths); shared G
        gg = g[:, None]
    else:
        zg, gg = z[:, None], g[:, None]

    drift = (r + omega) * dt
    x0 = jnp.full((zg.shape[1], paths), log_s0 * jnp.ones(()))

    def step(x, inp):
        gk, zk = inp
        x_new = x + drift + theta * gk + sigma * jnp.sqrt(gk) * zk
        return x_new, (x_new if return_grid else None)

    x_T, xs = jax.lax.scan(step, x0, (gg, zg))
    if return_grid:
        grid = jnp.concatenate([x0[None], xs], axis=0)
        return jnp.exp(jnp.moveaxis(grid, 0, 1))
    return jnp.exp(x_T)


def _bachelier_forward_vol(prob):
    """(F₀, σ_N, T) for a Bachelier market at the problem's expiry
    (carry-adjusted: F = spot·e^{−qT}/D(T))."""
    from ..market.inputs import forward_spot

    market = prob.market_inputs
    T = market_yearfrac(market, prob.payoff.expiry)
    f0 = forward_spot(market, T) / df(market.rate, prob.payoff.expiry)
    return f0, market.sigma, T


def _bachelier_exact_terminal(prob, config, key, point_offset=0):
    """(n_groups, paths) Bachelier terminal prices: S_T = F + σ_N√T·Z."""
    anti = isinstance(config.variance_reduction, Antithetic)
    if config.qmc:
        zb = _qmc_normals(key, 1, 1, config.trajectories, skip=point_offset)[0, 0]
        z = jnp.stack([zb, -zb]) if anti else zb[None]
    else:
        z = _normals(key, (config.trajectories,), anti)
    f0, sigma_n, T = _bachelier_forward_vol(prob)
    return f0 + sigma_n * jnp.sqrt(T) * z


def _bachelier_euler_paths(prob, config, key, *, return_grid: bool, point_offset=0):
    """Bachelier paths on the T-forward: F_{k+1} = F_k + σ_N√Δt·Z — the
    per-step increments ARE the exact arithmetic-BM transitions, so the
    terminal law is exact at any step count; the grid exists for
    path-dependent consumers (Asian fixings, LSM exercise), converted to
    SPOT via the deterministic S_t = F_t·D(T)/D(t) as for the SABR grid."""
    market = prob.market_inputs
    f0, sigma_n, T = _bachelier_forward_vol(prob)
    steps = config.steps
    dt = T / steps
    anti = isinstance(config.variance_reduction, Antithetic)
    if config.qmc:
        from ..math.brownian_bridge import brownian_bridge_increments

        zq = _qmc_normals(key, steps, 1, config.trajectories, skip=point_offset)[:, 0, :]
        dw = brownian_bridge_increments(zq.T, dt, steps)
        zb = dw.T / jnp.sqrt(dt)
        z = jnp.stack([zb, -zb]) if anti else zb[None]
    else:
        z = _normals(key, (steps, config.trajectories), anti)
    vol_dt = sigma_n * jnp.sqrt(dt)
    x0 = jnp.full((z.shape[0], config.trajectories), f0 * jnp.ones(()))

    def step(x, zk):
        x_new = x + vol_dt * zk
        return x_new, (x_new if return_grid else None)

    zs = jnp.moveaxis(z, 1, 0)
    x_final, xs = jax.lax.scan(step, x0, zs)
    if return_grid:
        grid = jnp.concatenate([x0[None], xs], axis=0)  # F grid, time leading
        t_k = jnp.arange(steps + 1) * dt
        d_ratio = df_yf(market.rate, T) / df_yf(market.rate, t_k) * jnp.exp(
            carry_yield(market) * (T - t_k)
        )
        return jnp.moveaxis(grid * d_ratio[:, None, None], 0, 1)
    return x_final


def _cev_euler_paths(prob, config, key, *, return_grid: bool, point_offset=0):
    """CEV Euler paths in PRICE space (beyond-reference model family):
    S_{k+1} = max(S_k·(1 + f_k·Δt) + σ·S_k^β·√Δt·Z, 0) with the exact
    per-step forward rate f_k less the carry.  Price space (not log): the
    log diffusion σ·S^{β−1} blows up as S → 0 for β < 1, while the price
    SDE is exactly where the absorbing boundary lives — the max(·, 0) floor
    IS the absorption (σ·0^β = 0 keeps absorbed paths at zero).  Terminal
    (n_groups, paths) or grid (n_groups, steps+1, paths)."""
    market = prob.market_inputs
    T = market_yearfrac(market, prob.payoff.expiry)
    steps = config.steps
    dt = T / steps
    anti = isinstance(config.variance_reduction, Antithetic)
    if config.qmc:
        zb = _qmc_normals(key, steps, 1, config.trajectories, skip=point_offset)[:, 0, :]
        z = jnp.stack([zb, -zb]) if anti else zb[None]
    else:
        z = _normals(key, (steps, config.trajectories), anti)
    d_grid = df_yf(market.rate, jnp.arange(steps + 1) * dt)
    fwd = jnp.log(d_grid[:-1] / d_grid[1:]) / dt - carry_yield(market)
    sq = jnp.sqrt(dt)
    sigma, beta = market.sigma, market.beta
    s0 = jnp.full((z.shape[0], config.trajectories), market.spot * jnp.ones(()))

    def step(s, inp):
        zk, fk = inp
        # double-where guard: d(s^β)/ds → ∞ at the absorbing boundary, so
        # absorbed paths must see a literal zero diffusion (not 0^β) or
        # pathwise AD NaNs out (same pattern as the QE psi guards)
        alive = s > 0.0
        s_safe = jnp.where(alive, s, 1.0)
        diffusion = jnp.where(alive, sigma * s_safe**beta, 0.0)
        s_new = jnp.maximum(s * (1.0 + fk * dt) + diffusion * sq * zk, 0.0)
        return s_new, (s_new if return_grid else None)

    zs = (jnp.moveaxis(z, 1, 0), fwd)
    s_T, ss = jax.lax.scan(step, s0, zs)
    if return_grid:
        grid = jnp.concatenate([s0[None], ss], axis=0)
        return jnp.moveaxis(grid, 0, 1)
    return s_T


def _sabr_euler_paths(prob, config, key, *, return_grid: bool, point_offset=0):
    """SABR Euler paths on the T-forward (beyond-reference model family):
    dF = α F^β dW₁ (plain Euler, absorbed at 0 — the CEV backbone can reach
    zero for β < 1), dα = ν α dW₂ stepped EXACTLY (per-step lognormal), with
    corr(dW₁, dW₂) = ρ via a 2×2 Cholesky.  Simulation runs under the
    T-forward measure, where F is driftless and F_T = S_T — the discounted
    payoff mean is exactly the price.  Terminal (n_groups, paths) or full
    grid (n_groups, steps+1, paths)."""
    market = prob.market_inputs
    T = market_yearfrac(market, prob.payoff.expiry)
    steps = config.steps
    dt = T / steps
    anti = isinstance(config.variance_reduction, Antithetic)
    if config.qmc:
        z = _qmc_normals(key, steps, 2, config.trajectories, skip=point_offset)
        z1b, z2b = z[:, 0, :], z[:, 1, :]
        if anti:
            z1 = jnp.stack([z1b, -z1b]); z2 = jnp.stack([z2b, -z2b])
        else:
            z1, z2 = z1b[None], z2b[None]
    else:
        zb = _normals(key, (2, steps, config.trajectories), anti)
        z1, z2 = zb[:, 0], zb[:, 1]
    rho, nu, beta = market.rho, market.nu, market.beta
    from ..market.inputs import forward_spot

    zv = rho * z1 + jnp.sqrt(1.0 - rho**2) * z2  # vol leg, corr ρ with z1
    f0 = forward_spot(market, T) / df(market.rate, prob.payoff.expiry)
    sq = jnp.sqrt(dt)
    carry0 = (
        jnp.full((z1.shape[0], config.trajectories), f0),
        jnp.full((z1.shape[0], config.trajectories), market.alpha * jnp.ones(())),
    )

    def step(carry, zk):
        f, a_ = carry
        z1k, zvk = zk
        f_new = jnp.maximum(f + a_ * jnp.maximum(f, 0.0) ** beta * sq * z1k, 0.0)
        a_new = a_ * jnp.exp(-0.5 * nu**2 * dt + nu * sq * zvk)
        return (f_new, a_new), (f_new if return_grid else None)

    zs = (jnp.moveaxis(z1, 1, 0), jnp.moveaxis(zv, 1, 0))  # (steps, g, paths)
    (f_T, _), fs = jax.lax.scan(step, carry0, zs)
    if return_grid:
        grid = jnp.concatenate([carry0[0][None], fs], axis=0)
        # grid consumers (Asian fixings, LSM exercise values) want SPOT
        # prices: S_t = F_t·D(t, T)·e^{q(T−t)} = F_t·D(T)/D(t)·e^{q(T−t)},
        # exact for the deterministic rate/carry this library carries
        t_k = jnp.arange(steps + 1) * dt
        d_ratio = df_yf(market.rate, T) / df_yf(market.rate, t_k) * jnp.exp(
            carry_yield(market) * (T - t_k)
        )
        grid = grid * d_ratio[:, None, None]
        return jnp.moveaxis(grid, 0, 1)  # (g, steps+1, paths)
    return f_T


def _rbergomi_draws(prob, config, key, point_offset, n_extra: int, quad_nodes: int,
                    dtype=jnp.float64):
    """Exact joint (ΔW₁ increments, Z gridpoints) for rough Bergomi, plus
    ``n_extra`` iid standard-normal rows (the orthogonal spot leg for grid
    schemes): returns (dw, z, extra) each (g, n, paths) with g = 2 under
    antithetic pairing.  One (2n × 2n) Cholesky at trace time + one matmul
    per call — the matmul alternative to the hybrid-FFT scheme (see
    models/rough_bergomi.py)."""
    from ..models.rough_bergomi import volterra_chol

    market, T, _ = _sim_params(prob)
    n = config.steps
    paths = config.trajectories
    anti = isinstance(config.variance_reduction, Antithetic)
    chol = volterra_chol(market.hurst, T, n, quad_nodes=quad_nodes)  # (2n, 2n)
    chol = chol.astype(dtype)  # factorization stays f64; bulk follows dtype
    dims = 2 * n + n_extra
    base = _base_key(config, key)
    if config.qmc:
        from jax.scipy.special import ndtri

        from ..math.sobol import sobol_uniforms

        u = sobol_uniforms(base, paths, dims, skip=point_offset)  # (P, dims)
        xi = ndtri(u).T.astype(dtype)  # (dims, P)
    else:
        xi = jax.random.normal(base, (dims, paths), dtype=dtype)
    xi = jnp.stack([xi, -xi]) if anti else xi[None]  # (g, dims, P)
    # HIGHEST: an f32 matmul would otherwise run in TF32 on the GPU
    x = jnp.einsum("ij,gjp->gip", chol, xi[:, : 2 * n],
                   precision=jax.lax.Precision.HIGHEST)
    extra = xi[:, 2 * n :] if n_extra else None
    return x[:, :n], x[:, n:], extra


def _rbergomi_left_variance(market, z, T, n):
    """Variance at the grid LEFT points, (g, n, paths): V_0 = xi0 exactly,
    V_{t_k} from the exact Volterra samples (k = 1..n−1) — the left-point
    rule is what keeps the discrete mixing forward exactly unbiased."""
    from ..models.rough_bergomi import rbergomi_variance

    z_left = jnp.concatenate([jnp.zeros_like(z[:, :1]), z[:, : n - 1]], axis=1)
    t_left = (jnp.arange(n) / n) * T  # t_0 = 0 .. t_{n-1}
    return rbergomi_variance(market, z_left, t_left[None, :, None])


def _rbergomi_mixing_values(prob, config, key, point_offset=0, quad_nodes=64,
                            fp32: bool = False):
    """Per-path UNDISCOUNTED conditional vanilla values (g, paths) — the
    Romano-Touzi mixing close on exact-Volterra variance paths: conditional
    on the W₁ path, logS_T is normal with the (IV, J) = (ΣV_kΔt, Σ√V_kΔW_k)
    mixing factors, so each path finishes with the conditional BS closed
    form (smooth → pathwise AD greeks, incl. the roughness greek ∂/∂H)."""
    market, T, r0 = _sim_params(prob)
    n = config.steps
    dtype = jnp.float32 if fp32 else jnp.float64
    dw, z, _ = _rbergomi_draws(
        prob, config, key, point_offset, 0, quad_nodes, dtype=dtype
    )
    v = _rbergomi_left_variance(market, z, T, n)
    iv = jnp.sum(v, axis=1) * jnp.asarray(T / n, dtype)
    j = jnp.sum(jnp.sqrt(v) * dw, axis=1)
    # only the (g, paths) mixing factors cross back to f64 — the close and
    # the reduction are negligible next to the (g, n, paths) bulk above
    return _conditional_bs_close(
        prob, market, T, r0, iv.astype(jnp.float64), j.astype(jnp.float64)
    )


def _rbergomi_grid_with_variance(prob, config, key, point_offset=0,
                                 quad_nodes: int = 64):
    """(spot grid (g, n+1, paths), left-point variance (g, n, paths)) —
    shared substrate of the grid consumers and the barrier bridge factors
    (the within-segment log-bridge variance is V_k·Δt)."""
    market, T, r0 = _sim_params(prob)
    n = config.steps
    dt = T / n
    dw, z, zp = _rbergomi_draws(prob, config, key, point_offset, n, quad_nodes)
    v = _rbergomi_left_variance(market, z, T, n)
    rho = market.rho
    dlog = (r0 - 0.5 * v) * dt + jnp.sqrt(v) * (
        rho * dw + jnp.sqrt(1.0 - rho**2) * jnp.sqrt(dt) * zp
    )
    logs = jnp.log(market.spot) + jnp.concatenate(
        [jnp.zeros_like(dlog[:, :1]), jnp.cumsum(dlog, axis=1)], axis=1
    )
    return jnp.exp(logs), v


def _rbergomi_euler_paths(prob, config, key, *, return_grid: bool, point_offset=0,
                          quad_nodes: int = 64):
    """Rough Bergomi spot paths (beyond-reference model family): variance
    EXACT at the gridpoints (Volterra Cholesky draw), spot log-Euler with
    the left-point variance —
    ΔlogS_k = (r−q−V_k/2)Δt + √V_k(ρ·ΔW_k + √(1−ρ²)·√Δt·Z⊥_k).
    Terminal (g, paths) or full grid (g, n+1, paths); composes with the
    grid consumers (Asians, barriers via the bridge factors, LSM — note V
    is non-Markovian, so an (S, V) regression basis is approximate by
    construction; documented in docs/models.md)."""
    grid, _ = _rbergomi_grid_with_variance(
        prob, config, key, point_offset=point_offset, quad_nodes=quad_nodes
    )
    return grid if return_grid else grid[:, -1]


def _local_vol_euler_paths(prob, config, key, *, return_grid: bool, point_offset=0):
    """Dupire local-vol log-Euler paths (beyond-reference model family):
    x_{k+1} = x_k + (f_k − σ²_loc/2)dt + σ_loc √dt z with
    σ_loc = dupire_local_vol(market, t_k, S_k) (per-path surface lookup +
    exact AD surface derivatives, vmapped) and the exact per-step forward
    rate f_k = ln(D(t_k)/D(t_{k+1}))/dt, so a FLAT surface reproduces exact
    GBM stepping.  Terminal (n_groups, paths) or grid
    (n_groups, steps+1, paths)."""
    from ..models.local_vol import dupire_local_vol

    market = prob.market_inputs
    _require_no_dividend_schedule(
        market, "LocalVolDynamics (the Dupire surface assumes a "
        "continuous-carry diffusion)"
    )
    T = market_yearfrac(market, prob.payoff.expiry)
    steps = config.steps
    dt = T / steps
    anti = isinstance(config.variance_reduction, Antithetic)
    if config.qmc:
        zb = _qmc_normals(key, steps, 1, config.trajectories, skip=point_offset)[:, 0, :]
        z = jnp.stack([zb, -zb]) if anti else zb[None]
    else:
        z = _normals(key, (steps, config.trajectories), anti)
    t_k = jnp.arange(steps) * dt
    d_grid = df_yf(market.rate, jnp.arange(steps + 1) * dt)
    # per-step forward rates, less the dividend carry
    fwd = jnp.log(d_grid[:-1] / d_grid[1:]) / dt - carry_yield(market)
    sq = jnp.sqrt(dt)
    x0 = jnp.full((z.shape[0], config.trajectories), jnp.log(market.spot))
    sig_of = jax.vmap(jax.vmap(
        lambda tt, ss: dupire_local_vol(market, tt, ss), in_axes=(None, 0)
    ), in_axes=(None, 0))

    def step(x, inp):
        zk, tk, fk = inp
        sig = sig_of(tk, jnp.exp(x))
        x_new = x + (fk - 0.5 * sig * sig) * dt + sig * sq * zk
        return x_new, (x_new if return_grid else None)

    zs = (jnp.moveaxis(z, 1, 0), t_k, fwd)
    x_T, xs = jax.lax.scan(step, x0, zs)
    if return_grid:
        grid = jnp.concatenate([x0[None], xs], axis=0)
        return jnp.exp(jnp.moveaxis(grid, 0, 1))
    return jnp.exp(x_T)


def _slv_euler_paths(prob, config, key, *, return_grid: bool, point_offset=0):
    """Stochastic-local-vol full-truncation log-Euler paths (beyond-
    reference model family, models/slv.py):

      logS += (f_k − L²(t_k, S)V⁺/2)dt + L(t_k, S)·√(V⁺ dt)·Z₁
      V    += κ(θ − V⁺)dt + m·σ_v·√(V⁺ dt)·(ρZ₁ + √(1−ρ²)Z₂)

    with per-step exact forward rates f_k (flat surfaces/curves reproduce
    the Heston stepper with L ≡ σ/√·).  Requires a calibrated market
    (``market.leverage`` set by calibrate_leverage).  Terminal
    (n_groups, paths) or grid (n_groups, steps+1, paths)."""
    market = prob.market_inputs
    if market.leverage is None:
        raise ValueError(
            "SLV market has no calibrated leverage — run "
            "calibrate_leverage(market, horizon) and price on "
            "market.with_leverage(result)"
        )
    T = market_yearfrac(market, prob.payoff.expiry)
    steps = config.steps
    dt = T / steps
    q = carry_yield(market)
    d_grid = df_yf(market.rate, jnp.arange(steps + 1) * dt)
    fwd = jnp.log(d_grid[:-1] / d_grid[1:]) / dt - q
    return _cir_log_euler_paths(
        prob, config, key, return_grid=return_grid, point_offset=point_offset,
        sig_v=market.mixing * market.sigma, fwd_steps=fwd,
        leverage=market.leverage,
    )


def _merton_poisson_trips(rate, cap: int = 64, default: int = 64) -> int:
    """Checked static Poisson trip count for the Merton jump count: smallest
    k with P(N > k | λT) < 1e-9 (+1 margin, floored at 8); raises when even
    ``cap`` trips cannot meet the tail bound (λT ≳ 30 — hundreds of jumps
    per path want a different estimator).  Returns ``default`` when the
    rate is traced — the full ``cap`` (the loop is cheap FMAs and a traced
    rate means the hard λT guard cannot run, so take the most coverage
    available; λT beyond ~35 still needs the eager/concrete path to raise)."""
    import math

    try:
        r = float(rate)
    except Exception:
        return default
    p = math.exp(-r)
    cdf, k = p, 0
    while cdf < 1.0 - 1e-9 and k < cap:
        k += 1
        p *= r / k
        cdf += p
    if cdf < 1.0 - 1e-9:
        raise ValueError(
            f"Merton jump count needs a Poisson trip count beyond {cap} "
            f"(λT ≈ {r:.1f}); with hundreds of jumps per path the compound "
            f"process is near-Gaussian — price via CarrMadan(MertonJumpDynamics)"
        )
    return int(max(k + 1, 8))


def _merton_exact_terminal(prob, config, key, point_offset=0, with_score=False):
    """(n_groups, paths) exact Merton terminal prices; ``with_score=True``
    additionally returns the per-path frozen-count Poisson log-likelihood
    N·log(λT) − λT (the likelihood-ratio term unbiased λ-greeks need).

    Draw layout per path (QMC dims): (z_diffusion, z_jump, u_poisson);
    antithetic mirror = negated normals, 1−u."""
    from ..models.dynamics import merton_terminal_params
    from ..models.heston_exact import poisson_inv

    market = prob.market_inputs
    log_s0, r, T, sigma, lam, mu_j, s_j, kbar = merton_terminal_params(
        market, prob.payoff.expiry
    )
    rate = lam * T
    kmax = _merton_poisson_trips(rate)
    anti = isinstance(config.variance_reduction, Antithetic)
    paths = config.trajectories
    base = _base_key(config, key)
    if config.qmc:
        z, u_p = _qmc_normals_and_uniforms(base, 1, 2, paths, skip=point_offset)
        z_d, z_j, u_p = z[0, 0], z[0, 1], u_p[0]
    else:
        k_z, k_u = jax.random.split(base)
        zb = jax.random.normal(k_z, (2, paths), dtype=jnp.float64)
        z_d, z_j = zb[0], zb[1]
        u_p = jax.random.uniform(k_u, (paths,), dtype=jnp.float64)
    if anti:
        z_d = jnp.stack([z_d, -z_d])
        z_j = jnp.stack([z_j, -z_j])
        u_p = jnp.stack([u_p, 1.0 - u_p])
    else:
        z_d, z_j, u_p = z_d[None], z_j[None], u_p[None]

    n = jax.lax.stop_gradient(poisson_inv(rate, u_p, kmax))
    logl = n * jnp.log(jnp.maximum(rate, 1e-30)) - rate
    drift = log_s0 + (r - 0.5 * sigma**2 - lam * kbar) * T
    log_st = (drift + sigma * jnp.sqrt(T) * z_d
              + n * mu_j + jnp.sqrt(n) * s_j * z_j)
    samples = jnp.exp(log_st)
    if with_score:
        return samples, logl
    return samples


def _merton_euler_paths(prob, config, key, *, return_grid: bool, point_offset=0):
    """Merton jump-diffusion paths: per step one EXACT log increment
    (r − σ²/2 − λκ̄)dt + σ√dt·z + Σjumps, with the per-step jump count by
    fixed-trip Poisson CDF inversion and the jump sum collapsed to its
    conditional normal N(Nμ_J, Nσ_J²) — increments are iid and exact, so
    the terminal distribution is EXACT at ANY step count; the grid exists
    for path-dependent consumers (Asian fixings, LSM exercise).  Draw
    layout per step: (z_diffusion, z_jump, u_poisson).  NOTE the
    Brownian-bridge barrier correction does not apply between jump grids —
    barrier payoffs stay on the diffusion dynamics."""
    from ..models.dynamics import merton_terminal_params
    from ..models.heston_exact import poisson_inv

    market = prob.market_inputs
    log_s0, r, T, sigma, lam, mu_j, s_j, kbar = merton_terminal_params(
        market, prob.payoff.expiry
    )
    # merton_terminal_params folds the carry into log_s0 (= log S0 − qT,
    # right for one-shot terminal draws); a GRID needs the carry in the
    # PER-STEP drift instead, so intermediate fixings sit at e^{−q·t_k}
    log_s0 = jnp.log(market.spot)
    r = r - carry_yield(market)
    steps = config.steps
    dt = T / steps
    # per-STEP jump rate is small, so few trips bound the tail; reuse the
    # checked helper on the concrete per-step rate
    kmax = _merton_poisson_trips(lam * dt, default=16)
    anti = isinstance(config.variance_reduction, Antithetic)
    paths = config.trajectories
    base = _base_key(config, key)
    if config.qmc:
        # bridge-order the DIFFUSION normals (dim 0 drives the terminal
        # Brownian level, as in the GBM/Heston Euler samplers) so the QMC
        # rate survives long jump grids; the jump normals/uniforms are
        # per-step by nature and stay step-major
        from ..math.brownian_bridge import brownian_bridge_increments

        z, u_p = _qmc_normals_and_uniforms(base, steps, 2, paths, skip=point_offset)
        dw = brownian_bridge_increments(z[:, 0, :].T, dt, steps)
        z_d, z_j = dw.T / jnp.sqrt(dt), z[:, 1, :]
    else:
        k_z, k_u = jax.random.split(base)
        zb = jax.random.normal(k_z, (steps, 2, paths), dtype=jnp.float64)
        z_d, z_j = zb[:, 0], zb[:, 1]
        u_p = jax.random.uniform(k_u, (steps, paths), dtype=jnp.float64)
    if anti:
        z_d = jnp.stack([z_d, -z_d], axis=1)
        z_j = jnp.stack([z_j, -z_j], axis=1)
        u_p = jnp.stack([u_p, 1.0 - u_p], axis=1)
    else:
        z_d, z_j, u_p = z_d[:, None], z_j[:, None], u_p[:, None]

    drift = (r - 0.5 * sigma**2 - lam * kbar) * dt
    vol_dt = sigma * jnp.sqrt(dt)
    rate = lam * dt
    x0 = jnp.full((z_d.shape[1], paths), log_s0 * jnp.ones(()))

    def step(x, inp):
        zdk, zjk, upk = inp
        n = jax.lax.stop_gradient(poisson_inv(rate, upk, kmax))
        x_new = (x + drift + vol_dt * zdk
                 + n * mu_j + jnp.sqrt(n) * s_j * zjk)
        return x_new, (x_new if return_grid else None)

    x_T, xs = jax.lax.scan(step, x0, (z_d, z_j, u_p))
    if return_grid:
        grid = jnp.concatenate([x0[None], xs], axis=0)
        return jnp.exp(jnp.moveaxis(grid, 0, 1))
    return jnp.exp(x_T)


def _merton_payoffs_with_score(prob, method, payoff, key=None, point_offset=0):
    """Per-path Merton payoffs with the likelihood-ratio surrogate baked in
    (applied per antithetic group BEFORE pair-averaging — the mirrored
    uniform draws a different count): primal unchanged, ``jax.grad``
    through solve AND through mc_path_values (the sharded pricer's
    interface) is unbiased in λ.  Returns the reduce_payoffs contract
    ((paths,) or (m, paths))."""
    import dataclasses

    samples, logl = _merton_exact_terminal(
        prob, method.config, key, with_score=True, point_offset=point_offset
    )
    if jnp.ndim(payoff.strike) > 0:
        p = dataclasses.replace(payoff, strike=jnp.asarray(payoff.strike)[:, None])
        vals = p(samples[:, None, :])  # (g, m, paths)
        ll = logl[:, None, :]
        b = jax.lax.stop_gradient(jnp.mean(vals, axis=(0, -1)))[None, :, None]
    else:
        vals = payoff(samples)  # (g, paths)
        ll = logl
        b = jax.lax.stop_gradient(jnp.mean(vals))
    vals = vals + jax.lax.stop_gradient(vals - b) * (ll - jax.lax.stop_gradient(ll))
    return jnp.mean(vals, axis=0)


def _gbm_euler_paths(prob, config, key, *, return_grid: bool, point_offset=0):
    """Log-Euler GBM paths: terminal (n_groups, paths) or full grid
    (n_groups, steps+1, paths).

    Discrete cash dividends (market/dividends.py) price the PIECEWISE-
    LOGNORMAL spot model here: each ex-date is snapped to its nearest grid
    time and the path drops by the cash amount there (floored near zero),
    exactly the same discretization as the PDE engine's jump conditions —
    and every grid consumer (LSM, Asians, bridge barriers, autocallables)
    composes, because segments between grid points stay plain GBM."""
    market, T, r0 = _sim_params(prob)
    sigma = (
        market.sigma.sigma
        if isinstance(market.sigma, FlatVolSurface)
        else get_vol(market.sigma, prob.payoff.expiry, market.spot)
    )
    steps = config.steps
    dt = T / steps
    anti = isinstance(config.variance_reduction, Antithetic)
    divs = getattr(market, "dividends", None)
    if config.qmc:
        # Brownian-bridge ordering: Sobol' dim 0 drives the terminal value so
        # the QMC rate survives long paths (math/brownian_bridge.py)
        from ..math.brownian_bridge import brownian_bridge_increments

        zq = _qmc_normals(key, steps, 1, config.trajectories, skip=point_offset)[:, 0, :]
        dw = brownian_bridge_increments(zq.T, dt, steps)  # (paths, steps), ~N(0, dt)
        zb = dw.T / jnp.sqrt(dt)  # back to unit normals for the shared scan
        z = jnp.stack([zb, -zb]) if anti else zb[None]
    else:
        z = _normals(key, (steps, config.trajectories), anti)  # (g, steps, paths)
    drift = (r0 - 0.5 * sigma**2) * dt
    vol_dt = sigma * jnp.sqrt(dt)
    x0 = jnp.full((z.shape[0], config.trajectories), jnp.log(market.spot))

    zs = jnp.moveaxis(z, 1, 0)  # (steps, g, paths)
    if divs is not None:
        from ..market.dividends import dividend_step_amounts

        d_steps = dividend_step_amounts(market, T, steps)  # (steps,)
        floor = 1e-8 * market.spot

        def step(x, inp):
            zk, dk = inp
            x_new = x + drift + vol_dt * zk
            # ex-date drop in price space (dk == 0 on non-dividend steps:
            # the exp/log round trip is then the identity up to rounding)
            x_new = jnp.log(jnp.maximum(jnp.exp(x_new) - dk, floor))
            return x_new, (x_new if return_grid else None)

        x_final, xs = jax.lax.scan(step, x0, (zs, d_steps))
    else:

        def step(x, zk):
            x_new = x + drift + vol_dt * zk
            return x_new, (x_new if return_grid else None)

        x_final, xs = jax.lax.scan(step, x0, zs)
    if return_grid:
        grid = jnp.concatenate([x0[None], xs], axis=0)  # (steps+1, g, paths)
        return jnp.exp(jnp.moveaxis(grid, 1, 0))  # (g, steps+1, paths)
    return jnp.exp(x_final)


def _cir_log_euler_paths(prob, config, key, *, return_grid: bool,
                         point_offset, sig_v, fwd_steps, leverage=None):
    """Shared full-truncation log-Euler stepper for the CIR-variance
    family (Heston and SLV — SLV is Heston with a leverage multiplier on
    the spot vol and a mixing-scaled vol-of-vol):

      logS += (f_k − Λ²V⁺/2)dt + Λ·√(V⁺ dt)·Z₁
      V    += κ(θ − V⁺)dt + σᵥ√(V⁺ dt)·(ρZ₁ + √(1−ρ²)Z₂),  V⁺ = max(V, 0)

    with Λ = 1 (Heston) or L(t_k, S) (SLV), per-step drifts ``fwd_steps``
    (steps,) and vol-of-vol ``sig_v``.  Terminal (g, paths) or grid
    (g, steps+1, paths) PRICE-space samples."""
    if leverage is not None:
        from ..models.dynamics import cir_family_euler_update
        from ..models.slv import leverage_at

    market = prob.market_inputs
    T = market_yearfrac(market, prob.payoff.expiry)
    steps = config.steps
    dt = T / steps
    sqrt_dt = jnp.sqrt(dt)
    z = _two_factor_grid_normals(config, key, dt, point_offset)
    n_groups = z.shape[0]
    kappa, theta, rho = market.kappa, market.theta, market.rho
    rho_bar = jnp.sqrt(1.0 - rho**2)
    t_left = jnp.arange(steps) * dt

    x0 = jnp.full((n_groups, config.trajectories), jnp.log(market.spot))
    v0 = jnp.full((n_groups, config.trajectories), market.V0)

    def step(carry, inp):
        x, v = carry
        zk, tk, fk = inp
        z1, z2 = zk[:, 0, :], zk[:, 1, :]
        if leverage is None:
            # inline Heston form: drift uses V⁺ directly (not √V⁺²), which
            # keeps the primal bit-identical to the pre-unification stepper
            v_plus = jnp.maximum(v, 0.0)
            # Double-where: sqrt'(0)=inf would poison gradients of the
            # truncated branch (0·inf = NaN) — pathwise vega needs this.
            sqrt_v = jnp.where(v > 0.0, jnp.sqrt(jnp.where(v > 0.0, v, 1.0)), 0.0)
            x_new = x + (fk - 0.5 * v_plus) * dt + sqrt_v * sqrt_dt * z1
            v_new = v + kappa * (theta - v_plus) * dt + sig_v * sqrt_v * sqrt_dt * (
                rho * z1 + rho_bar * z2
            )
        else:
            x_new, v_new = cir_family_euler_update(
                x, v, z1, z2, lev_x=leverage_at(leverage, tk, x), fk=fk,
                kappa=kappa, theta=theta, sig_v=sig_v, rho=rho,
                rho_bar=rho_bar, dt=dt, sqrt_dt=sqrt_dt,
            )
        return (x_new, v_new), (x_new if return_grid else None)

    zs = (jnp.moveaxis(z, 1, 0), t_left, fwd_steps)
    # remat the step: storing only the (logS, V) carries instead of every
    # intermediate more than halves the reverse-AD cost of pathwise greeks
    # (identity for primal-only use)
    (x_final, _), xs = jax.lax.scan(jax.checkpoint(step), (x0, v0), zs)
    if return_grid:
        grid = jnp.concatenate([x0[None], xs], axis=0)
        return jnp.exp(jnp.moveaxis(grid, 1, 0))
    return jnp.exp(x_final)


def _heston_euler_paths(prob, config, key, *, return_grid: bool, point_offset=0):
    """Full-truncation log-Euler Heston paths (heston.jl:7-31 semantics):
    the shared CIR-family stepper with identity leverage and the
    reference's flat drift r0."""
    market, T, r0 = _sim_params(prob)
    fwd = jnp.broadcast_to(r0, (config.steps,))
    return _cir_log_euler_paths(
        prob, config, key, return_grid=return_grid, point_offset=point_offset,
        sig_v=market.sigma, fwd_steps=fwd,
    )


def _heston_qe_paths(prob, config, key, strat: "HestonQE", *, return_grid: bool, point_offset=0):
    """Andersen QE(-M) Heston paths (models/heston_qe.py)."""
    from ..models.heston_qe import qe_constants, qe_step

    market, T, r0 = _sim_params(prob)
    steps = config.steps
    dt = T / steps
    c = qe_constants(market.kappa, market.theta, market.sigma, market.rho, r0, dt)
    anti = isinstance(config.variance_reduction, Antithetic)
    k_z, k_u = jax.random.split(_base_key(config, key))
    if config.qmc:
        zb, ub = _qmc_normals_and_uniforms(k_z, steps, 2, config.trajectories, skip=point_offset)
        z = jnp.stack([zb, -zb]) if anti else zb[None]
        us = jnp.stack([ub, 1.0 - ub]) if anti else ub[None]
    else:
        z = _normals(k_z, (steps, 2, config.trajectories), anti)  # (g, steps, 2, paths)
        # uniforms shared across the antithetic pair via 1-u mirroring
        u = jax.random.uniform(k_u, (steps, config.trajectories), dtype=jnp.float64)
        us = jnp.stack([u, 1.0 - u]) if anti else u[None]  # (g, steps, paths)
    n_groups = z.shape[0]

    x0 = jnp.full((n_groups, config.trajectories), jnp.log(market.spot))
    v0 = jnp.full((n_groups, config.trajectories), market.V0)

    def step(carry, inp):
        x, v = carry
        zk, uk = inp
        x_new, v_new = qe_step(
            x, v, zk[:, 0, :], zk[:, 1, :], uk, c,
            martingale_correction=strat.martingale_correction,
        )
        return (x_new, v_new), (x_new if return_grid else None)

    zs = jnp.moveaxis(z, 1, 0)  # (steps, g, 2, paths)
    us_s = jnp.moveaxis(us, 1, 0)  # (steps, g, paths)
    # remat: see _heston_euler_paths — halves pathwise-greek reverse-AD cost
    (x_final, _), xs = jax.lax.scan(jax.checkpoint(step), (x0, v0), (zs, us_s))
    if return_grid:
        grid = jnp.concatenate([x0[None], xs], axis=0)
        return jnp.exp(jnp.moveaxis(grid, 1, 0))
    return jnp.exp(x_final)


def _heston_qe_mixing_values(prob, config, key, point_offset=0):
    """Per-path UNDISCOUNTED conditional vanilla values (n_groups, paths) —
    the Romano-Touzi mixing estimator on a QE variance path.

    Only V is simulated.  With W_s = ρ·W_v + √(1−ρ²)·W_⊥ and the CIR
    integral identity J ≡ ∫√V dW_v = (V_T − V_0 − κθT + κ·IV)/σ,

        logS_T | {V path}  ~  N(logS_0 + rT − ½IV + ρJ − ... , (1−ρ²)·IV)

    so E[payoff | V path] is the Black-Scholes closed form at effective
    forward F_eff = S0·e^{rT + ρJ − ρ²IV/2} and total variance (1−ρ²)·IV.
    IV uses the same trapezoid proxy as the QE-M log-price update (γ=½).
    Smooth in every parameter → pathwise AD greeks without kink noise.
    """
    from ..models.heston_qe import qe_constants, qe_v_step

    market, T, r0 = _sim_params(prob)
    steps = config.steps
    dt = T / steps
    c = qe_constants(market.kappa, market.theta, market.sigma, market.rho, r0, dt)
    anti = isinstance(config.variance_reduction, Antithetic)
    base = _base_key(config, key)
    if config.qmc:
        # unsplit base key: one randomized Sobol' sequence per seed
        zb, ub = _qmc_normals_and_uniforms(base, steps, 1, config.trajectories, skip=point_offset)
        zb = zb[:, 0, :]
        z = jnp.stack([zb, -zb]) if anti else zb[None]
        us = jnp.stack([ub, 1.0 - ub]) if anti else ub[None]
    else:
        k_z, k_u = jax.random.split(base)
        z = _normals(k_z, (steps, config.trajectories), anti)  # (g, steps, paths)
        u = jax.random.uniform(k_u, (steps, config.trajectories), dtype=jnp.float64)
        us = jnp.stack([u, 1.0 - u]) if anti else u[None]
    n_groups = z.shape[0]

    kappa, sigma, rho = market.kappa, market.sigma, market.rho
    ktd = kappa * market.theta * dt
    v0 = jnp.full((n_groups, config.trajectories), market.V0)
    zero = jnp.zeros_like(v0)

    def step(carry, inp):
        v, iv, j = carry
        zk, uk = inp
        v_new = qe_v_step(v, zk, uk, c)
        iv_step = 0.5 * dt * (v + v_new)
        j_new = j + (v_new - v - ktd + kappa * iv_step) / sigma
        return (v_new, iv + iv_step, j_new), None

    zs = jnp.moveaxis(z, 1, 0)  # (steps, g, paths)
    us_s = jnp.moveaxis(us, 1, 0)
    (v_t, iv, j), _ = jax.lax.scan(jax.checkpoint(step), (v0, zero, zero), (zs, us_s))

    return _conditional_bs_close(prob, market, T, r0, iv, j)


def _bates_qe_mixing_values(prob, config, key, point_offset=0):
    """Per-path UNDISCOUNTED conditional values under BATES (Heston + Merton
    jumps): the Romano-Touzi mixing estimator extends verbatim — conditional
    on the QE variance path AND the jump count N (independent of V),

        logS_T | (V path, N) ~ N(logS0 + (r−q−λκ̄)T − ½IV + ρJ + Nμ_J,
                                  (1−ρ²)·IV + Nσ_J²)

    so the conditional close runs at the jump-shifted effective forward
    F_eff·e^{Nμ_J + ½Nσ_J² − λκ̄T} with the jump variance added.  Smooth in
    every parameter EXCEPT the discrete count: (spot, V0, κ, θ, σ, ρ, μ_J,
    σ_J) greeks are pathwise; the λ greek differentiates the Carr-Madan CF
    route (the count is gradient-stopped)."""
    from ..models.heston_qe import qe_constants, qe_v_step

    market, T, r0 = _sim_params(prob)
    steps = config.steps
    dt = T / steps
    c = qe_constants(market.kappa, market.theta, market.sigma, market.rho, r0, dt)
    anti = isinstance(config.variance_reduction, Antithetic)
    base = _base_key(config, key)
    paths = config.trajectories
    lam, mu_j, s_j = market.jump_intensity, market.jump_mean, market.jump_std
    kbar = jnp.expm1(mu_j + 0.5 * s_j**2)
    kmax = _merton_poisson_trips(lam * T, default=64)
    if config.qmc:
        from jax.scipy.special import ndtri

        from ..math.sobol import sobol_uniforms

        # dims: per step (z_v, u_qe) + ONE global jump-count uniform
        u = sobol_uniforms(base, paths, 2 * steps + 1, skip=point_offset)
        zb = ndtri(u[:, :steps]).T          # (steps, paths)
        ub = u[:, steps:2 * steps].T
        u_nb = u[:, -1]
        z = jnp.stack([zb, -zb]) if anti else zb[None]
        us = jnp.stack([ub, 1.0 - ub]) if anti else ub[None]
        u_n = jnp.stack([u_nb, 1.0 - u_nb]) if anti else u_nb[None]
    else:
        k_z, k_u, k_n = jax.random.split(base, 3)
        z = _normals(k_z, (steps, paths), anti)
        u = jax.random.uniform(k_u, (steps, paths), dtype=jnp.float64)
        us = jnp.stack([u, 1.0 - u]) if anti else u[None]
        un = jax.random.uniform(k_n, (paths,), dtype=jnp.float64)
        u_n = jnp.stack([un, 1.0 - un]) if anti else un[None]
    n_groups = z.shape[0]

    kappa, sigma, rho = market.kappa, market.sigma, market.rho
    ktd = kappa * market.theta * dt
    v0 = jnp.full((n_groups, paths), market.V0)
    zero = jnp.zeros_like(v0)

    def step(carry, inp):
        v, iv, j = carry
        zk, uk = inp
        v_new = qe_v_step(v, zk, uk, c)
        iv_step = 0.5 * dt * (v + v_new)
        j_new = j + (v_new - v - ktd + kappa * iv_step) / sigma
        return (v_new, iv + iv_step, j_new), None

    zs = jnp.moveaxis(z, 1, 0)
    us_s = jnp.moveaxis(us, 1, 0)
    (v_t, iv, j), _ = jax.lax.scan(jax.checkpoint(step), (v0, zero, zero), (zs, us_s))

    from ..models.heston_exact import poisson_inv

    n = jax.lax.stop_gradient(poisson_inv(lam * T, u_n, kmax))
    f_eff = market.spot * jnp.exp(
        r0 * T + rho * j - 0.5 * rho**2 * iv
        + n * (mu_j + 0.5 * s_j**2) - lam * kbar * T
    )
    var = (1.0 - rho**2) * iv + n * s_j**2
    return conditional_payoff_close(prob.payoff, f_eff, var)


def _bates_euler_paths(prob, config, key, *, return_grid: bool, point_offset=0):
    """Full-truncation log-Euler BATES paths: the Heston stepper plus a
    per-step EXACT compound-Poisson jump increment (count by fixed-trip
    inversion, jump sum collapsed to its conditional normal — the Merton
    grid trick), so the jump component carries no discretization error.
    Terminal (n_groups, paths) or grid (n_groups, steps+1, paths) for LSM
    and Asian fixings under Bates."""
    market, T, r0 = _sim_params(prob)
    kappa, theta, sigma, rho, V0 = (market.kappa, market.theta, market.sigma,
                                    market.rho, market.V0)
    lam, mu_j, s_j = market.jump_intensity, market.jump_mean, market.jump_std
    kbar = jnp.expm1(mu_j + 0.5 * s_j**2)
    steps = config.steps
    dt = T / steps
    sqrt_dt = jnp.sqrt(dt)
    kmax = _merton_poisson_trips(lam * dt, default=16)
    anti = isinstance(config.variance_reduction, Antithetic)
    paths = config.trajectories
    base = _base_key(config, key)
    if config.qmc:
        from jax.scipy.special import ndtri

        from ..math.sobol import sobol_uniforms

        u = sobol_uniforms(base, paths, 4 * steps, skip=point_offset)
        u = jnp.moveaxis(u.reshape(paths, steps, 4), 0, -1)  # (steps, 4, paths)
        zb = ndtri(u[:, :3])                                  # z_s, z_v, z_jump
        upb = u[:, 3]
        z = jnp.stack([zb, -zb], axis=1) if anti else zb[:, None]
        u_p = jnp.stack([upb, 1.0 - upb], axis=1) if anti else upb[:, None]
    else:
        k_z, k_u = jax.random.split(base)
        zb = jax.random.normal(k_z, (steps, 3, paths), dtype=jnp.float64)
        upb = jax.random.uniform(k_u, (steps, paths), dtype=jnp.float64)
        if anti:
            z = jnp.stack([zb, -zb], axis=1)
            u_p = jnp.stack([upb, 1.0 - upb], axis=1)
        else:
            z, u_p = zb[:, None], upb[:, None]
    # z: (steps, g, 3, paths); u_p: (steps, g, paths)
    z = jnp.moveaxis(z, 2, 0)  # (3, steps, g, paths)
    from ..models.heston_exact import poisson_inv

    rho_bar = jnp.sqrt(1.0 - rho**2)
    n_groups = z.shape[2]
    x0 = jnp.full((n_groups, paths), jnp.log(market.spot))
    v0 = jnp.full((n_groups, paths), V0)

    def step(carry, inp):
        x, v = carry
        z1, z2, zj, uk = inp
        v_plus = jnp.maximum(v, 0.0)
        sqrt_v = jnp.where(v > 0.0, jnp.sqrt(jnp.where(v > 0.0, v, 1.0)), 0.0)
        n = jax.lax.stop_gradient(poisson_inv(lam * dt, uk, kmax))
        x_new = (x + (r0 - lam * kbar - 0.5 * v_plus) * dt
                 + sqrt_v * sqrt_dt * z1
                 + n * mu_j + jnp.sqrt(n) * s_j * zj)
        v_new = v + kappa * (theta - v_plus) * dt + sigma * sqrt_v * sqrt_dt * (
            rho * z1 + rho_bar * z2
        )
        return (x_new, v_new), (x_new if return_grid else None)

    (x_T, _), xs = jax.lax.scan(step, (x0, v0), (z[0], z[1], z[2], jnp.moveaxis(u_p, 0, 0)))
    if return_grid:
        grid = jnp.concatenate([x0[None], xs], axis=0)
        return jnp.exp(jnp.moveaxis(grid, 0, 1))
    return jnp.exp(x_T)


def brownian_bridge_survival_factors(log_grid, seg_vars, log_barrier, up: bool):
    """Per-SEGMENT Brownian-bridge no-cross factors 1 − exp(−2·d0·d1/σ²_k),
    zeroed when either endpoint lies beyond the barrier (Glasserman, *MC
    Methods in Financial Engineering*, §6.4) — shape (steps, ...).  Their
    product is the per-path survival probability; the per-segment form
    additionally gives the first-hit-segment distribution the at-hit rebate
    leg needs.  Smooth in every input → pathwise AD barrier greeks survive.

    ``log_grid``: (steps+1, ...) coordinates in which the path is Brownian
    within segments — log-prices for the lognormal families, price LEVELS
    for Bachelier; ``seg_vars``: (steps, ...) or scalar.  ``log_barrier``
    may be scalar or (steps+1,)-leading-broadcastable (a per-grid-time
    barrier; the reflection argument is exact for a boundary LINEAR in time
    within each segment, which is how the Bachelier route maps its
    discount-modulated barrier)."""
    x0, x1 = log_grid[:-1], log_grid[1:]
    b = jnp.asarray(log_barrier)
    if b.ndim > 0 and b.shape[0] != log_grid.shape[0]:
        raise ValueError(
            f"a non-scalar barrier must carry the (steps+1,)-leading "
            f"per-grid-time axis (got shape {b.shape} against a "
            f"{log_grid.shape} grid); broadcast-style barriers are "
            f"ambiguous with the time-varying form"
        )
    b0, b1 = (b, b) if b.ndim == 0 else (b[:-1], b[1:])
    d0 = (b0 - x0) if up else (x0 - b0)
    d1 = (b1 - x1) if up else (x1 - b1)
    inside = (d0 > 0.0) & (d1 > 0.0)
    var = jnp.maximum(seg_vars, 1e-30)
    # double-where: the false branch's (positive-exponent) value must never
    # be computed, or its overflow poisons the masked gradient
    arg = jnp.where(inside, -2.0 * d0 * d1 / var, 0.0)
    return jnp.where(inside, -jnp.expm1(arg), 0.0)


def brownian_bridge_survival(log_grid, seg_vars, log_barrier, up: bool):
    """Per-path no-cross probability: the product over segments of
    :func:`brownian_bridge_survival_factors` (exact for GBM grids; on the
    Heston conditional grid σ²_k is the segment's integrated variance)."""
    return jnp.prod(
        brownian_bridge_survival_factors(log_grid, seg_vars, log_barrier, up),
        axis=0,
    )


def brownian_bridge_extremum(log_grid, seg_vars, u, maximum: bool):
    """Running extremum of the continuous path by EXACT per-segment
    Brownian-bridge draws: given segment endpoints (a, b) and variance s²,
    the bridge maximum has CDF P(M ≤ y) = 1 − e^{−2(y−a)(y−b)/s²} (y ≥
    max(a, b)), so one uniform inverts it in closed form,

        M = ½·(a + b + √((a−b)² − 2·s²·log1p(−u))),

    the minimum by reflection (− the root).  The running extremum over
    [0, T] is the max/min over segments — segments are independent bridges
    given the grid, so this is the path's extremum IN DISTRIBUTION, jointly
    with the grid (exact for GBM grids at any step count; on the Heston
    conditional grid s²_k is the segment's integrated variance).  Smooth in
    (grid, seg_vars) almost everywhere → pathwise AD lookback greeks work.

    ``log_grid``: (steps+1, ...); ``seg_vars``: (steps, ...) or scalar;
    ``u``: (steps, ...) uniforms in [0, 1).  Returns shape ``(...)``."""
    a, b = log_grid[:-1], log_grid[1:]
    var = jnp.maximum(seg_vars, 1e-30)
    rad = jnp.sqrt((a - b) ** 2 - 2.0 * var * jnp.log1p(-u))
    if maximum:
        return jnp.max(0.5 * (a + b + rad), axis=0)
    return jnp.min(0.5 * (a + b - rad), axis=0)


def double_bridge_survival_factors(log_grid, seg_vars, log_lower, log_upper,
                                   n_images: int = 5):
    """Per-SEGMENT two-sided Brownian-bridge NO-EXIT factors for the
    corridor (log_lower, log_upper): with segment endpoints ã, b̃ relative
    to the lower barrier, width c and variance s², the no-exit probability
    is the image series

        Σ_n [ e^{−2nc(nc + b̃ − ã)/s²} − e^{−2(nc + ã)(nc + b̃)/s²} ]

    (n = 0 recovers the single lower-barrier factor; every exponent is ≤ 0
    inside the corridor, so no term can overflow).  Zeroed when either
    endpoint lies outside; truncated at ``n_images`` (terms decay like
    e^{−2n²c²/s²}) and clipped to [0, 1] against truncation residue.
    Smooth in every input → pathwise AD double-barrier greeks survive.

    Shapes as in :func:`brownian_bridge_survival_factors`."""
    x0, x1 = log_grid[:-1], log_grid[1:]
    c = log_upper - log_lower
    at = x0 - log_lower
    bt = x1 - log_lower
    inside = (at > 0.0) & (bt > 0.0) & (at < c) & (bt < c)
    var = jnp.maximum(seg_vars, 1e-30)
    # double-where: park the dead branch mid-corridor so its exponents stay
    # finite and its masked gradients clean
    at_s = jnp.where(inside, at, 0.5 * c)
    bt_s = jnp.where(inside, bt, 0.5 * c)
    p = jnp.zeros_like(at_s)
    for n in range(-n_images, n_images + 1):
        nc = n * c
        p = p + jnp.exp(-2.0 * nc * (nc + bt_s - at_s) / var)
        p = p - jnp.exp(-2.0 * (nc + at_s) * (nc + bt_s) / var)
    return jnp.where(inside, jnp.clip(p, 0.0, 1.0), 0.0)


def _supports_bridge_grid(method: MonteCarlo) -> bool:
    """True when ``_bridge_log_grid`` accepts this (dynamics, strategy)
    combo — the resolution rule behind ``ki_monitoring='auto'``."""
    dyn, strat = method.dynamics, method.strategy
    if isinstance(dyn, LognormalDynamics) and isinstance(strat, EulerMaruyama):
        return True
    if isinstance(dyn, HestonDynamics) and isinstance(strat, HestonQE):
        return strat.conditional
    if isinstance(dyn, HestonDynamics) and isinstance(strat, HestonExactMixing):
        return True
    if isinstance(dyn, RoughBergomiDynamics) and isinstance(strat, EulerMaruyama):
        return True
    return False


def _bridge_log_grid(prob: PricingProblem, method: MonteCarlo, what: str):
    """Shared grid substrate for the bridge estimators: simulate a STEPPED
    price grid whose path is Brownian in LOG space within segments, plus
    the per-segment variances.  Returns ``(spot_grid, seg_vars, v_grid)``
    with ``spot_grid`` (steps+1, g, paths) time-leading PRICE space,
    ``seg_vars`` scalar or (steps, g, paths), and ``v_grid`` the
    (g, steps+1, paths) variance grid on the conditional Heston bridge
    (None otherwise).

    Supported: LognormalDynamics × EulerMaruyama (segment variance σ²Δt —
    exact for GBM at any step count) and HestonDynamics ×
    HestonQE(conditional=True) (segment variance = the grid's integrated
    variance).  ``what`` names the payoff family in error messages."""
    market = prob.market_inputs
    dyn, strat, config = method.dynamics, method.strategy, method.config
    _, T, _ = _sim_params(prob)

    if isinstance(dyn, LognormalDynamics) and isinstance(strat, EulerMaruyama):
        sigma = (
            market.sigma.sigma
            if isinstance(market.sigma, FlatVolSurface)
            else get_vol(market.sigma, prob.payoff.expiry, market.spot)
        )
        grid = simulate_price_grid(prob, method)  # (g, steps+1, paths)
        spot_grid = jnp.moveaxis(grid, 1, 0)
        seg_vars = sigma**2 * (T / config.steps)
        return spot_grid, seg_vars, None
    if (
        isinstance(dyn, HestonDynamics)
        and isinstance(strat, HestonQE)
        and strat.conditional
    ):
        s_grid, v_grid = simulate_conditional_grid(prob, config)
        dt = T / config.steps
        iv = 0.5 * dt * (v_grid[:, :-1] + v_grid[:, 1:])  # (g, steps, paths)
        spot_grid = jnp.moveaxis(s_grid, 1, 0)
        return spot_grid, jnp.moveaxis(iv, 1, 0), v_grid
    if isinstance(dyn, HestonDynamics) and isinstance(strat, HestonExactMixing):
        # EXACT transitions + SAMPLED per-segment ∫V: the bridge clock is the
        # distributionally correct integrated variance, eliminating the
        # trapezoid's within-segment V-stochasticity bias (r3 verdict item 3)
        s_grid, v_grid, iv_segs = simulate_exact_conditional_grid(prob, config)
        spot_grid = jnp.moveaxis(s_grid, 1, 0)
        return spot_grid, jnp.moveaxis(iv_segs, 1, 0), v_grid
    if isinstance(dyn, RoughBergomiDynamics) and isinstance(strat, EulerMaruyama):
        s_grid, v = _rbergomi_grid_with_variance(prob, config, None)
        dt = T / config.steps
        spot_grid = jnp.moveaxis(s_grid, 1, 0)
        # within a segment the simulated log-bridge variance is the frozen
        # left-point V_k·Δt (the same freeze the stepper itself uses)
        return spot_grid, jnp.moveaxis(v * dt, 1, 0), None
    raise TypeError(
        f"{what} grids need LognormalDynamics with EulerMaruyama, "
        "HestonDynamics with HestonQE(conditional=True) or "
        "HestonExactMixing, or RoughBergomiDynamics with EulerMaruyama; got "
        f"({type(dyn).__name__}, {type(strat).__name__})"
    )


def barrier_grid_factors(prob: PricingProblem, method: MonteCarlo):
    """Simulate a STEPPED price grid and its per-segment Brownian-bridge
    no-cross factors for ``prob.payoff`` (a BarrierOption) — the shared
    substrate of the European bridge-MC estimator and the American barrier
    LSM.  Returns ``(spot_grid, factors, t_mids, v_grid, seg_vars)`` with
    shapes ``(steps+1, g, paths)`` (PRICE space, time leading),
    ``(steps, g, paths)``, ``(steps,)``; ``v_grid`` is the
    ``(g, steps+1, paths)`` variance grid on the conditional Heston bridge
    (for the joint LSM basis) and None otherwise; ``seg_vars`` is the
    per-segment log-bridge variance the factors were built from, returned
    so Richardson re-bridging (every-2nd-node coarse pass) can reuse the
    ALREADY-SIMULATED grid instead of re-simulating it (ADVICE r4).

    Supported grids: LognormalDynamics × EulerMaruyama (log-space bridge,
    segment variance σ²Δt — exact for GBM at any step count),
    HestonDynamics × HestonQE(conditional=True) (log-space bridge, segment
    variance = the grid's integrated variance), and NormalDynamics ×
    EulerMaruyama (PRICE-space bridge on the T-forward F = S/c(t), where
    the barrier becomes the per-segment-linear boundary H/c(t) — the
    reflection formula stays exact for linear boundaries, leaving only the
    O((rΔt)²) within-segment curvature of c)."""
    from ..core.payoffs import Up

    payoff = prob.payoff
    market = prob.market_inputs
    dyn, strat, config = method.dynamics, method.strategy, method.config
    up = isinstance(payoff.direction, Up)
    _, T, _ = _sim_params(prob)

    if (
        isinstance(dyn, (LognormalDynamics, RoughBergomiDynamics))
        and isinstance(strat, EulerMaruyama)
    ) or (
        isinstance(dyn, HestonDynamics)
        and (
            (isinstance(strat, HestonQE) and strat.conditional)
            or isinstance(strat, HestonExactMixing)
        )
    ):
        spot_grid, seg_vars, v_grid = _bridge_log_grid(prob, method, "barrier")
        factors = brownian_bridge_survival_factors(
            jnp.log(spot_grid), seg_vars, jnp.log(payoff.barrier), up
        )
    elif isinstance(dyn, NormalDynamics) and isinstance(strat, EulerMaruyama):
        grid = simulate_price_grid(prob, method)  # SPOT grid (g, steps+1, paths)
        spot_grid = jnp.moveaxis(grid, 1, 0)
        # F-space: F = S/c(t) is the Brownian coordinate
        # (c = D(T)/D(t)·e^{q(T−t)} with carry q), so the barrier is the
        # per-grid-time level H/c(t_k)
        t_k = jnp.arange(config.steps + 1) * (T / config.steps)
        c = df_yf(market.rate, T) / df_yf(market.rate, t_k) * jnp.exp(
            carry_yield(market) * (T - t_k)
        )
        f_grid = spot_grid / c[:, None, None]
        barrier_k = (payoff.barrier / c)[:, None, None]
        seg_vars = market.sigma**2 * (T / config.steps)
        factors = brownian_bridge_survival_factors(f_grid, seg_vars, barrier_k, up)
        v_grid = None
    else:
        raise TypeError(
            "barrier grids need LognormalDynamics or NormalDynamics with "
            "EulerMaruyama, or HestonDynamics with HestonQE(conditional=True) "
            "or HestonExactMixing; "
            f"got ({type(dyn).__name__}, {type(strat).__name__})"
        )
    t_mids = (jnp.arange(config.steps) + 0.5) * (T / config.steps)
    return spot_grid, factors, t_mids, v_grid, seg_vars


# Fine-grid Richardson weight 2^α/(2^α−1) for the bridge-bias extrapolation.
# The within-segment bias is a MIX of √Δt and Δt terms (measured fine vs
# coarse-subsample pair, 4×2^18-path seeds, σ_v ∈ {0.3, 0.6, 0.9-Feller-
# violating}): a pure √Δt weight (α=½) overshoots −20…−70 bp while α=0.75
# centers the residual at +0.6/−1.5/−0.8 bp at 64 segments (−14…−20 bp at 32)
# against the converged 2-D ADI oracle — see
# tests/agreement/test_heston_barrier_pde.py.
_RICH_ALPHA = 0.75
_RICH_W = 2.0 ** _RICH_ALPHA / (2.0 ** _RICH_ALPHA - 1.0)


def _richardson_applies(dyn, steps: int) -> bool:
    """The extrapolation is gated to HestonDynamics: α = 0.75 was MEASURED
    against the Heston 2-D ADI oracle and is not transferable as-is — the
    rough-Bergomi within-segment bias exponent is Hurst-dependent (the
    variance clock has Hölder regularity H < ½, so the segment-law distortion
    need not scale like the Heston mix of √Δt and Δt), and no rBergomi
    barrier oracle exists to validate a weight against.  rBergomi barrier
    grids therefore use the plain (unextrapolated) bridge, whose bias is
    documented and refinement-monotone, rather than an unvalidated ~2.5×
    extrapolation weight that could overcorrect (ADVICE r4)."""
    return isinstance(dyn, HestonDynamics) and steps % 2 == 0 and steps >= 4


def _barrier_path_values(pay, factors, t_mids, payoff, market, discount):
    """Per-path barrier values from per-segment survival factors — shared by
    the single/double-barrier estimators and evaluated at BOTH resolutions
    of the √Δt Richardson pair on stochastic-vol grids."""
    from ..core.payoffs import KnockOut

    surv = jnp.prod(factors, axis=0)
    rebate = payoff.rebate
    if isinstance(payoff.knock, KnockOut):
        vals = pay * surv
        if payoff.rebate_at_hit:
            # P(first hit in segment k) = (Π_{j<k} f_j)·(1 − f_k); the rebate
            # leg discounts each hit at the segment MIDPOINT (O(dt) hit-time
            # resolution).  The common discount D(T) multiplies vals at the
            # end, so the leg is carried as d(t_mid)/D(T) per unit rebate.
            cum = jnp.cumprod(factors, axis=0)
            prev = jnp.concatenate([jnp.ones_like(factors[:1]), cum[:-1]], axis=0)
            first_hit = prev * (1.0 - factors)  # (steps, g, paths)
            d_mid = df_yf(market.rate, t_mids)  # (steps,)
            reb = jnp.sum(d_mid[:, None, None] * first_hit, axis=0)
            vals = vals + (rebate / discount) * reb
        else:
            vals = vals + rebate * (1.0 - surv)
    else:  # KnockIn: rebate pays at expiry iff never touched
        vals = pay * (1.0 - surv) + rebate * surv
    return vals


def _coarse_bridge_inputs(log_grid, seg_vars, T, steps: int):
    """Every-2nd-node view of the SAME simulated grid: the half-resolution
    estimator of the Richardson pair (coarse segment variance = the pair-sum
    of the fine segment variances, coarse midpoints at (k+½)·2Δt)."""
    sv = seg_vars.reshape((steps // 2, 2) + seg_vars.shape[1:]).sum(axis=1)
    t_mids = (jnp.arange(steps // 2) + 0.5) * (T / (steps // 2))
    return log_grid[::2], sv, t_mids


def _solve_barrier_mc(prob: PricingProblem, method: MonteCarlo):
    """Barrier-option Monte Carlo: simulate a grid, apply the per-segment
    Brownian-bridge crossing correction, pay the unconditional intrinsic at
    expiry.  Knock-in = intrinsic·(1 − survival) (in-out parity per path).

    Supported grids: LognormalDynamics × BlackScholesExact (ONE exact bridge
    over [0, T] — continuous-monitoring GBM barriers without discretization
    bias) or EulerMaruyama (also exact for GBM at any step count);
    HestonDynamics × HestonQE(conditional=True) or HestonExactMixing (the
    bridge grid carries the per-segment integrated variance the correction
    needs).

    Stochastic-vol grids carry an O(√Δt) within-segment bias the GBM grids
    don't: the bridge formula exp(−2ab/τ_seg) conditions only on (endpoints,
    τ_seg), but the ρ-correlated variance clock distorts the in-segment law
    (τ_seg high ↔ the DDS Brownian path mid-segment biased toward −ρ·up), so
    survival is overestimated.  Measured against the converged 2-D ADI
    barrier engine the bias is ≈ C/√steps (e.g. +102/+55/+41/+30 bp at
    16/32/64/128 segments, σ_v = 0.9 Feller-violating).  The estimator
    therefore applies a per-path **Richardson extrapolation**: the SAME
    simulated grid is re-bridged at every 2nd node (τ pair-summed) and the
    two per-path values combine with the 2^α/(2^α−1) weight (α = 0.75, the
    measured mixed √Δt+Δt bias exponent — see _RICH_ALPHA), landing the
    64-segment extrapolated price within ~2 bp of the converged ADI engine
    (tests/agreement/test_heston_barrier_pde.py).  Applied on HESTON grids
    with steps even ≥ 4 (plain bridge otherwise — in particular rBergomi,
    whose Hurst-dependent bias exponent the Heston-measured α does not
    cover; see :func:`_richardson_applies`); common paths keep the pair
    strongly correlated so the variance inflation is mild."""
    from ..core.payoffs import KnockOut, Up

    payoff = prob.payoff
    require_european(payoff, "MonteCarlo", spot_only=True)
    if jnp.ndim(payoff.strike) > 0 or jnp.ndim(payoff.barrier) > 0:
        raise TypeError(
            "barrier MC prices one (strike, barrier) pair per solve; vmap "
            "over contracts for grids"
        )
    market = prob.market_inputs
    dyn, strat, config = method.dynamics, method.strategy, method.config
    discount = df(market.rate, payoff.expiry)
    up = isinstance(payoff.direction, Up)
    log_b = jnp.log(payoff.barrier)
    _, T, _ = _sim_params(prob)

    if isinstance(dyn, LognormalDynamics) and isinstance(strat, BlackScholesExact):
        _require_no_dividend_schedule(
            market, "the one-bridge BlackScholesExact path estimator"
        )
        sigma = (
            market.sigma.sigma
            if isinstance(market.sigma, FlatVolSurface)
            else get_vol(market.sigma, payoff.expiry, market.spot)
        )
        samples = simulate_terminal_prices(prob, method)  # (g, paths)
        log_s0 = jnp.full_like(samples, jnp.log(market.spot))
        log_grid = jnp.stack([log_s0, jnp.log(samples)])  # (2, g, paths)
        factors = brownian_bridge_survival_factors(
            log_grid, sigma**2 * T, log_b, up
        )
        t_mids = jnp.asarray([0.5 * T])
        s_t = jnp.exp(log_grid[-1])
        coarse = None
    elif isinstance(dyn, (HestonDynamics, RoughBergomiDynamics)):
        spot_grid, seg_vars, _ = _bridge_log_grid(prob, method, "barrier")
        log_grid = jnp.log(spot_grid)
        factors = brownian_bridge_survival_factors(log_grid, seg_vars, log_b, up)
        t_mids = (jnp.arange(config.steps) + 0.5) * (T / config.steps)
        s_t = spot_grid[-1]
        coarse = None
        if _richardson_applies(dyn, config.steps):
            lg2, sv2, tm2 = _coarse_bridge_inputs(log_grid, seg_vars, T, config.steps)
            coarse = (
                brownian_bridge_survival_factors(lg2, sv2, log_b, up),
                tm2,
            )
    else:
        spot_grid, factors, t_mids, _, _ = barrier_grid_factors(prob, method)
        s_t = spot_grid[-1]
        coarse = None

    pay = payoff(s_t)  # unconditional terminal intrinsic, (g, paths)
    vals = _barrier_path_values(pay, factors, t_mids, payoff, market, discount)
    if coarse is not None:
        vals_2h = _barrier_path_values(pay, coarse[0], coarse[1], payoff, market, discount)
        vals = _RICH_W * vals - (_RICH_W - 1.0) * vals_2h
    price = discount * jnp.mean(vals, axis=(0, -1))
    return MonteCarloSolution(prob, method, price, vals)


def _solve_double_barrier_mc(prob: PricingProblem, method: MonteCarlo):
    """Double-barrier Monte Carlo: simulate a grid, apply the per-segment
    TWO-SIDED Brownian-bridge no-exit correction
    (:func:`double_bridge_survival_factors`), pay the unconditional
    intrinsic at expiry.  Knock-in = intrinsic·(1 − survival) per path.
    Exact for GBM grids at any step count (`BlackScholesExact` needs ONE
    bridge over [0, T]); the conditional Heston grid carries per-segment
    integrated variance.  Rebate legs mirror the single-barrier estimator:
    at expiry R·D·(1 − surv) (knock-out) / R·D·surv (knock-in), or at the
    hit time via the first-hit-segment distribution (the double one-touch —
    this is the route the closed form lacks)."""
    from ..core.payoffs import KnockOut, require_european

    payoff = prob.payoff
    require_european(payoff, "MonteCarlo", spot_only=True)
    if (jnp.ndim(payoff.strike) > 0 or jnp.ndim(payoff.lower) > 0
            or jnp.ndim(payoff.upper) > 0):
        raise TypeError(
            "double-barrier MC prices one (strike, lower, upper) triple per "
            "solve; vmap over contracts for grids"
        )
    market = prob.market_inputs
    dyn, strat, config = method.dynamics, method.strategy, method.config
    discount = df(market.rate, payoff.expiry)
    log_l = jnp.log(payoff.lower)
    log_u = jnp.log(payoff.upper)
    _, T, _ = _sim_params(prob)

    if isinstance(dyn, LognormalDynamics) and isinstance(strat, BlackScholesExact):
        _require_no_dividend_schedule(
            market, "the one-bridge BlackScholesExact path estimator"
        )
        sigma = (
            market.sigma.sigma
            if isinstance(market.sigma, FlatVolSurface)
            else get_vol(market.sigma, payoff.expiry, market.spot)
        )
        samples = simulate_terminal_prices(prob, method)  # (g, paths)
        log_s0 = jnp.full_like(samples, jnp.log(market.spot))
        log_grid = jnp.stack([log_s0, jnp.log(samples)])  # (2, g, paths)
        seg_vars = sigma**2 * T
        t_mids = jnp.asarray([0.5 * T])
    else:
        spot_grid, seg_vars, _ = _bridge_log_grid(prob, method, "barrier")
        log_grid = jnp.log(spot_grid)
        t_mids = (jnp.arange(config.steps) + 0.5) * (T / config.steps)

    factors = double_bridge_survival_factors(log_grid, seg_vars, log_l, log_u)
    s_t = jnp.exp(log_grid[-1])
    pay = payoff(s_t)  # unconditional terminal intrinsic, (g, paths)
    vals = _barrier_path_values(pay, factors, t_mids, payoff, market, discount)
    # √Δt Richardson pair on Heston grids (see _solve_barrier_mc)
    if _richardson_applies(dyn, config.steps):
        lg2, sv2, tm2 = _coarse_bridge_inputs(log_grid, seg_vars, T, config.steps)
        f2 = double_bridge_survival_factors(lg2, sv2, log_l, log_u)
        vals_2h = _barrier_path_values(pay, f2, tm2, payoff, market, discount)
        vals = _RICH_W * vals - (_RICH_W - 1.0) * vals_2h
    price = discount * jnp.mean(vals, axis=(0, -1))
    return MonteCarloSolution(prob, method, price, vals)


def _solve_lookback_mc(prob: PricingProblem, method: MonteCarlo):
    """Lookback Monte Carlo: simulate a grid, draw the per-segment
    Brownian-bridge extremum (:func:`brownian_bridge_extremum`), pay the
    contract on (S_T, realized extremum).  Continuous monitoring with NO
    discretization bias on GBM grids: gridpoint marginals AND segment
    extremum draws are both exact, so ``BlackScholesExact`` needs just ONE
    bridge over [0, T] and Euler grids are exact at any step count.  On the
    conditional Heston grid the segment variance is the grid's integrated
    variance (within-segment V stochasticity is the same O(dt)
    approximation the barrier estimator documents; refinement-consistency
    is tested).

    The extremum uniforms come from a dedicated fold of the path key, so
    they are independent of the grid draws under both PRNG and QMC configs
    (QMC's low-discrepancy structure covers the GRID dims; the extremum
    dims ride plain counter-based streams)."""
    from ..core.payoffs import require_european

    payoff = prob.payoff
    require_european(payoff, "MonteCarlo", spot_only=True)
    if jnp.ndim(payoff.strike) > 0:
        raise TypeError(
            "lookback MC prices one contract per solve; vmap over contracts "
            "for grids"
        )
    market = prob.market_inputs
    dyn, strat, config = method.dynamics, method.strategy, method.config
    discount = df(market.rate, payoff.expiry)
    maximum = payoff.uses_maximum
    _, T, _ = _sim_params(prob)
    anti = isinstance(config.variance_reduction, Antithetic)

    if isinstance(dyn, LognormalDynamics) and isinstance(strat, BlackScholesExact):
        _require_no_dividend_schedule(
            market, "the one-bridge BlackScholesExact path estimator"
        )
        sigma = (
            market.sigma.sigma
            if isinstance(market.sigma, FlatVolSurface)
            else get_vol(market.sigma, payoff.expiry, market.spot)
        )
        samples = simulate_terminal_prices(prob, method)  # (g, paths)
        log_s0 = jnp.full_like(samples, jnp.log(market.spot))
        log_grid = jnp.stack([log_s0, jnp.log(samples)])  # (2, g, paths)
        seg_vars = sigma**2 * T
    else:
        spot_grid, seg_vars, _ = _bridge_log_grid(prob, method, "lookback")
        log_grid = jnp.log(spot_grid)

    n_seg = log_grid.shape[0] - 1
    k_ext = jax.random.fold_in(_base_key(config, None), 0x6C6F6F6B)  # "look"
    u_b = jax.random.uniform(k_ext, (n_seg, config.trajectories), dtype=jnp.float64)
    # antithetic groups reflect the extremum uniforms with the grid draws;
    # clip keeps the reflected endpoint u=1 off log1p(−u)'s pole
    u = jnp.stack([u_b, 1.0 - u_b], axis=1) if anti else u_b[:, None]
    u = jnp.clip(u, 0.0, 1.0 - 1e-16)
    ext_log = brownian_bridge_extremum(log_grid, seg_vars, u, maximum)
    run = market.spot if payoff.running_extremum is None else payoff.running_extremum
    log_run = jnp.log(run)
    ext_log = jnp.maximum(ext_log, log_run) if maximum else jnp.minimum(ext_log, log_run)
    vals = payoff(jnp.exp(log_grid[-1]), jnp.exp(ext_log))  # (g, paths)
    price = discount * jnp.mean(vals, axis=(0, -1))
    return MonteCarloSolution(prob, method, price, vals)


def heston_variance_swap_strike(market, T):
    """Continuous-sampling Heston fair variance strike
    E[(1/T)∫₀ᵀ V dt] = θ + (V0 − θ)(1 − e^{−κT})/(κT) — the MC agreement
    oracle for discretely-sampled variance swaps (the discrete sum carries
    an O(dt) sampling correction the tests bound)."""
    kT = market.kappa * T
    return market.theta + (market.V0 - market.theta) * -jnp.expm1(-kT) / kT


def _solve_autocall_mc(prob: PricingProblem, method: MonteCarlo):
    """Autocallable Monte Carlo (snowball and phoenix conventions; see
    core/payoffs.py::Autocallable): simulate a grid under ANY grid
    dynamics, walk the observation schedule once (a static unrolled loop
    over ``periods`` — the call cascade and phoenix memory-coupon state are
    a handful of vectorized masks per date), and discount every leg at its
    own payment date.  ``ki_monitoring='continuous'`` applies the
    per-segment Brownian-bridge down-crossing probabilities (exact for GBM
    grids; integrated variance on the Heston conditional bridge), making
    the knock-in leg smooth; ``'observations'`` checks the n observation
    dates only (the bivariate-normal oracle convention); the default
    ``'auto'`` resolves to continuous where the grid carries bridge
    factors and observations everywhere else."""
    payoff = prob.payoff
    require_european(payoff, "MonteCarlo", spot_only=True)
    market = prob.market_inputs
    config = method.config
    n = payoff.periods
    if config.steps % n != 0:
        raise ValueError(
            f"autocallable MC needs config.steps to be a multiple of "
            f"periods so observation dates are grid points; got "
            f"steps={config.steps}, periods={n}"
        )
    m = config.steps // n
    T = market_yearfrac(market, payoff.expiry)
    s0 = market.spot

    monitoring = payoff.ki_monitoring
    if monitoring == "auto":
        # continuous bridge KI where the grid carries bridge factors
        # (GBM Euler, conditional Heston, rough Bergomi); observation-date
        # KI on every other grid (local vol, SLV, Merton, kernels, ...)
        monitoring = (
            "continuous" if _supports_bridge_grid(method) else "observations"
        )
    if monitoring == "continuous":
        spot_grid, seg_vars, _ = _bridge_log_grid(prob, method, "autocallable")
        factors = brownian_bridge_survival_factors(
            jnp.log(spot_grid), seg_vars,
            jnp.log(payoff.knock_in_barrier * s0), up=False,
        )
        surv = jnp.prod(factors, axis=0)  # (g, paths)
        obs = spot_grid[m::m]  # (n, g, paths)
    else:
        grid = simulate_price_grid(prob, method)  # (g, steps+1, paths)
        spot_grid = jnp.moveaxis(grid, 1, 0)
        obs = spot_grid[m::m]
        surv = jnp.all(obs >= payoff.knock_in_barrier * s0, axis=0).astype(
            spot_grid.dtype
        )

    t_obs = jnp.arange(1, n + 1) * (T / n)
    d_obs = df_yf(market.rate, t_obs)
    notional, c = payoff.notional, payoff.coupon
    b_ac = payoff.autocall_barrier * s0
    phoenix = payoff.coupon_barrier is not None

    alive = jnp.ones(obs.shape[1:], dtype=bool)
    disc_pay = jnp.zeros(obs.shape[1:])
    unpaid = jnp.zeros(obs.shape[1:])
    for i in range(n):
        s_i = obs[i]
        if phoenix:
            cpn_hit = alive & (s_i >= payoff.coupon_barrier * s0)
            disc_pay = disc_pay + jnp.where(
                cpn_hit, (unpaid + 1.0) * c * notional * d_obs[i], 0.0
            )
            unpaid = jnp.where(
                cpn_hit, 0.0, jnp.where(alive, unpaid + 1.0, unpaid)
            )
        call_hit = alive & (s_i >= b_ac)
        redemption = notional if phoenix else notional * (1.0 + (i + 1) * c)
        disc_pay = disc_pay + jnp.where(call_hit, redemption * d_obs[i], 0.0)
        alive = alive & ~call_hit

    s_terminal = spot_grid[-1]
    term_no_ki = notional if phoenix else notional * (1.0 + n * c)
    airbag = notional * jnp.minimum(s_terminal / s0, 1.0)
    disc_pay = disc_pay + jnp.where(
        alive, d_obs[-1] * (surv * term_no_ki + (1.0 - surv) * airbag), 0.0
    )
    price = jnp.mean(disc_pay, axis=(0, -1))
    return MonteCarloSolution(prob, method, price, disc_pay)


def _solve_cliquet_mc(prob: PricingProblem, method: MonteCarlo):
    """Cliquet Monte Carlo: simulate a grid under ANY grid dynamics, form
    the per-period simple returns S_i/S_{i-1} − 1 and pay the clipped sum
    at expiry (``config.steps`` must equal ``observations``)."""
    payoff = prob.payoff
    require_european(payoff, "MonteCarlo", spot_only=True)
    _require_no_dividend_schedule(
        prob.market_inputs, "cliquet returns (ex-date drops would enter "
        "the return legs; dividend treatment is a term-sheet convention)"
    )
    config = method.config
    if config.steps != payoff.observations:
        raise ValueError(
            f"cliquet MC needs config.steps == observations so grid times "
            f"are the reset dates; got steps={config.steps}, "
            f"observations={payoff.observations}"
        )
    market = prob.market_inputs
    discount = df(market.rate, payoff.expiry)
    grid = simulate_price_grid(prob, method)  # (g, steps+1, paths)
    rets = grid[:, 1:] / grid[:, :-1] - 1.0  # (g, steps, paths)
    vals = payoff(jnp.moveaxis(rets, 1, -1))  # periods last → (g, paths)
    price = discount * jnp.mean(vals, axis=(0, -1))
    return MonteCarloSolution(prob, method, price, vals)


def _solve_two_date_mc(prob: PricingProblem, method: MonteCarlo):
    """Compound/chooser Monte Carlo oracle: draw S_{t₁} from the EXACT
    lognormal law (curve forward, carry), close with the inner
    Black-Scholes value at the decision/choose date (the inner option is
    European vanilla — its t₁-value is the closed form, so the only MC
    dimension is the decision-date spot), discount at D(t₁).  Lognormal
    dynamics only: the estimator's closing step IS Black-Scholes."""
    from ..core.payoffs import CompoundOption
    from ..market.vol_surface import FlatVolSurface
    from .black_scholes import bs_price

    payoff = prob.payoff
    market = prob.market_inputs
    config = method.config
    if not isinstance(method.dynamics, LognormalDynamics):
        raise TypeError(
            "compound/chooser MC closes with the inner Black-Scholes value; "
            "use LognormalDynamics"
        )
    if not isinstance(market.sigma, FlatVolSurface):
        raise TypeError("compound/chooser MC needs a flat vol (one σ both legs)")
    sigma = market.sigma.sigma
    q = carry_yield(market)
    is_compound = isinstance(payoff, CompoundOption)
    t1_ticks = payoff.decision_date if is_compound else payoff.choose_date
    t1 = market_yearfrac(market, t1_ticks)
    T2 = market_yearfrac(market, payoff.expiry)
    D1 = df(market.rate, t1_ticks)
    D2 = df(market.rate, payoff.expiry)
    D12, tau = D2 / D1, T2 - t1

    key = _base_key(config, None)
    anti = isinstance(config.variance_reduction, Antithetic)
    if config.qmc:
        zb = _qmc_normals(key, 1, 1, config.trajectories)[0, 0]
        z = jnp.stack([zb, -zb]) if anti else zb[None]
    else:
        z = _normals(key, (config.trajectories,), anti)
    f1 = market.spot * jnp.exp(-q * t1) / D1  # exact t₁-forward
    s_t1 = f1 * jnp.exp(-0.5 * sigma**2 * t1 + sigma * jnp.sqrt(t1) * z)

    fwd_inner = s_t1 * jnp.exp(-q * tau) / D12
    if is_compound:
        inner = bs_price(fwd_inner, payoff.inner_strike, sigma, tau, D12,
                         payoff.inner_call_put())
        vals = payoff.decision_value(inner)
    else:
        call = bs_price(fwd_inner, payoff.strike, sigma, tau, D12, 1.0)
        put = bs_price(fwd_inner, payoff.strike, sigma, tau, D12, -1.0)
        vals = jnp.maximum(call, put)
    price = D1 * jnp.mean(vals)
    return MonteCarloSolution(prob, method, price, vals)


def _solve_forward_start_mc(prob: PricingProblem, method: MonteCarlo):
    """Forward-start Monte Carlo: simulate a grid under ANY grid dynamics,
    read the fixing S_{t_start} off the grid (``start`` must land exactly on
    a grid time) and pay max(cp·(S_T − k·S_fix), 0)."""
    payoff = prob.payoff
    require_european(payoff, "MonteCarlo", spot_only=True)
    market = prob.market_inputs
    _require_no_dividend_schedule(
        market, "forward-start strikes (k·S_fix across an ex-date is a "
        "term-sheet convention)"
    )
    config = method.config
    T = market_yearfrac(market, payoff.expiry)
    t1 = yearfrac(market.reference_date, payoff.start,
                  getattr(market, "daycount", None))
    try:
        frac = float(t1) / float(T) * config.steps
    except Exception as exc:
        raise TypeError(
            "forward-start MC needs concrete start/expiry dates to lay out "
            "the fixing grid"
        ) from exc
    idx = round(frac)
    if abs(frac - idx) > 1e-9 or not (0 < idx < config.steps):
        raise ValueError(
            f"forward-start MC needs the start date on the step grid: "
            f"t_start/T·steps = {frac:.6f} is not an interior integer — "
            f"choose config.steps as a multiple of T/(T − t_start) structure"
        )
    discount = df(market.rate, payoff.expiry)
    grid = simulate_price_grid(prob, method)  # (g, steps+1, paths)
    vals = payoff(grid[:, idx], grid[:, -1])
    price = discount * jnp.mean(vals, axis=(0, -1))
    return MonteCarloSolution(prob, method, price, vals)


def _solve_variance_swap_mc(prob: PricingProblem, method: MonteCarlo):
    """Variance-swap Monte Carlo: simulate a price grid under ANY grid
    dynamics (GBM, Heston Euler/QE incl. the conditional bridge grid, SABR,
    local vol), form the discrete realized variance
    RV = Σ ln(S_i/S_{i-1})²/T over the grid, pay notional·(RV − K_var).
    ``config.steps`` must equal ``observations`` so grid times are the
    fixing dates."""
    payoff = prob.payoff
    require_european(payoff, "MonteCarlo", spot_only=True)
    _require_no_dividend_schedule(
        prob.market_inputs, "realized-variance legs (standard variance "
        "swaps EXCLUDE ex-date drops from the return sum)"
    )
    config = method.config
    if config.steps != payoff.observations:
        raise ValueError(
            f"variance-swap MC needs config.steps == observations so grid "
            f"times are the fixing dates; got steps={config.steps}, "
            f"observations={payoff.observations}"
        )
    market = prob.market_inputs
    discount = df(market.rate, payoff.expiry)
    T = market_yearfrac(market, payoff.expiry)
    grid = simulate_price_grid(prob, method)  # (g, steps+1, paths)
    lr = jnp.diff(jnp.log(grid), axis=1)
    rv = jnp.sum(lr * lr, axis=1) / T  # (g, paths)
    vals = payoff(rv)
    price = discount * jnp.mean(vals, axis=(0, -1))
    return MonteCarloSolution(prob, method, price, vals)


def _solve_asian_mc(prob: PricingProblem, method: MonteCarlo):
    """Asian-option Monte Carlo: simulate the price grid under any grid
    strategy, average the n fixings S_{t_1..t_n} = grid[1:], pay the vanilla
    intrinsic of the average.  ``config.steps`` must equal the payoff's
    ``observations`` so the grid times ARE the fixing dates.  Geometric
    averages under GBM have the exact closed form as the agreement oracle
    (black_scholes.bs_geometric_asian_price)."""
    from ..core.payoffs import GeometricAverage

    payoff = prob.payoff
    require_european(payoff, "MonteCarlo", spot_only=True)
    config = method.config
    if config.steps != payoff.observations:
        raise ValueError(
            f"Asian MC needs config.steps == observations so grid times are "
            f"the fixing dates; got steps={config.steps}, "
            f"observations={payoff.observations}"
        )
    if jnp.ndim(payoff.strike) > 0:
        raise TypeError("Asian MC prices one strike per solve; vmap for grids")
    discount = df(prob.market_inputs.rate, payoff.expiry)
    if isinstance(payoff.averaging, GeometricAverage) and isinstance(
        method.dynamics, NormalDynamics
    ):
        raise TypeError(
            "geometric averaging is undefined under NormalDynamics "
            "(Bachelier paths can go negative); use ArithmeticAverage"
        )
    grid = simulate_price_grid(prob, method)  # (g, steps+1, paths)
    obs = grid[:, 1:, :]
    if isinstance(payoff.averaging, GeometricAverage):
        avg = jnp.exp(jnp.mean(jnp.log(obs), axis=1))
    else:
        avg = jnp.mean(obs, axis=1)
    vals = payoff(avg)
    price = discount * jnp.mean(vals, axis=(0, -1))
    return MonteCarloSolution(prob, method, price, vals)


def conditional_payoff_close(payoff, f_eff, iv_var):
    """Per-path conditional expectation of ``payoff(S_T)`` given a lognormal
    terminal law with forward ``f_eff`` and log-variance ``iv_var`` — the
    closed-form close shared by the mixing estimators and the LSM
    Rao-Blackwell terminal target.  Vanillas get the conditional
    Black-Scholes formula; digitals the smooth cash·Φ(cp·d2) (pathwise AD
    greeks survive — the raw terminal-sample estimator differentiates an
    indicator to zero)."""
    from ..core.payoffs import (
        AsianOption,
        BarrierOption,
        DigitalOption,
        DoubleBarrierOption,
        LookbackOption,
    )

    if isinstance(payoff, (BarrierOption, AsianOption, DoubleBarrierOption,
                           LookbackOption)):
        raise TypeError(
            f"the conditional close integrates S_T out analytically and "
            f"cannot see the path; {type(payoff).__name__} prices through "
            f"solve(...) (the grid estimators)"
        )
    var = jnp.maximum(iv_var, 1e-18)
    sd = jnp.sqrt(var)
    cp = payoff.call_put()
    strike = jnp.asarray(payoff.strike)
    if strike.ndim > 0:
        f_eff, sd, var = f_eff[..., None, :], sd[..., None, :], var[..., None, :]
        strike = strike[None, :, None]
    d2 = (jnp.log(f_eff / strike) - 0.5 * var) / sd
    ncdf = jax.scipy.stats.norm.cdf
    if isinstance(payoff, DigitalOption):
        return payoff.cash * ncdf(cp * d2)
    d1 = d2 + sd
    return cp * (f_eff * ncdf(cp * d1) - strike * ncdf(cp * d2))


def _conditional_bs_close(prob, market, T, r0, iv, j):
    """Close (IV, J) mixing factors with the conditional closed form:
    per-path UNDISCOUNTED values, (g, paths) or, for an array-strike payoff,
    (g, m, paths) — ONE simulated variance-path set prices every strike (the
    conditional value is closed-form in K, the same instrument-parallel
    idiom as the Carr-Madan strike grid)."""
    rho = market.rho
    f_eff = market.spot * jnp.exp(r0 * T + rho * j - 0.5 * rho**2 * iv)
    return conditional_payoff_close(prob.payoff, f_eff, (1.0 - rho**2) * iv)


def _heston_exact_mixing_values(prob, config, key, point_offset=0, with_score=False):
    """Per-path UNDISCOUNTED conditional vanilla values (n_groups, paths)
    from the exact-transition segmented mixing scheme (HestonExactMixing;
    numerics in models/heston_exact.py).

    Draw layout per segment: (u_poisson, z_gamma, u_boost, z_iv) — QMC dims
    step-major 4·i … 4·i+3, the two z's from ndtri.  Antithetic mirror:
    negated normals, 1−u uniforms.

    ``with_score=True`` additionally returns the per-path frozen-count
    Poisson log-likelihood (the likelihood-ratio term unbiased greeks need;
    see mixing_greeks.heston_exact_price_and_greeks)."""
    from ..models.heston_exact import (
        cir_exact_constants,
        cir_exact_step_score,
        iv_cond_moments,
        iv_gamma_draw,
        poisson_kmax,
    )

    market, T, r0 = _sim_params(prob)
    segments = config.steps
    dt = T / segments
    paths = config.trajectories
    c = cir_exact_constants(market.kappa, market.theta, market.sigma, dt)
    # raises for markets whose Poisson-mixture count cannot be truncated
    # safely (very low vol-of-vol); returns the fixed default when traced
    kmax = poisson_kmax(market.kappa, market.theta, market.sigma, dt, market.V0)
    anti = isinstance(config.variance_reduction, Antithetic)
    base = _base_key(config, key)
    if config.qmc:
        from jax.scipy.special import ndtri

        from ..math.sobol import sobol_uniforms

        u = sobol_uniforms(base, paths, segments * 4, skip=point_offset)
        u = jnp.moveaxis(u.reshape(paths, segments, 4), 0, -1)  # (seg, 4, paths)
        u_pois, u_gam, u_boost, u_iv = u[:, 0], u[:, 1], u[:, 2], u[:, 3]
        z_gam, z_iv = ndtri(u_gam), ndtri(u_iv)
    else:
        k_z, k_u = jax.random.split(base)
        zb = jax.random.normal(k_z, (segments, 2, paths), dtype=jnp.float64)
        ub = jax.random.uniform(k_u, (segments, 2, paths), dtype=jnp.float64)
        z_gam, z_iv = zb[:, 0], zb[:, 1]
        u_pois, u_boost = ub[:, 0], ub[:, 1]

    def groups(x, is_uniform):
        if not anti:
            return x[:, None]
        return jnp.stack([x, 1.0 - x if is_uniform else -x], axis=1)

    z_gam, z_iv = groups(z_gam, False), groups(z_iv, False)
    u_pois, u_boost = groups(u_pois, True), groups(u_boost, True)

    n_groups = z_gam.shape[1]
    v = jnp.full((n_groups, paths), market.V0)
    iv = jnp.zeros_like(v)
    logl = jnp.zeros_like(v)

    # Plain reverse AD (no jax.checkpoint on the segment body): the
    # special-function chain (fixed-trip Poisson inversion, Bessel-ratio
    # continued fraction, saddlepoint gamma quantile) is compute-heavy, so
    # recomputing it in the backward pass is expected to cost more than
    # keeping its residuals.  Not measured on the H100.
    for i in range(segments):  # static unroll: segments is 1-4 in practice
        y, ll = cir_exact_step_score(v, u_pois[i], z_gam[i], u_boost[i], c, kmax)
        logl = logl + ll  # dead code under with_score=False (XLA DCE)
        m1, s2 = iv_cond_moments(v, y, c)
        iv = iv + iv_gamma_draw(m1, s2, z_iv[i])
        v = y

    kappa, sigma = market.kappa, market.sigma
    j = (v - market.V0 - kappa * market.theta * T + kappa * iv) / sigma
    vals = _conditional_bs_close(prob, market, T, r0, iv, j)
    if with_score:
        return vals, logl
    # Likelihood-ratio surrogate baked into the per-path values: primal
    # unchanged (L − sg(L) is 0), but jax.grad through solve picks up the
    # Poisson score term that plain pathwise AD misses (the exact
    # transition's count is a step function of the parameters) — so
    # differentiate-through-solve is unbiased for this estimator too.
    if vals.ndim == 3:  # strike-grid payoff: (g, m, P)
        b = jax.lax.stop_gradient(jnp.mean(vals, axis=(0, -1)))[None, :, None]
        ll = logl[:, None, :]
    else:
        b = jax.lax.stop_gradient(jnp.mean(vals))
        ll = logl
    return vals + jax.lax.stop_gradient(vals - b) * (
        ll - jax.lax.stop_gradient(ll)
    )


def _hhw_mixing_values(prob, config, key, point_offset=0):
    """Per-path conditional vanilla values for the Heston-Hull-White hybrid
    (HestonHullWhiteDynamics × HestonQE(conditional=True)): shape
    (n_groups, paths), scaled so that `price = df_curve(T) · mean(values)`
    — i.e. each value carries its own pathwise stochastic discount relative
    to the curve df.

    Three-factor conditioning (W_v ⊥ W_r): given the QE variance path and
    the exact-OU rate path, logS_T is normal —

        logS_T | (V, x) = logS₀ + ∫r − qT − ½IV + ρ_sv·J_v + ρ_sr·J_r
                          + √((1−ρ_sv²−ρ_sr²)·IV)·Z⊥,

    with J_v from the CIR integral identity (trapezoid IV) and
    J_r = Σ√V_k·ΔW_r,k from the jointly-exact per-step rate block
    (shock, ΔW_r, ∫x residual) drawn through a closed-form 3×3 Cholesky.
    The pathwise discount exp(−∫r) = P(0,T)·exp(−∫x − ½σ_r²Γ(T)) is
    exactly unbiased (the Hull-White martingale identity), so the hybrid's
    forward is the curve forward at any step count."""
    from ..models.heston_qe import qe_constants, qe_v_step
    from ..models.hull_white import hw_b, hw_gamma

    if config.qmc:
        raise ValueError(
            "qmc=True is not wired into the Heston-Hull-White mixing "
            "estimator yet (5 draws/step); use the PRNG stream"
        )
    market = prob.market_inputs
    T = market_yearfrac(market, prob.payoff.expiry)
    q = carry_yield(market)
    steps, paths = config.steps, config.trajectories
    dt = T / steps
    kappa, sig_v, rho_sv = market.kappa, market.sigma, market.rho_sv
    a, sig_r, rho_sr = market.a, market.sigma_r, market.rho_sr

    # QE variance constants (the drift argument only feeds the X-step
    # block, which the conditional estimator never uses)
    c_qe = qe_constants(kappa, market.theta, sig_v, rho_sv, 0.0, dt)
    ktd = kappa * market.theta * dt

    # bivariate rate block per step: (shock = ∫e^{−a(Δ−u)}dW, ΔW_r); the
    # third quantity the ∫x increment needs, w = ∫B(Δ−u)dW, is EXACTLY
    # (ΔW − shock)/a — a linear identity, not a draw (the naive trivariate
    # covariance is rank-2/singular)
    e1 = jnp.exp(-a * dt)
    b_d = hw_b(a, dt)
    vs = (1.0 - e1 * e1) / (2.0 * a)
    s_sh = jnp.sqrt(vs)
    c21 = b_d / s_sh
    s_dw = jnp.sqrt(jnp.maximum(dt - c21**2, 1e-30))

    anti = isinstance(config.variance_reduction, Antithetic)
    base = _base_key(config, key)
    k_z, k_u = jax.random.split(base)
    z = _normals(k_z, (steps, 3, paths), anti)  # (g, steps, 3, paths)
    u = jax.random.uniform(k_u, (steps, paths), dtype=jnp.float64)
    us = jnp.stack([u, 1.0 - u]) if anti else u[None]
    n_groups = z.shape[0]

    v0 = jnp.full((n_groups, paths), market.V0)
    x0 = jnp.zeros_like(v0)
    zero = jnp.zeros_like(v0)

    def step(carry, inp):
        v, x, integ, iv, jr = carry
        zk, uk = inp  # zk: (g, 3, paths)
        z_v, z_a, z_b = zk[:, 0], zk[:, 1], zk[:, 2]
        shock = s_sh * z_a
        dwr = c21 * z_a + s_dw * z_b
        w = (dwr - shock) / a  # exact linear identity (see above)
        # double-where: QE's exponential branch reaches v == 0 exactly and
        # d(sqrt)/dv there would poison the whole gradient with NaN
        v_pos = v > 0.0
        sqrt_v = jnp.where(v_pos, jnp.sqrt(jnp.where(v_pos, v, 1.0)), 0.0)
        jr = jr + sqrt_v * dwr  # left-point V
        integ = integ + x * b_d + sig_r * w
        x = x * e1 + sig_r * shock
        v_new = qe_v_step(v, z_v, uk, c_qe)
        iv = iv + 0.5 * dt * (v + v_new)
        return (v_new, x, integ, iv, jr), None

    zs = jnp.moveaxis(z, 1, 0)  # (steps, g, 4, paths)
    us_s = jnp.moveaxis(us, 1, 0)
    (v_T, _, integ, iv, jr), _ = jax.lax.scan(
        jax.checkpoint(step), (v0, x0, zero, zero, zero), (zs, us_s)
    )

    j_v = (v_T - market.V0 - ktd * steps + kappa * iv) / sig_v
    gamma_t = hw_gamma(a, T)
    ln_p0t = jnp.log(df_yf(market.rate, T))
    int_r = integ - ln_p0t + 0.5 * sig_r**2 * gamma_t
    rho2 = rho_sv**2 + rho_sr**2
    f_eff = market.spot * jnp.exp(
        int_r - q * T + rho_sv * j_v + rho_sr * jr - 0.5 * rho2 * iv
    )
    vals = conditional_payoff_close(prob.payoff, f_eff, (1.0 - rho2) * iv)
    # pathwise stochastic discount relative to the curve df the facade
    # multiplies: D_path/P(0,T) = exp(−∫x − ½σ_r²Γ)
    disc = jnp.exp(-integ - 0.5 * sig_r**2 * gamma_t)
    return vals * (disc[:, None, :] if vals.ndim == 3 else disc)


def heston_surface_mc(
    market, expiries, strikes, config: "SimulationConfig", cp=1.0,
    key=None, point_offset=0, strategy=None,
):
    """Price a whole (expiry × strike) European vanilla surface from ONE
    conditional-MC variance-path simulation: (n_expiries, n_strikes)
    DISCOUNTED prices.

    The V path runs once to the last expiry; at each expiry the accumulated
    (∫V, ∫√V dW) factors close every strike with the conditional
    Black-Scholes formula (Romano-Touzi, see _heston_qe_mixing_values).
    All surface points share paths, so smile/term-structure SHAPES carry far
    less noise than independent runs — and the whole surface is one
    differentiable XLA program, the natural objective for full-surface
    Heston calibration through the MC pricer.

    ``config.steps`` is the step budget for the full horizon; segments
    between expiries get steps proportional to their length (min 1), so the
    bias matches a single-expiry run at the same steps-per-year.
    ``expiries``: dates/ticks, strictly increasing.  ``cp``: +1 call / −1
    put (scalar, applies to the whole surface).

    ``strategy=HestonExactMixing()`` swaps the QE variance path for the
    exact-transition segmented scheme (sub-bp bias at ~2 segments/year —
    ``config.steps`` then counts exact segments, so a far smaller budget
    prices the surface more accurately; the first gap is floored at 2
    segments because the 2-moment ∫V family needs every expiry ≥2
    cumulative segments deep, ADR-008 addendum 3).  ``None`` (default) or
    ``HestonQE(conditional=True)`` = the QE mixing path.
    """
    n_exp = len(expiries)
    T_host = validate_surface_expiries(market, expiries)
    strikes = jnp.asarray(strikes)
    rows_fn = (
        _exact_surface_rows
        if isinstance(strategy, HestonExactMixing)
        else _mixing_surface_rows
    )
    rows = rows_fn(
        market, T_host, [strikes] * n_exp, [cp] * n_exp, config,
        key=key, point_offset=point_offset,
    )
    return jnp.stack(rows)


def rbergomi_surface_mc(
    market, expiries, strikes, config: "SimulationConfig", cp=1.0,
    key=None, point_offset=0, quad_nodes: int = 64, fp32: bool = False,
):
    """Price a whole (expiry × strike) European vanilla surface from ONE
    exact-Volterra rough Bergomi simulation: (n_expiries, n_strikes)
    DISCOUNTED prices — the rough-vol counterpart of
    :func:`heston_surface_mc` and the natural objective for (ξ₀, η, H, ρ)
    smile calibration (one differentiable XLA program; all points share
    paths, so smile/term-structure SHAPES carry far less noise).

    The joint-Gaussian grid is laid out on a NON-uniform time grid that
    contains every expiry (per-gap substeps proportional to length,
    ``config.steps`` total — the same allocation rule as the Heston
    surface); the cumulative (∫V, ∫√V dW₁) carries close every strike at
    each expiry index.  ``fp32`` as on :class:`RoughBergomiMixing`."""
    from ..models.rough_bergomi import rbergomi_variance, volterra_cov

    T_host = validate_surface_expiries(market, expiries)
    seg_len, seg_steps = surface_seg_steps(T_host, config.steps)
    times, exp_idx = [], []
    prev = 0.0
    for length, m_i, T_i in zip(seg_len, seg_steps, T_host):
        times += [prev + (k + 1) * length / m_i for k in range(m_i)]
        times[-1] = T_i  # exact endpoint (kill accumulated float error)
        exp_idx.append(len(times) - 1)
        prev = T_i
    t = jnp.asarray(times)
    n = len(times)

    cov = volterra_cov(market.hurst, t, quad_nodes=quad_nodes)
    jitter = 1e-12 * jnp.max(jnp.diag(cov))
    chol = jnp.linalg.cholesky(cov + jitter * jnp.eye(2 * n, dtype=cov.dtype))
    dtype = jnp.float32 if fp32 else jnp.float64
    chol = chol.astype(dtype)

    paths = config.trajectories
    anti = isinstance(config.variance_reduction, Antithetic)
    base = _base_key(config, key)
    if config.qmc:
        from jax.scipy.special import ndtri

        from ..math.sobol import sobol_uniforms

        u = sobol_uniforms(base, paths, 2 * n, skip=point_offset)
        xi = ndtri(u).T.astype(dtype)
    else:
        xi = jax.random.normal(base, (2 * n, paths), dtype=dtype)
    xi = jnp.stack([xi, -xi]) if anti else xi[None]
    # HIGHEST: an f32 matmul would otherwise run in TF32 on the GPU
    x = jnp.einsum("ij,gjp->gip", chol, xi, precision=jax.lax.Precision.HIGHEST)
    dw, z = x[:, :n], x[:, n:]

    t_left = jnp.concatenate([jnp.zeros((1,), t.dtype), t[:-1]])
    z_left = jnp.concatenate([jnp.zeros_like(z[:, :1]), z[:, :-1]], axis=1)
    v = rbergomi_variance(market, z_left, t_left[None, :, None])
    dt_k = (t - t_left).astype(dtype)
    cum_iv = jnp.cumsum(v * dt_k[None, :, None], axis=1)
    cum_j = jnp.cumsum(jnp.sqrt(v) * dw, axis=1)

    r0 = zero_rate_yf(market.rate, 0.0) - carry_yield(market)
    strikes = jnp.asarray(strikes)
    rows = [
        _surface_close_row(
            market, T_host[i], r0,
            cum_iv[:, exp_idx[i]].astype(jnp.float64),
            cum_j[:, exp_idx[i]].astype(jnp.float64),
            strikes, cp,
        )
        for i in range(len(T_host))
    ]
    return jnp.stack(rows)


def surface_seg_steps(T_host, steps: int, min_first: int = 1):
    """Static per-segment step allocation of the surface estimators (the
    ONE place the rounding rule lives): proportional to segment length,
    min 1/segment.

    ``min_first`` floors the FIRST gap's count: the exact-mixing scheme's
    2-moment ∫V gamma family needs ≥2 cumulative segments at every expiry
    (one segment leaves bp-level family bias — measured −4bp on a
    short-dated OTM point, ADR-008; every later expiry is automatically
    deeper), so the exact-surface callers pass ``min_first=2``."""
    T_total = T_host[-1]
    seg_len = [T_host[0]] + [T_host[i + 1] - T_host[i] for i in range(len(T_host) - 1)]
    counts = [max(1, round(steps * s / T_total)) for s in seg_len]
    counts[0] = max(counts[0], min_first)
    return seg_len, counts


def validate_surface_expiries(market, expiries):
    """Host-static expiry year-fractions with the surface contract checks
    (concrete reference date, strictly increasing, after the reference)."""
    if len(expiries) == 0:
        raise ValueError("need at least one expiry")
    try:
        T_host = [float(market_yearfrac(market, e)) for e in expiries]
    except jax.errors.ConcretizationTypeError as exc:
        raise TypeError(
            "surface pricing needs a concrete reference date to lay out the "
            "expiry/step grid; don't pass the market (or its reference_date) "
            "as a traced jit argument — close over it or mark it static"
        ) from exc
    increasing = all(T_host[i] < T_host[i + 1] for i in range(len(T_host) - 1))
    if not increasing or T_host[0] <= 0.0:
        raise ValueError(
            "expiries must be strictly increasing and after the reference "
            f"date; got year-fractions {T_host}"
        )
    return T_host


def _mixing_surface_rows(
    market, T_host, per_exp_strikes, per_exp_cp, config, key=None, point_offset=0
):
    """Core of the one-simulation surface: ONE variance path through
    per-expiry segments; at expiry i the (∫V, ∫√V dW) carries close the
    (possibly ragged) strike array ``per_exp_strikes[i]`` with per-point
    call/put signs ``per_exp_cp[i]``.  Returns a list of per-expiry
    DISCOUNTED price rows (shapes (m_i,)).  ``T_host``: host floats,
    strictly increasing."""
    from ..models.heston_qe import qe_constants, qe_v_step

    n_exp = len(T_host)
    r0 = zero_rate_yf(market.rate, 0.0) - carry_yield(market)

    seg_len, seg_steps = surface_seg_steps(T_host, config.steps)
    total_steps = sum(seg_steps)

    anti = isinstance(config.variance_reduction, Antithetic)
    base = _base_key(config, key)
    if config.qmc:
        zb, ub = _qmc_normals_and_uniforms(
            base, total_steps, 1, config.trajectories, skip=point_offset
        )
        zb = zb[:, 0, :]
        z = jnp.stack([zb, -zb]) if anti else zb[None]
        us = jnp.stack([ub, 1.0 - ub]) if anti else ub[None]
    else:
        k_z, k_u = jax.random.split(base)
        z = _normals(k_z, (total_steps, config.trajectories), anti)
        u = jax.random.uniform(k_u, (total_steps, config.trajectories), dtype=jnp.float64)
        us = jnp.stack([u, 1.0 - u]) if anti else u[None]
    n_groups = z.shape[0]

    kappa, sigma, rho = market.kappa, market.sigma, market.rho
    v = jnp.full((n_groups, config.trajectories), market.V0)
    iv = jnp.zeros_like(v)
    j = jnp.zeros_like(v)

    rows = []
    offset = 0
    for i in range(n_exp):
        dt_i = seg_len[i] / seg_steps[i]
        c = qe_constants(kappa, market.theta, sigma, rho, r0, dt_i)
        ktd = kappa * market.theta * dt_i

        def step(carry, inp, c=c, ktd=ktd, dt_i=dt_i):
            v, iv, j = carry
            zk, uk = inp
            v_new = qe_v_step(v, zk, uk, c)
            iv_step = 0.5 * dt_i * (v + v_new)
            j_new = j + (v_new - v - ktd + kappa * iv_step) / sigma
            return (v_new, iv + iv_step, j_new), None

        zs = jnp.moveaxis(z[:, offset : offset + seg_steps[i]], 1, 0)
        us_s = jnp.moveaxis(us[:, offset : offset + seg_steps[i]], 1, 0)
        offset += seg_steps[i]
        (v, iv, j), _ = jax.lax.scan(jax.checkpoint(step), (v, iv, j), (zs, us_s))

        rows.append(_surface_close_row(
            market, T_host[i], r0, iv, j, per_exp_strikes[i], per_exp_cp[i]
        ))
    return rows


def _surface_close_row(market, T_i, r0, iv, j, strikes_i, cp_i, score_logl=None):
    """Close one expiry's (∫V, ∫√V dW) snapshot against its strike row with
    the conditional BS formula → DISCOUNTED mean prices (m_i,).  Shared by
    the QE and exact-transition surface cores.

    ``score_logl`` (shape (g, P)): the frozen-count Poisson log-likelihood
    accumulated UP TO this expiry.  When given, each point's mean becomes
    the likelihood-ratio surrogate mean(vals + sg(vals − b)·(L − sg(L)))
    (b = per-point batch mean) — primal unchanged, gradient unbiased under
    the exact-transition scheme (see mixing_greeks.heston_exact_price_and_greeks)."""
    rho = market.rho
    ncdf = jax.scipy.stats.norm.cdf
    f_eff = market.spot * jnp.exp(r0 * T_i + rho * j - 0.5 * rho**2 * iv)
    var = jnp.maximum((1.0 - rho**2) * iv, 1e-18)
    sd = jnp.sqrt(var)
    f_b, sd_b, var_b = f_eff[:, None, :], sd[:, None, :], var[:, None, :]
    k_b = jnp.asarray(strikes_i)[None, :, None]
    cp_b = jnp.asarray(cp_i)
    if cp_b.ndim > 0:
        cp_b = cp_b[None, :, None]  # per-point call/put signs
    d1 = (jnp.log(f_b / k_b) + 0.5 * var_b) / sd_b
    d2 = d1 - sd_b
    vals = cp_b * (f_b * ncdf(cp_b * d1) - k_b * ncdf(cp_b * d2))
    if score_logl is not None:
        b = jax.lax.stop_gradient(jnp.mean(vals, axis=(0, -1)))
        ll = score_logl[:, None, :]
        vals = vals + jax.lax.stop_gradient(vals - b[None, :, None]) * (
            ll - jax.lax.stop_gradient(ll)
        )
    return df_yf(market.rate, T_i) * jnp.mean(vals, axis=(0, -1))


def _exact_surface_rows(
    market, T_host, per_exp_strikes, per_exp_cp, config, key=None, point_offset=0
):
    """Exact-transition core of the one-simulation surface: per expiry
    segment the EXACT CIR transition + conditional ∫V draw (the
    HestonExactMixing scheme, models/heston_exact.py), J accumulated through
    the per-segment CIR integral identity, (∫V, ∫√V dW) snapshotted at each
    expiry.  Sub-bp scheme bias at segment lengths ≲ 0.5y, so
    ``config.steps`` (total segment budget, allocated proportionally by
    :func:`surface_seg_steps`) can be ~5× smaller than the QE surface's for
    better accuracy.  Draw layout is 4 dims/segment step-major — a
    single-expiry surface with the same seed reproduces the
    HestonExactMixing solve exactly.

    Gradients: the rows are closed through the likelihood-ratio surrogate
    (``_surface_close_row`` with ``score_logl``), so ``jax.grad`` of any
    point w.r.t. the Heston parameters is unbiased — plain pathwise AD
    through the exact transitions would not be (the Poisson count is a step
    function of the parameters).  The primal is unaffected."""
    from ..models.heston_exact import (
        cir_exact_constants,
        cir_exact_step_score,
        iv_cond_moments,
        iv_gamma_draw,
        poisson_kmax,
    )

    n_exp = len(T_host)
    r0 = zero_rate_yf(market.rate, 0.0) - carry_yield(market)
    seg_len, seg_steps = surface_seg_steps(T_host, config.steps, min_first=2)
    total_segs = sum(seg_steps)
    paths = config.trajectories

    anti = isinstance(config.variance_reduction, Antithetic)
    base = _base_key(config, key)
    if config.qmc:
        from jax.scipy.special import ndtri

        from ..math.sobol import sobol_uniforms

        u = sobol_uniforms(base, paths, total_segs * 4, skip=point_offset)
        u = jnp.moveaxis(u.reshape(paths, total_segs, 4), 0, -1)  # (seg, 4, P)
        u_pois, u_gam, u_boost, u_iv = u[:, 0], u[:, 1], u[:, 2], u[:, 3]
        z_gam, z_iv = ndtri(u_gam), ndtri(u_iv)
    else:
        k_z, k_u = jax.random.split(base)
        zb = jax.random.normal(k_z, (total_segs, 2, paths), dtype=jnp.float64)
        ub = jax.random.uniform(k_u, (total_segs, 2, paths), dtype=jnp.float64)
        z_gam, z_iv = zb[:, 0], zb[:, 1]
        u_pois, u_boost = ub[:, 0], ub[:, 1]

    def groups(x, is_uniform):
        if not anti:
            return x[:, None]
        return jnp.stack([x, 1.0 - x if is_uniform else -x], axis=1)

    z_gam, z_iv = groups(z_gam, False), groups(z_iv, False)
    u_pois, u_boost = groups(u_pois, True), groups(u_boost, True)

    kappa, sigma = market.kappa, market.sigma
    n_groups = z_gam.shape[1]
    v = jnp.full((n_groups, paths), market.V0)
    iv = jnp.zeros_like(v)
    j = jnp.zeros_like(v)
    logl = jnp.zeros_like(v)

    rows = []
    offset = 0
    for i in range(n_exp):
        dt_i = seg_len[i] / seg_steps[i]
        c = cir_exact_constants(kappa, market.theta, sigma, dt_i)
        kmax = poisson_kmax(kappa, market.theta, sigma, dt_i, market.V0)
        ktd = kappa * market.theta * dt_i
        for s in range(seg_steps[i]):  # static unroll; a handful of segments
            k = offset + s
            y, ll = cir_exact_step_score(v, u_pois[k], z_gam[k], u_boost[k], c, kmax)
            logl = logl + ll
            m1, s2 = iv_cond_moments(v, y, c)
            iv_seg = iv_gamma_draw(m1, s2, z_iv[k])
            iv = iv + iv_seg
            j = j + (y - v - ktd + kappa * iv_seg) / sigma
            v = y
        offset += seg_steps[i]
        rows.append(_surface_close_row(
            market, T_host[i], r0, iv, j, per_exp_strikes[i], per_exp_cp[i],
            score_logl=logl,
        ))
    return rows


def simulate_conditional_grid(prob, config, key=None, point_offset=0):
    """(S, V) price/variance grids from the conditional lognormal bridge —
    the grid companion of the mixing estimator, for grid methods (LSM).

    Only the variance path is QE-simulated; S at step boundaries is drawn
    from its EXACT conditional law given the V segment (trapezoid-IV proxy):
    with W_s = ρ·W_v + √(1−ρ²)·W_⊥ and the per-segment CIR integral identity
    J_k = (V_{k+1} − V_k − κθΔ + κ·IV_k)/σ,

        logS_{k+1} = logS_k + rΔ − IV_k/2 + ρ·J_k + √((1−ρ²)·IV_k)·Z_⊥,

    i.e. ONE extra normal per step (a full QE step needs a second normal
    PLUS the martingale-correction logs).  Returns (S_grid, V_grid) each of
    shape (n_groups, steps+1, paths) — V is part of Heston's Markov state,
    so LSM regresses on both (methods/lsm.py joint basis).
    """
    from ..models.heston_qe import qe_constants, qe_v_step

    market, T, r0 = _sim_params(prob)
    steps = config.steps
    dt = T / steps
    kappa, sigma, rho = market.kappa, market.sigma, market.rho
    c = qe_constants(kappa, market.theta, sigma, rho, r0, dt)
    ktd = kappa * market.theta * dt
    rho_bar2 = 1.0 - rho**2
    anti = isinstance(config.variance_reduction, Antithetic)
    base = _base_key(config, key)
    if config.qmc:
        # same (2 normals + 1 uniform)/step Sobol' layout as the QE grid path
        zb, ub = _qmc_normals_and_uniforms(base, steps, 2, config.trajectories, skip=point_offset)
        z = jnp.stack([zb, -zb]) if anti else zb[None]
        us = jnp.stack([ub, 1.0 - ub]) if anti else ub[None]
    else:
        k_z, k_u = jax.random.split(base)
        z = _normals(k_z, (steps, 2, config.trajectories), anti)
        u = jax.random.uniform(k_u, (steps, config.trajectories), dtype=jnp.float64)
        us = jnp.stack([u, 1.0 - u]) if anti else u[None]
    n_groups = z.shape[0]

    x0 = jnp.full((n_groups, config.trajectories), jnp.log(market.spot))
    v0 = jnp.full((n_groups, config.trajectories), market.V0)

    def step(carry, inp):
        x, v = carry
        zk, uk = inp
        z_v, z_perp = zk[:, 0, :], zk[:, 1, :]
        v_new = qe_v_step(v, z_v, uk, c)
        iv = 0.5 * dt * (v + v_new)
        j = (v_new - v - ktd + kappa * iv) / sigma
        x_new = x + r0 * dt - 0.5 * iv + rho * j + jnp.sqrt(
            jnp.maximum(rho_bar2 * iv, 1e-18)
        ) * z_perp
        return (x_new, v_new), (x_new, v_new)

    zs = jnp.moveaxis(z, 1, 0)
    us_s = jnp.moveaxis(us, 1, 0)
    _, (xs, vs) = jax.lax.scan(jax.checkpoint(step), (x0, v0), (zs, us_s))
    x_grid = jnp.concatenate([x0[None], xs], axis=0)  # (steps+1, g, paths)
    v_grid = jnp.concatenate([v0[None], vs], axis=0)
    return jnp.exp(jnp.moveaxis(x_grid, 1, 0)), jnp.moveaxis(v_grid, 1, 0)


def simulate_exact_conditional_grid(prob, config, key=None, point_offset=0):
    """EXACT-transition (S, V) grid with SAMPLED per-segment ∫V — the grid
    companion of :class:`HestonExactMixing` (models/heston_exact.py).

    Per segment: the variance steps through the exact noncentral-χ² CIR
    transition (``cir_exact_step``), the segment's integrated variance is
    DRAWN from its exact conditional (mean, variance) given the endpoints
    (``iv_cond_moments`` + gamma moment match), and logS follows the
    conditional-Gaussian mixing update with that sampled IV.  Compared with
    :func:`simulate_conditional_grid` (QE V-path, trapezoid-IV proxy) this
    removes both the QE transition bias and — the point — the
    within-segment V-stochasticity bias of the trapezoid: a bridge
    correction that consumes the SAMPLED ∫V sees the distributionally
    correct Brownian clock, so barrier prices converge at far coarser
    segment budgets (tests/agreement/test_heston_barrier_pde.py pins the
    2-D ADI cross-check the r3 verdict asked for).

    Returns ``(S_grid, V_grid, iv_segs)`` with shapes
    ``(n_groups, steps+1, paths)``, ``(n_groups, steps+1, paths)``,
    ``(n_groups, steps, paths)``.

    Draw layout: 5 dims per step (u_pois, z_gam, u_boost, z_iv, z_perp),
    step-major, shared by the PRNG and Sobol' streams.
    """
    from ..models.heston_exact import (
        cir_exact_constants,
        cir_exact_step,
        iv_cond_moments,
        iv_gamma_draw,
        poisson_kmax,
    )

    market, T, r0 = _sim_params(prob)
    steps = config.steps
    dt = T / steps
    kappa, sigma, rho = market.kappa, market.sigma, market.rho
    c = cir_exact_constants(kappa, market.theta, sigma, dt)
    kmax = poisson_kmax(kappa, market.theta, sigma, dt, market.V0)
    ktd = kappa * market.theta * dt
    rho_bar2 = 1.0 - rho**2
    paths = config.trajectories
    anti = isinstance(config.variance_reduction, Antithetic)
    base = _base_key(config, key)

    if config.qmc:
        from jax.scipy.special import ndtri

        from ..math.sobol import sobol_uniforms

        u = sobol_uniforms(base, paths, steps * 5, skip=point_offset)
        u = jnp.moveaxis(u.reshape(paths, steps, 5), 0, -1)  # (steps, 5, P)
        u_pois, u_gam, u_boost, u_iv, u_perp = (u[:, i] for i in range(5))
        z_gam, z_iv, z_perp = ndtri(u_gam), ndtri(u_iv), ndtri(u_perp)
    else:
        k_z, k_u = jax.random.split(base)
        zb = jax.random.normal(k_z, (steps, 3, paths), dtype=jnp.float64)
        ub = jax.random.uniform(k_u, (steps, 2, paths), dtype=jnp.float64)
        z_gam, z_iv, z_perp = zb[:, 0], zb[:, 1], zb[:, 2]
        u_pois, u_boost = ub[:, 0], ub[:, 1]

    def groups(x, is_uniform):
        if not anti:
            return x[:, None]
        return jnp.stack([x, 1.0 - x if is_uniform else -x], axis=1)

    z_gam, z_iv, z_perp = (groups(x, False) for x in (z_gam, z_iv, z_perp))
    u_pois, u_boost = groups(u_pois, True), groups(u_boost, True)
    n_groups = z_gam.shape[1]

    x0 = jnp.full((n_groups, paths), jnp.log(market.spot))
    v0 = jnp.full((n_groups, paths), market.V0)

    def step(carry, inp):
        x, v = carry
        zg, zi, zp, up, ub_ = inp
        v_new = cir_exact_step(v, up, zg, ub_, c, kmax)
        m1, s2 = iv_cond_moments(v, v_new, c)
        iv_seg = iv_gamma_draw(m1, s2, zi)
        j = (v_new - v - ktd + kappa * iv_seg) / sigma
        x_new = x + r0 * dt - 0.5 * iv_seg + rho * j + jnp.sqrt(
            jnp.maximum(rho_bar2 * iv_seg, 1e-18)
        ) * zp
        return (x_new, v_new), (x_new, v_new, iv_seg)

    # groups() already laid the arrays out step-major: (steps, g, paths)
    inputs = (z_gam, z_iv, z_perp, u_pois, u_boost)
    _, (xs, vs, ivs) = jax.lax.scan(jax.checkpoint(step), (x0, v0), inputs)
    x_grid = jnp.concatenate([x0[None], xs], axis=0)  # (steps+1, g, paths)
    v_grid = jnp.concatenate([v0[None], vs], axis=0)
    return (
        jnp.exp(jnp.moveaxis(x_grid, 1, 0)),
        jnp.moveaxis(v_grid, 1, 0),
        jnp.moveaxis(ivs, 1, 0),  # (g, steps, paths)
    )


def simulate_conditional_values(
    prob: PricingProblem, method: MonteCarlo, key=None, point_offset=0
) -> jnp.ndarray:
    """Per-path undiscounted conditional vanilla values, (n_groups, paths) —
    dispatcher for the conditional (mixing) strategies.  Same key/device/point-offset contract as
    :func:`simulate_terminal_prices`."""
    dyn, strat, config = method.dynamics, method.strategy, method.config
    if isinstance(dyn, BatesDynamics):
        if not (isinstance(strat, HestonQE) and strat.conditional):
            raise TypeError(
                "Bates conditional MC runs on HestonQE(conditional=True); "
                f"got {type(strat).__name__}"
            )
        require_european(prob.payoff, "conditional MonteCarlo", spot_only=True)
        return _bates_qe_mixing_values(prob, config, key, point_offset=point_offset)
    if isinstance(dyn, HestonHullWhiteDynamics):
        if not (isinstance(strat, HestonQE) and strat.conditional):
            raise TypeError(
                "Heston-Hull-White prices through the three-factor "
                "conditional mixing estimator: pair HestonHullWhiteDynamics "
                f"with HestonQE(conditional=True); got {type(strat).__name__}"
            )
        require_european(prob.payoff, "conditional MonteCarlo", spot_only=True)
        return _hhw_mixing_values(prob, config, key, point_offset=point_offset)
    if isinstance(dyn, RoughBergomiDynamics) or isinstance(strat, RoughBergomiMixing):
        if not (
            isinstance(dyn, RoughBergomiDynamics)
            and isinstance(strat, RoughBergomiMixing)
        ):
            raise TypeError(
                "rough Bergomi conditional MC pairs RoughBergomiDynamics with "
                f"RoughBergomiMixing; got ({type(dyn).__name__}, "
                f"{type(strat).__name__})"
            )
        require_european(prob.payoff, "conditional MonteCarlo", spot_only=True)
        return _rbergomi_mixing_values(
            prob, config, key, point_offset=point_offset,
            quad_nodes=strat.quad_nodes, fp32=strat.fp32,
        )
    if not (
        isinstance(strat, (HestonQE, HestonExactMixing))
        and isinstance(dyn, HestonDynamics)
    ):
        raise TypeError(
            "conditional Monte Carlo requires HestonDynamics with HestonQE or "
            f"HestonExactMixing; got ({type(dyn).__name__}, {type(strat).__name__})"
        )
    require_european(prob.payoff, "conditional MonteCarlo", spot_only=True)
    if isinstance(strat, HestonExactMixing):
        return _heston_exact_mixing_values(prob, config, key, point_offset=point_offset)
    return _heston_qe_mixing_values(prob, config, key, point_offset=point_offset)


def mc_path_values(
    prob: PricingProblem, method: MonteCarlo, key=None, point_offset=0
) -> jnp.ndarray:
    """Per-path undiscounted value estimates, antithetic groups averaged —
    the uniform interface the solve facade and the sharded pricer reduce
    over, covering both terminal-sample strategies and the conditional
    mixing estimator.  Shape ``(paths,)`` for scalar strikes; an array-strike
    payoff returns ``(m, paths)`` under every strategy — the strikes share
    one sample set (the path axis is always LAST — reduce over ``axis=-1``)."""
    strat = method.strategy
    if _is_conditional_strategy(strat):
        values = simulate_conditional_values(
            prob, method, key=key, point_offset=point_offset
        )
        return jnp.mean(values, axis=0)
    from ..core.payoffs import (
        AsianOption,
        BarrierOption,
        Cliquet,
        DoubleBarrierOption,
        ForwardStartOption,
        LookbackOption,
        VarianceSwap,
    )

    from ..core.payoffs import BasketOption, SpreadOption

    if isinstance(prob.payoff, (AsianOption, BarrierOption, BasketOption,
                                Cliquet, DoubleBarrierOption,
                                ForwardStartOption, LookbackOption,
                                SpreadOption, VarianceSwap)):
        raise TypeError(
            f"mc_path_values covers single-asset terminal-sample payoffs; "
            f"price {type(prob.payoff).__name__} through solve(...)"
        )
    if isinstance(strat, MertonExact) and isinstance(method.dynamics, MertonJumpDynamics):
        # keep the likelihood-ratio surrogate on EVERY route (sharded
        # pricers included) so λ-gradients stay unbiased
        return _merton_payoffs_with_score(
            prob, method, prob.payoff, key=key, point_offset=point_offset
        )
    samples = simulate_terminal_prices(
        prob, method, key=key, point_offset=point_offset
    )
    return reduce_payoffs(samples, prob.payoff)


# ------------------ Strategy dispatch ------------------


def _is_conditional_strategy(strat) -> bool:
    """True for strategies that price through the conditional (mixing)
    estimator and never materialize terminal samples."""
    return (isinstance(strat, HestonQE) and strat.conditional) or isinstance(
        strat, (HestonExactMixing, RoughBergomiMixing)
    )


def simulate_terminal_prices(
    prob: PricingProblem, method: MonteCarlo, key=None, point_offset=0
) -> jnp.ndarray:
    """Terminal asset prices, shape (n_groups, trajectories) with n_groups==2
    under antithetic pairing (original, mirrored) else 1.

    ``key`` lets sharded callers derive independent per-device
    streams; under QMC, ``point_offset`` gives each device a disjoint slice of
    ONE Sobol' sequence (sharding must not replicate points).

    Replaces reference get_final_samples (montecarlo.jl:442-459).
    """
    dyn, strat, config = method.dynamics, method.strategy, method.config
    if _is_conditional_strategy(strat):
        raise TypeError(
            f"{type(strat).__name__} is a conditional (mixing) strategy and "
            "never materializes terminal samples (logS_T is integrated out "
            "analytically); price through solve(...) or mc_path_values(...)"
        )
    if isinstance(dyn, HestonHullWhiteDynamics):
        raise TypeError(
            "Heston-Hull-White prices through the three-factor conditional "
            "mixing estimator only (terminal samples never materialize): "
            "pair HestonHullWhiteDynamics with HestonQE(conditional=True)"
        )
    if config.qmc and isinstance(strat, HestonBroadieKaya):
        # the Broadie-Kaya sampler draws its own PRNG streams — a silent
        # pseudo-random fallback would betray the qmc=True accuracy contract
        # the caller sized their path count for
        raise ValueError(
            "qmc=True is not supported with HestonBroadieKaya; use the "
            "pure-JAX QE or exact-mixing samplers"
        )
    if isinstance(strat, EulerMaruyama):
        if isinstance(dyn, LognormalDynamics):
            return _gbm_euler_paths(prob, config, _base_key(config, key), return_grid=False, point_offset=point_offset)
        if isinstance(dyn, HestonDynamics):
            return _heston_euler_paths(prob, config, _base_key(config, key), return_grid=False, point_offset=point_offset)
    if isinstance(strat, HestonQE) and isinstance(dyn, HestonDynamics):
        return _heston_qe_paths(prob, config, key, strat, return_grid=False, point_offset=point_offset)
    if isinstance(strat, BlackScholesExact) and isinstance(dyn, LognormalDynamics):
        return _gbm_exact_terminal(prob, config, _base_key(config, key), point_offset=point_offset)
    if isinstance(strat, HestonBroadieKaya) and isinstance(dyn, HestonDynamics):
        from ..distributions.broadie_kaya import broadie_kaya_terminal_prices

        return broadie_kaya_terminal_prices(prob, config, strat, key=key)
    if isinstance(strat, MertonExact) and isinstance(dyn, MertonJumpDynamics):
        return _merton_exact_terminal(prob, config, key, point_offset=point_offset)
    if isinstance(strat, EulerMaruyama) and isinstance(dyn, MertonJumpDynamics):
        return _merton_euler_paths(
            prob, config, _base_key(config, key), return_grid=False,
            point_offset=point_offset,
        )
    if isinstance(strat, KouExact) and isinstance(dyn, KouJumpDynamics):
        return _kou_exact_terminal(
            prob, config, _base_key(config, key), point_offset=point_offset
        )
    if isinstance(strat, EulerMaruyama) and isinstance(dyn, KouJumpDynamics):
        return _kou_euler_paths(
            prob, config, _base_key(config, key), return_grid=False,
            point_offset=point_offset,
        )
    if isinstance(strat, EulerMaruyama) and isinstance(dyn, BatesDynamics):
        return _bates_euler_paths(
            prob, config, _base_key(config, key), return_grid=False,
            point_offset=point_offset,
        )
    if isinstance(strat, VarianceGammaExact) and isinstance(dyn, VarianceGammaDynamics):
        return _vg_exact_terminal(
            prob, config, _base_key(config, key), point_offset=point_offset
        )
    if isinstance(strat, EulerMaruyama) and isinstance(dyn, VarianceGammaDynamics):
        return _vg_euler_paths(
            prob, config, _base_key(config, key), return_grid=False,
            point_offset=point_offset,
        )
    if isinstance(strat, BachelierExact) and isinstance(dyn, NormalDynamics):
        return _bachelier_exact_terminal(
            prob, config, _base_key(config, key), point_offset=point_offset
        )
    if isinstance(strat, EulerMaruyama) and isinstance(dyn, NormalDynamics):
        return _bachelier_euler_paths(
            prob, config, _base_key(config, key), return_grid=False,
            point_offset=point_offset,
        )
    if isinstance(strat, EulerMaruyama) and isinstance(dyn, SABRDynamics):
        return _sabr_euler_paths(
            prob, config, _base_key(config, key), return_grid=False,
            point_offset=point_offset,
        )
    if isinstance(strat, EulerMaruyama) and isinstance(dyn, RoughBergomiDynamics):
        return _rbergomi_euler_paths(
            prob, config, key, return_grid=False, point_offset=point_offset
        )
    if isinstance(strat, EulerMaruyama) and isinstance(dyn, LocalVolDynamics):
        return _local_vol_euler_paths(
            prob, config, _base_key(config, key), return_grid=False,
            point_offset=point_offset,
        )
    if isinstance(strat, EulerMaruyama) and isinstance(dyn, CEVDynamics):
        return _cev_euler_paths(
            prob, config, _base_key(config, key), return_grid=False,
            point_offset=point_offset,
        )
    if isinstance(strat, EulerMaruyama) and isinstance(dyn, SLVDynamics):
        return _slv_euler_paths(
            prob, config, _base_key(config, key), return_grid=False,
            point_offset=point_offset,
        )
    raise TypeError(
        f"unsupported (dynamics, strategy) = ({type(dyn).__name__}, {type(strat).__name__})"
    )


def simulate_price_grid(
    prob: PricingProblem, method: MonteCarlo, key=None, point_offset=0
) -> jnp.ndarray:
    """Full price grid (n_groups, steps+1, trajectories) for grid methods (LSM).

    Exact-GBM strategies step with exact lognormal per-step transitions
    (matching GeometricBrownianMotionProcess under EM(), montecarlo.jl:140-159);
    Euler strategies use the same steppers as terminal simulation.
    """
    dyn, strat, config = method.dynamics, method.strategy, method.config
    if isinstance(strat, HestonQE) and strat.conditional:
        # conditional bridge grid: QE variance path + one-normal exact
        # conditional S draw per step (LSM additionally wants the V grid —
        # it calls simulate_conditional_grid directly for the pair)
        if not isinstance(dyn, HestonDynamics):
            raise TypeError("HestonQE(conditional=True) requires HestonDynamics")
        return simulate_conditional_grid(prob, config, key=key, point_offset=point_offset)[0]
    if isinstance(dyn, LognormalDynamics):
        # Exact per-step lognormal transitions == log-Euler with exact drift:
        # both produce S_{k+1} = S_k·exp((r−σ²/2)dt + σ√dt·Z).
        return _gbm_euler_paths(prob, config, _base_key(config, key), return_grid=True, point_offset=point_offset)
    if isinstance(dyn, HestonDynamics) and isinstance(strat, EulerMaruyama):
        return _heston_euler_paths(prob, config, _base_key(config, key), return_grid=True, point_offset=point_offset)
    if isinstance(dyn, HestonDynamics) and isinstance(strat, HestonQE):
        return _heston_qe_paths(prob, config, key, strat, return_grid=True, point_offset=point_offset)
    if isinstance(dyn, SABRDynamics) and isinstance(strat, EulerMaruyama):
        return _sabr_euler_paths(prob, config, _base_key(config, key), return_grid=True, point_offset=point_offset)
    if isinstance(dyn, RoughBergomiDynamics) and isinstance(strat, EulerMaruyama):
        return _rbergomi_euler_paths(prob, config, key, return_grid=True, point_offset=point_offset)
    if isinstance(dyn, LocalVolDynamics) and isinstance(strat, EulerMaruyama):
        return _local_vol_euler_paths(prob, config, _base_key(config, key), return_grid=True, point_offset=point_offset)
    if isinstance(dyn, CEVDynamics) and isinstance(strat, EulerMaruyama):
        return _cev_euler_paths(prob, config, _base_key(config, key), return_grid=True, point_offset=point_offset)
    if isinstance(dyn, SLVDynamics) and isinstance(strat, EulerMaruyama):
        return _slv_euler_paths(prob, config, _base_key(config, key), return_grid=True, point_offset=point_offset)
    if isinstance(dyn, MertonJumpDynamics) and isinstance(strat, EulerMaruyama):
        return _merton_euler_paths(prob, config, _base_key(config, key), return_grid=True, point_offset=point_offset)
    if isinstance(dyn, NormalDynamics) and isinstance(strat, EulerMaruyama):
        return _bachelier_euler_paths(prob, config, _base_key(config, key), return_grid=True, point_offset=point_offset)
    if isinstance(dyn, KouJumpDynamics) and isinstance(strat, EulerMaruyama):
        return _kou_euler_paths(prob, config, _base_key(config, key), return_grid=True, point_offset=point_offset)
    if isinstance(dyn, VarianceGammaDynamics) and isinstance(strat, EulerMaruyama):
        return _vg_euler_paths(prob, config, _base_key(config, key), return_grid=True, point_offset=point_offset)
    if isinstance(dyn, BatesDynamics) and isinstance(strat, EulerMaruyama):
        return _bates_euler_paths(prob, config, _base_key(config, key), return_grid=True, point_offset=point_offset)
    raise TypeError(
        f"unsupported grid simulation ({type(dyn).__name__}, {type(strat).__name__})"
    )


# ------------------ Pricing ------------------


def reduce_payoffs(samples: jnp.ndarray, payoff) -> jnp.ndarray:
    """Per-path payoffs; antithetic groups are averaged pairwise
    (montecarlo.jl:428-432).

    An array-strike payoff gets the uniform grid contract (leading strike
    axis, path axis last): samples (g, paths) → payoffs (m, paths), every
    strike priced from the SAME terminal samples."""
    if jnp.ndim(payoff.strike) > 0:
        import dataclasses

        payoff = dataclasses.replace(payoff, strike=jnp.asarray(payoff.strike)[:, None])
        return jnp.mean(payoff(samples[:, None, :]), axis=0)
    return jnp.mean(payoff(samples), axis=0)


@register_solver(MonteCarlo)
def _solve_montecarlo(prob: PricingProblem, method: MonteCarlo) -> MonteCarloSolution:
    payoff = prob.payoff
    from ..core.payoffs import (
        AsianOption,
        BarrierOption,
        Cliquet,
        ForwardStartOption,
        VarianceSwap,
    )

    if isinstance(payoff, BarrierOption):
        return _solve_barrier_mc(prob, method)
    from ..core.payoffs import DoubleBarrierOption, LookbackOption

    if isinstance(payoff, DoubleBarrierOption):
        return _solve_double_barrier_mc(prob, method)
    if isinstance(payoff, LookbackOption):
        return _solve_lookback_mc(prob, method)
    if isinstance(payoff, AsianOption):
        return _solve_asian_mc(prob, method)
    if isinstance(payoff, VarianceSwap):
        return _solve_variance_swap_mc(prob, method)
    if isinstance(payoff, ForwardStartOption):
        return _solve_forward_start_mc(prob, method)
    if isinstance(payoff, Cliquet):
        return _solve_cliquet_mc(prob, method)
    from ..core.payoffs import Autocallable

    if isinstance(payoff, Autocallable):
        return _solve_autocall_mc(prob, method)
    from ..core.payoffs import (
        BasketOption,
        ChooserOption,
        CompoundOption,
        RainbowOption,
        SpreadOption,
    )

    if isinstance(payoff, (SpreadOption, BasketOption, RainbowOption)):
        from .multi_asset import solve_multi_asset_mc

        return solve_multi_asset_mc(prob, method)
    if isinstance(payoff, (CompoundOption, ChooserOption)):
        return _solve_two_date_mc(prob, method)
    # European×Spot-only MC solve signature (montecarlo.jl:479)
    require_european(payoff, "MonteCarlo", spot_only=True)
    discount = df(prob.market_inputs.rate, payoff.expiry)
    strat = method.strategy
    if _is_conditional_strategy(strat):
        # Romano-Touzi conditional MC: the ensemble payload is the per-path
        # conditional (undiscounted) vanilla values, not terminal samples.
        # Mean over the (group, path) axes; an array-strike payoff keeps its
        # strike axis — (g, m, paths) → (m,) prices from ONE path set.
        values = simulate_conditional_values(prob, method)
        price = discount * jnp.mean(values, axis=(0, -1))
        return MonteCarloSolution(prob, method, price, values)
    if isinstance(strat, MertonExact) and isinstance(method.dynamics, MertonJumpDynamics):
        # likelihood-ratio surrogate baked into the per-path payoffs so
        # jax.grad through solve is unbiased in the jump intensity too
        payoffs = _merton_payoffs_with_score(prob, method, payoff)
        price = discount * jnp.mean(payoffs, axis=-1)
        return MonteCarloSolution(prob, method, price, payoffs)
    samples = simulate_terminal_prices(prob, method)
    payoffs = reduce_payoffs(samples, payoff)
    # path axis is last: a strike-grid payoff keeps its leading (m,) axis
    price = discount * jnp.mean(payoffs, axis=-1)
    return MonteCarloSolution(prob, method, price, samples)
