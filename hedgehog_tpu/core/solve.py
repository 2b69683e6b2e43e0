"""The `solve(problem, method)` facade — the single entry point of the
framework, mirroring the reference's SciML-style interface (README.md:11-26,
docs/adr/adr-004-sciml-integration.yaml).

Dispatch is a registry keyed by method class (with MRO walk), replacing Julia
multiple dispatch.  Baskets are handled generically: pricing a
``BasketPricingProblem`` maps the method over payoffs (basket.jl:35-38).

Every registered solver is a pure jax-traceable function, so users can wrap
``solve`` in jit/vmap/grad directly:

    price = jax.jit(lambda p: solve(p, BlackScholesAnalytic()).price)(prob)
"""

from __future__ import annotations

from typing import Any, Callable

from .problems import BasketPricingProblem, BasketPricingSolution, PricingProblem

__all__ = ["solve", "register_solver", "AbstractPricingMethod"]


class AbstractPricingMethod:
    """Base marker for pricing methods (pricing_methods.jl:6)."""


_SOLVERS: dict[type, Callable] = {}


def register_solver(method_cls: type):
    """Register fn(problem, method, *args, **kwargs) for a method class."""

    def deco(fn: Callable) -> Callable:
        _SOLVERS[method_cls] = fn
        return fn

    return deco


def _lookup(method: Any) -> Callable:
    for cls in type(method).__mro__:
        if cls in _SOLVERS:
            return _SOLVERS[cls]
    raise TypeError(f"no solver registered for method {type(method).__name__}")


def _conditional_basket_fast_path(problem, method):
    """One-simulation basket pricing for conditional-MC Heston vanillas.

    When every payoff is a European×Spot vanilla with a scalar strike, the
    market is Heston, and the method is MonteCarlo(HestonQE(conditional=
    True)), the whole basket prices from ONE variance-path simulation:
    payoffs group by expiry, the V path runs through the sorted expiry
    segments, and every (strike, cp) closes with the conditional BS formula
    (methods/montecarlo._mixing_surface_rows).  All basket points share
    paths — tighter smile/term shapes and one differentiable program, which
    is exactly what CalibrationProblem objectives iterate on.

    Returns None (→ generic per-payoff loop) whenever the structure doesn't
    qualify or the expiry layout isn't host-static.
    """
    import jax

    from ..market.inputs import market_yearfrac
    from ..core.payoffs import European, Spot, VanillaOption
    from ..market.inputs import HestonInputs
    from ..methods.montecarlo import HestonQE, MonteCarlo, _mixing_surface_rows
    from ..models.dynamics import HestonDynamics

    market = problem.market_inputs
    if not (
        isinstance(method, MonteCarlo)
        # dynamics must qualify too: per-payoff dispatch rejects e.g. a
        # (LognormalDynamics, HestonQE(conditional=True)) method object, so
        # the basket path must not silently price it as Heston conditional MC
        and isinstance(method.dynamics, HestonDynamics)
        and isinstance(method.strategy, HestonQE)
        and method.strategy.conditional
        and isinstance(market, HestonInputs)
    ):
        return None
    payoffs = problem.payoffs
    import jax.numpy as jnp

    for p in payoffs:
        if not (
            isinstance(p, VanillaOption)
            and isinstance(p.exercise_style, European)
            and isinstance(p.underlying, Spot)
            and jnp.ndim(p.strike) == 0
        ):
            return None
    if not payoffs:
        return None  # generic loop returns the empty BasketPricingSolution
    try:
        T_all = [float(market_yearfrac(market, p.expiry)) for p in payoffs]
    except jax.errors.ConcretizationTypeError:
        return None
    if min(T_all) <= 0.0:
        return None

    T_sorted = sorted(set(T_all))
    groups = {t: [] for t in T_sorted}  # expiry → list of payoff indices
    for idx, t in enumerate(T_all):
        groups[t].append(idx)
    per_strikes = [jnp.stack([jnp.asarray(payoffs[i].strike) for i in groups[t]]) for t in T_sorted]
    per_cp = [jnp.asarray([payoffs[i].call_put() for i in groups[t]]) for t in T_sorted]

    rows = _mixing_surface_rows(market, T_sorted, per_strikes, per_cp, method.config)
    prices = [None] * len(payoffs)
    for row, t in zip(rows, T_sorted):
        for pos, idx in enumerate(groups[t]):
            prices[idx] = row[pos]

    from ..core.problems import MonteCarloSolution

    sols = tuple(
        MonteCarloSolution(PricingProblem(p, market), method, prices[i], None)
        for i, p in enumerate(payoffs)
    )
    return BasketPricingSolution(problem, sols)


def solve(problem: Any, method: Any, *args: Any, **kwargs: Any):
    """Solve a pricing / greek / calibration problem with the given method."""
    if isinstance(problem, BasketPricingProblem) and isinstance(method, AbstractPricingMethod):
        if not args and not kwargs:
            fast = _conditional_basket_fast_path(problem, method)
            if fast is not None:
                return fast
        sols = tuple(
            solve(PricingProblem(payoff, problem.market_inputs), method, *args, **kwargs)
            for payoff in problem.payoffs
        )
        return BasketPricingSolution(problem, sols)
    return _lookup(method)(problem, method, *args, **kwargs)
