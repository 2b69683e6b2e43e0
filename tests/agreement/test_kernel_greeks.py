"""Forward-mode mixing greeks (methods/mixing_greeks.py), validated on CPU:
they must equal reverse AD through the seeded ``solve`` to machine
precision — same draws, same estimator, independent derivation.
"""

import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import hedgehog_tpu as hh
from hedgehog_tpu.methods.mixing_greeks import (
    GREEK_ORDER,
    heston_mixing_price_and_greeks,
)

REF = dt.date(2024, 1, 1)
EXPIRY = dt.date(2025, 1, 1)
SPOT, R = 100.0, 0.03
H = dict(V0=0.04, kappa=2.0, theta=0.04, sigma=0.3, rho=-0.7)


def _method(n_pairs, steps, qmc=False, seed=0):
    cfg = hh.SimulationConfig(
        trajectories=n_pairs, steps=steps, variance_reduction=hh.Antithetic(),
        seed=seed, qmc=qmc,
    )
    return hh.MonteCarlo(hh.HestonDynamics(), hh.HestonQE(conditional=True), cfg)


def _payoff(strike, cp=None):
    return hh.VanillaOption(strike, EXPIRY, hh.European(), cp or hh.Call(), hh.Spot())


@pytest.mark.parametrize("qmc", [False, True], ids=["prng", "qmc"])
@pytest.mark.parametrize("cp,strike", [(hh.Call(), 100.0), (hh.Put(), 90.0)],
                         ids=["atm_call", "otm_put"])
def test_forward_greeks_match_reverse_ad(qmc, cp, strike):
    method = _method(4096, 8, qmc=qmc)
    payoff = _payoff(strike, cp)

    def price(params):
        spot, v0, kappa, theta, sigma, rho, r = params
        market = hh.HestonInputs(REF, r, spot, v0, kappa, theta, sigma, rho)
        return hh.solve(hh.PricingProblem(payoff, market), method).price

    params = tuple(jnp.float64(x) for x in (SPOT, H["V0"], H["kappa"], H["theta"],
                                            H["sigma"], H["rho"], R))
    p_ref, g_ref = jax.value_and_grad(price)(params)

    market = hh.HestonInputs(REF, R, SPOT, *H.values())
    p_new, g_new = heston_mixing_price_and_greeks(
        hh.PricingProblem(payoff, market), method
    )
    np.testing.assert_allclose(float(p_new), float(p_ref), rtol=1e-12)
    for k, g in zip(GREEK_ORDER, g_ref):
        np.testing.assert_allclose(
            float(g_new[k]), float(g), rtol=1e-9, atol=1e-12, err_msg=k
        )


def test_forward_greeks_rejects_wrong_method():
    market = hh.HestonInputs(REF, R, SPOT, *H.values())
    bad = hh.MonteCarlo(hh.HestonDynamics(), hh.HestonQE(conditional=False),
                        hh.SimulationConfig(trajectories=64, steps=2))
    with pytest.raises(TypeError):
        heston_mixing_price_and_greeks(hh.PricingProblem(_payoff(100.0), market), bad)
