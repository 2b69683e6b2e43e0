"""Coverage for smaller public APIs: complexops vs numpy, log_dynamics,
lens_get/lens_set, checkpoint error path, profiling."""

import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import hedgehog_tpu as hh

REF, EXPIRY = dt.date(2024, 1, 1), dt.date(2025, 1, 1)


def test_complexops_match_numpy():
    from hedgehog_tpu.math.complexops import cabs2, cdiv, cexp, clog, cmul, csqrt

    rng = np.random.default_rng(0)
    for _ in range(6):
        a = complex(rng.normal(), rng.normal())
        b = complex(rng.normal(), rng.normal())
        ap = (jnp.asarray(a.real), jnp.asarray(a.imag))
        bp = (jnp.asarray(b.real), jnp.asarray(b.imag))

        def as_c(p):
            return complex(float(p[0]), float(p[1]))

        assert as_c(cmul(ap, bp)) == pytest.approx(a * b, rel=1e-12)
        assert as_c(cdiv(ap, bp)) == pytest.approx(a / b, rel=1e-12)
        assert as_c(cexp(ap)) == pytest.approx(np.exp(a), rel=1e-12)
        assert as_c(clog(ap)) == pytest.approx(np.log(a), rel=1e-12)
        assert as_c(csqrt(ap)) == pytest.approx(np.sqrt(a), rel=1e-12)
        assert float(cabs2(ap)) == pytest.approx(abs(a) ** 2, rel=1e-12)


def test_log_dynamics():
    from hedgehog_tpu.models.dynamics import log_dynamics

    assert isinstance(log_dynamics(hh.BlackScholesAnalytic()), hh.LognormalDynamics)
    m = hh.MonteCarlo(hh.HestonDynamics(), hh.EulerMaruyama(), hh.SimulationConfig(16))
    assert isinstance(log_dynamics(m), hh.HestonDynamics)
    cm = hh.CarrMadan(1.0, 32.0, hh.HestonDynamics())
    assert isinstance(log_dynamics(cm), hh.HestonDynamics)
    with pytest.raises(TypeError):
        log_dynamics(hh.CoxRossRubinsteinMethod(10))


def test_lens_get_set_module_functions():
    market = hh.BlackScholesInputs(REF, 0.05, 100.0, 0.2)
    prob = hh.PricingProblem(
        hh.VanillaOption(100.0, EXPIRY, hh.European(), hh.Call(), hh.Spot()), market
    )
    lens = hh.SpotLens()
    assert float(hh.lens_get(prob, lens)) == 100.0
    prob2 = hh.lens_set(prob, lens, 120.0)
    assert float(hh.lens_get(prob2, lens)) == 120.0
    assert float(hh.lens_get(prob, lens)) == 100.0  # original untouched

def test_checkpoint_structure_mismatch():
    from hedgehog_tpu.utils.checkpoint import load_pytree, save_pytree

    import tempfile, os

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "x")
        save_pytree(path, {"a": jnp.ones(3)})
        with pytest.raises(ValueError, match="leaves"):
            load_pytree(path, {"a": jnp.ones(3), "b": jnp.ones(2)})


def test_time_fn_and_trace(tmp_path):
    from hedgehog_tpu.utils.profiling import time_fn, trace

    f = jax.jit(lambda x: x * 2.0)
    t = time_fn(f, jnp.ones(16), reps=3, warmup=1)
    assert t >= 0.0
    with trace(str(tmp_path / "trace")):
        jax.block_until_ready(f(jnp.ones(16)))


def test_interpolator2d_call_alias():
    itp = hh.Interpolator2D(jnp.array([0.0, 1.0]), jnp.array([0.0, 1.0]),
                            jnp.array([[0.0, 1.0], [2.0, 3.0]]))
    assert float(itp(0.5, 0.5)) == pytest.approx(1.5)


def test_all_exports_resolve():
    """Every name in hedgehog_tpu.__all__ must resolve to a real object —
    the reference exports `implied_vol` without defining it
    (src/Hedgehog.jl:79); this test makes that class of bug impossible."""
    for name in hh.__all__:
        assert getattr(hh, name, None) is not None, name


def test_notebook_artifacts_are_valid_and_executed():
    """Reference-parity artifact (docs/src/interactive.md + Pluto notebooks):
    the jupyter notebooks exist, parse as nbformat v4, and carry EXECUTED
    outputs (every code cell has an execution_count)."""
    import pathlib

    import nbformat

    nb_dir = pathlib.Path(__file__).parents[2] / "examples" / "notebooks"
    names = ["walkthrough.ipynb", "structured_desk.ipynb"]
    for name in names:
        nb = nbformat.read(nb_dir / name, as_version=4)
        code_cells = [c for c in nb.cells if c.cell_type == "code"]
        assert len(code_cells) >= 4, name
        assert all(c.execution_count is not None for c in code_cells), (
            f"{name} has unexecuted cells — rerun "
            "examples/notebooks/build_notebooks.py"
        )
