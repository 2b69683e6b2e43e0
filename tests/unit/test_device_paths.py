"""What runs where: the Carr-Madan engine choice, Broadie-Kaya on the
device, the f32 Volterra matmul precision and the compile-cache location
are the same on every backend; every strategy is plain JAX; the GPU
scripts refuse to run without a GPU."""

import datetime as dt
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import hedgehog_tpu as hh
from hedgehog_tpu.utils import compile_cache

REF, EXPIRY = dt.date(2024, 1, 1), dt.date(2025, 1, 1)
HESTON = hh.HestonInputs(REF, 0.03, 100.0, 0.04, 2.0, 0.04, 0.3, -0.7)
REPO = pathlib.Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("payoff", [
    hh.VanillaOption(jnp.array([90.0, 100.0, 110.0]), EXPIRY, hh.European(), hh.Call(), hh.Spot()),
    hh.DigitalOption(100.0, EXPIRY, hh.European(), hh.Call(), hh.Spot()),
], ids=["vanilla_grid", "digital"])
def test_carr_madan_auto_engine_is_complex(payoff):
    """``engine="auto"`` resolves to the complex128 engine on every backend:
    its prices are bit-identical to ``engine="complex"``."""
    prob = hh.PricingProblem(payoff, HESTON)

    def price(engine):
        return np.asarray(hh.solve(prob, hh.CarrMadan(1.0, 32.0, hh.HestonDynamics(),
                                                      engine=engine)).price)

    auto, complex_, pair = price("auto"), price("complex"), price("pair")
    np.testing.assert_array_equal(auto, complex_)
    np.testing.assert_allclose(auto, pair, rtol=1e-9)


def test_broadie_kaya_has_no_host_callback():
    """The Broadie-Kaya sampler (complex128 CF inversion) is one device
    program: no callback to the host anywhere in its jaxpr."""
    cfg = hh.SimulationConfig(trajectories=64, steps=1, seed=0)
    method = hh.MonteCarlo(hh.HestonDynamics(), hh.HestonBroadieKaya(cf_terms=16,
                                                                       inversion_iters=8), cfg)
    prob = hh.PricingProblem(hh.VanillaOption(100.0, EXPIRY, hh.European(), hh.Call(),
                                              hh.Spot()), HESTON)
    jaxpr = str(jax.make_jaxpr(lambda p: hh.simulate_terminal_prices(p, method))(prob))
    assert "callback" not in jaxpr
    assert "complex128" in jaxpr


def test_rbergomi_fp32_volterra_matmul_is_highest_precision():
    """Under fp32=True the Volterra matmul states HIGHEST precision (no
    TF32 on the GPU); the f64 path's matmul stays f64."""
    market = hh.RoughBergomiInputs(REF, 0.03, 100.0, 0.04, 1.9, 0.1, -0.9)
    prob = hh.PricingProblem(hh.VanillaOption(100.0, EXPIRY, hh.European(), hh.Call(),
                                              hh.Spot()), market)
    cfg = hh.SimulationConfig(trajectories=64, steps=8, seed=0)
    for fp32 in (True, False):
        method = hh.MonteCarlo(hh.RoughBergomiDynamics(), hh.RoughBergomiMixing(fp32=fp32), cfg)
        text = jax.jit(lambda p: hh.solve(p, method).price).lower(prob).as_text()
        dots = [line for line in text.splitlines() if "dot_general" in line]
        f32_dots = [line for line in dots if "xf32>" in line]
        assert dots
        if fp32:
            assert f32_dots and all("HIGHEST" in line for line in f32_dots)
        else:
            assert not f32_dots


@pytest.mark.parametrize("strategy", [
    hh.HestonExactMixing, hh.HestonQE, hh.EulerMaruyama, hh.BlackScholesExact,
    hh.RoughBergomiMixing,
])
def test_no_strategy_takes_a_kernel_flag(strategy):
    """Every Monte Carlo strategy is one JAX program on every backend: none
    accepts a ``use_kernel`` switch to another implementation."""
    strategy()
    with pytest.raises(TypeError):
        strategy(use_kernel=True)


def _run_script(args, cwd):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env.update(JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_scripts_exit_without_a_gpu(script, tmp_path):
    """On a CPU-only JAX the smoke run and the benchmark exit non-zero
    before any phase and print no result line."""
    proc = _run_script([str(REPO / script)], cwd=REPO)
    assert proc.returncode != 0
    assert "needs a GPU" in proc.stderr
    assert '"ok"' not in proc.stdout and '"metric"' not in proc.stdout


def test_chip_smoke_alone_exits_non_zero(tmp_path):
    """Copied into a directory that holds nothing else of the repo, the
    smoke script fails at import and prints no result line."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    proc = _run_script([str(alone)], cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set the helper returns it and changes
    no JAX setting."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_repo_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compilation_cache()
    assert path == str(REPO / ".jax_compilation_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_import_sets_no_compile_cache():
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c",
         "import jax, hedgehog_tpu; print('DIR', jax.config.jax_compilation_cache_dir)"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "DIR None" in proc.stdout
