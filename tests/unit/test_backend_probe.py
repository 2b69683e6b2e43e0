"""Guard: the suite runs on the CPU with the 8-device virtual mesh that
tests/conftest.py sets up before JAX initializes a backend."""

import jax


def test_suite_runs_on_virtual_cpu_mesh():
    assert jax.default_backend() == "cpu"
    assert len(jax.devices()) == 8
