"""Regression tests for the entry points (__graft_entry__)."""

import os
import pathlib
import subprocess
import sys

import jax
import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))
import __graft_entry__ as graft  # noqa: E402


def test_entry_compiles_and_prices():
    fn, args = graft.entry()
    price = float(jax.jit(fn)(*args))
    assert 5.0 < price < 20.0  # sane ATM Heston call price


def test_dryrun_multichip_8():
    graft.dryrun_multichip(8)


def test_dryrun_multichip_2():
    graft.dryrun_multichip(2)


def test_dryrun_backend_failure_raises(monkeypatch):
    """A backend that fails to initialize surfaces its error: there is no
    probe and no re-run on another platform."""

    def broken():
        raise RuntimeError("Unable to initialize backend (simulated)")

    monkeypatch.setattr(graft.jax, "devices", broken)
    with pytest.raises(RuntimeError, match="simulated"):
        graft.dryrun_multichip(8)


def test_dryrun_too_few_devices_raises():
    """Asking for more devices than the backend has raises before any
    phase runs (the suite's CPU backend has 8 virtual devices)."""
    with pytest.raises(RuntimeError, match="needs 16 devices"):
        graft.dryrun_multichip(16)


def test_dryrun_local_impl_failure_raises(monkeypatch):
    """A failure inside a phase propagates to the caller."""

    def failing(n):
        raise RuntimeError("DEADLINE_EXCEEDED (simulated)")

    monkeypatch.setattr(graft, "_dryrun_multichip_impl", failing)
    with pytest.raises(RuntimeError, match="DEADLINE_EXCEEDED"):
        graft.dryrun_multichip(8)


def test_dryrun_runs_in_process(monkeypatch):
    """With enough devices the phases run in this process on the default
    backend; the module starts no subprocess."""
    ran = {}
    monkeypatch.setattr(graft, "_dryrun_multichip_impl", lambda n: ran.setdefault("n", n))
    graft.dryrun_multichip(8)
    assert ran["n"] == 8
    assert not hasattr(graft, "subprocess")


def _env(**overrides):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(REPO)
    env.update(overrides)
    return env


def test_import_is_computation_free():
    """Module-scope ``jnp.array`` calls would execute on the default backend
    at ``import hedgehog_tpu``, so a broken accelerator runtime would kill
    the import.  Poison eager primitive dispatch in a fresh subprocess and
    assert the import (and the entry module's import) still succeeds."""
    code = (
        "import jax\n"
        "from jax._src import dispatch\n"
        "def _poison(*a, **k):\n"
        "    raise RuntimeError('eager primitive execution at import time')\n"
        "dispatch.apply_primitive = _poison\n"
        "import hedgehog_tpu\n"
        "import __graft_entry__\n"
        "print('IMPORT_OK')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], env=_env(), capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "IMPORT_OK" in proc.stdout


def test_broken_platform_import_and_dryrun_raises():
    """A process whose ONLY platform fails backend init (JAX_PLATFORMS=cuda
    on a host with no GPU runtime) still imports hedgehog_tpu — the import
    is computation-free — and dryrun_multichip then fails with a non-zero
    exit instead of running somewhere else."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import hedgehog_tpu; print('IMPORT_OK', flush=True); "
         "import __graft_entry__ as g; g.dryrun_multichip(4); print('RAN')"],
        env=_env(JAX_PLATFORMS="cuda"), capture_output=True, text=True, timeout=600,
    )
    assert "IMPORT_OK" in proc.stdout
    assert proc.returncode != 0
    assert "RAN" not in proc.stdout


def test_dryrun_multichip_driver_invocation():
    """A bare process that sees ONE CPU device cannot run the 8-device
    dryrun: it raises with the device count instead of re-executing on a
    virtual mesh."""
    proc = subprocess.run(
        [sys.executable, "-c", "import __graft_entry__; __graft_entry__.dryrun_multichip(8)"],
        env=_env(JAX_PLATFORMS="cpu"), capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode != 0
    assert "needs 8 devices" in proc.stderr
