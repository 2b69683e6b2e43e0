"""Test harness config: the suite runs on the CPU with 8 virtual devices.

Mirrors the reference's single-suite strategy (test/runtests.jl) and adds
the multi-device tier from SURVEY.md §4: sharding logic is validated on a
virtual 8-device CPU mesh (``--xla_force_host_platform_device_count=8``).

Run it with ``JAX_PLATFORMS=cpu python -m pytest tests -m "not slow"``; the
platform defaults to the CPU when ``JAX_PLATFORMS`` is unset.  Tests that
need the GPU carry the ``gpu`` marker and skip elsewhere; on a machine with
the card, ``JAX_PLATFORMS=cuda python -m pytest tests -m gpu`` runs them.
The program itself runs on the GPU through ``python chip_smoke.py``.

KNOWN ISSUE — full suite in ONE process: after ~100 compile-heavy tests the
XLA:CPU compiler segfaulted deterministically compiling the large 2-D ADI
program (test_heston_barrier_pde's first test; every file passes in
isolation and in small combos).  Run the full suite via
scripts/run_full_suite.sh (one process per file); the fast tier
(``pytest -m "not slow"``) is unaffected and passes in one process.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache: JAX_COMPILATION_CACHE_DIR when set, else
# <repo>/.jax_compilation_cache (gitignored).  The suite is compile-dominated
# on CPU, so repeat runs reuse compiled programs across processes.
from hedgehog_tpu.utils.compile_cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

# ---- fast/slow test tiers -------------------------------------------------
# ``pytest -m "not slow"`` is the bounded smoke tier (target: <=5 minutes
# even on a contended single-CPU host — wall clock here is compile-dominated,
# so the tier is tuned by moving everything >=3 s/test to the slow list);
# the full suite is unchanged.  The slow set is maintained as an
# explicit list (tests/slow_tests.txt, one ``file::testname`` per line,
# parameterizations stripped) generated from measured --durations output —
# a collection hook marks them so individual files stay unannotated, and
# warns on stale entries whose test no longer exists.
# tests/agreement/test_agreement_smoke.py guarantees the heavy agreement
# families (Broadie-Kaya, American LSM-vs-CRR, Feller-violating mixing)
# each keep one reduced-size representative INSIDE the fast tier.

import pathlib  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``gpu``-marked tests unless JAX's default backend is a GPU.
    Decided per test at run time, never at import or collection."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU; the default backend is {jax.default_backend()}")

_SLOW_FILE = pathlib.Path(__file__).parent / "slow_tests.txt"
_SLOW = frozenset(
    line.strip() for line in _SLOW_FILE.read_text().splitlines() if line.strip()
)


def pytest_collection_modifyitems(config, items):
    seen = set()
    collected_files = set()
    for item in items:
        base = item.nodeid.split("[", 1)[0]
        collected_files.add(base.split("::", 1)[0])
        seen.add(base)
        if base in _SLOW:
            item.add_marker(pytest.mark.slow)
    # Stale-entry guard: a slow-list line whose FILE was collected but whose
    # test no longer exists silently marks nothing (e.g. after a rename) —
    # warn so the list stays in sync.  Checking per-file keeps partial runs
    # (pytest tests/unit/test_foo.py) from flagging entries for other files.
    # Node-id selection (tests/foo.py::test_bar) and -k filtering collect only
    # a subset of a file, so existing tests would be falsely flagged — the
    # guard only fires on unfiltered collection.
    if getattr(config.option, "keyword", "") or any(
        "::" in str(a) for a in config.invocation_params.args
    ):
        return
    for entry in sorted(_SLOW - seen):
        if entry.split("::", 1)[0] in collected_files:
            import warnings

            warnings.warn(
                f"tests/slow_tests.txt entry matches no collected test: {entry}",
                stacklevel=1,
            )
