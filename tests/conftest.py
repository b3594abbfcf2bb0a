"""Test configuration: a virtual 8-device CPU mesh + float64.

Multi-chip sharding is validated the standard way — N virtual CPU devices
(SURVEY.md §4e) — and float64 is enabled so the reference-tolerance
integrator paths are testable. Must run before any JAX backend init, hence
at conftest import time. JAX_PLATFORMS defaults to cpu; tests marked
`gpu` need a card and run only with JAX_PLATFORMS=cuda (README "Tests").
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# XLA:CPU splits large modules across a codegen thread pool; two
# monolithic-suite runs (round 3: test_polarization.py:290, round 4:
# test_polarization.py:220) died with a SIGSEGV inside
# backend_compile_and_load on this 1-core host, always ~45+ min /
# hundreds of compiles in, on the suite's largest programs — the
# signature of a parallel-codegen race whose per-compile probability
# accumulates. Serialize codegen under pytest (compile is not what the
# suite measures).
_flags = os.environ.get("XLA_FLAGS", "")
if "parallel_codegen" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_cpu_parallel_codegen_split_count=1").strip()
# The persistent XLA compilation cache must NEVER be on under pytest:
# its writer segfaulted mid-suite (round-3 verdict weak #1b), and tests
# should not touch ~/.cache. utils/cache.enable_compilation_cache
# honors this hard opt-out, so cli/serve entry points invoked
# in-process by tests become cache no-ops.
os.environ["LPT_COMPILE_CACHE_OFF"] = "1"

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(__file__))

import pytest


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (full matrix; default lane skips "
             "them to keep an iteration run under ~10 min)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: expensive test (sharded equivalence, movie "
        "modes, multihost topologies, polarized volumetric); skipped "
        "unless --runslow")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (a kernel compiled for the card); "
        "skipped on other hosts, where chip_smoke.py's phases cover it")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow test: pass --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU. Decided here, at test
    time, so every xdist worker collects the same tests."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda on a card)")


@pytest.fixture(autouse=True, scope="module")
def _bound_live_executables():
    """Drop compiled-executable caches between test modules.

    Monolithic runs of the full suite have segfaulted inside
    backend_compile_and_load three times (rounds 3-4), always after
    hundreds of accumulated compiles (~50-60% through the suite, in
    whatever file happens to sit there) — while every file passes in a
    fresh process and a 4000-program synthetic compile storm does NOT
    reproduce it. Bounding the live compiled-program state per module
    keeps the process footprint near the known-good fresh-process
    regime; the cost is recompiling the few cross-module shared
    programs."""
    yield
    import jax
    jax.clear_caches()
