"""Test configuration.

Runs the tests on the CPU with 8 virtual devices, so multi-device
sharding code paths are exercised without a multi-card machine (the
standard JAX pattern for testing `shard_map`/`jit` sharding code). The
platform is also set through `jax.config`, which takes effect as long as
no backend has been initialized (true at conftest import time).

An explicit `JAX_PLATFORMS` wins, so that the tests marked `gpu` can run
on a card: `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`. Elsewhere
those tests skip, deciding inside the `gpu` fixture below.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
_PLATFORM = os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", _PLATFORM)


# ---------------------------------------------------------------------------
# Smoke tier: `pytest -m smoke` runs a <5-minute cross-subsystem proof
# subset (every module's cheapest exactness tests). Membership lives in
# tests/smoke_set.txt as node-id prefixes, one per line; keep it fast —
# the full suite is the correctness gate, smoke is the iteration loop.
# ---------------------------------------------------------------------------
import pathlib

import pytest

_SMOKE_FILE = pathlib.Path(__file__).parent / "smoke_set.txt"


def pytest_collection_modifyitems(config, items):
    if not _SMOKE_FILE.exists():
        return
    prefixes = [
        ln.strip()
        for ln in _SMOKE_FILE.read_text().splitlines()
        if ln.strip() and not ln.startswith("#")
    ]
    for item in items:
        nodeid = item.nodeid.replace("\\", "/")
        if any(nodeid.startswith(p) for p in prefixes):
            item.add_marker(pytest.mark.smoke)


# ---------------------------------------------------------------------------
# Guard against kernel mmap-budget exhaustion: XLA:CPU maps ~3 anonymous
# regions per compiled executable and the full suite compiles tens of
# thousands, so one pytest process crosses the `vm.max_map_count` default
# (65530) around the 1000-test mark — at which point LLVM's code-buffer
# mmap fails and the process dies with a SIGSEGV deep inside
# `backend_compile_and_load` (reproduced: the map count read 65403 on the
# sample taken seconds before the crash). `jax.clear_caches()` releases
# the executables (verified: 3850 maps -> 475), so drop the caches
# whenever the map count crosses a safety threshold. Costs a handful of
# recompiles per suite run; tests never share compilations across
# modules anyway.
# ---------------------------------------------------------------------------
import gc

_MAPS_FILE = pathlib.Path("/proc/self/maps")
_MAPS_LIMIT = 40_000


def _map_count() -> int:
    try:
        with _MAPS_FILE.open("rb") as fh:
            return sum(1 for _ in fh)
    except OSError:
        return 0


@pytest.fixture(autouse=True)
def _cap_jit_mappings():
    yield
    if _map_count() > _MAPS_LIMIT:
        jax.clear_caches()
        gc.collect()


@pytest.fixture
def gpu():
    """The first device, for tests marked `gpu`; skips where it is not a
    GPU. Decided here, at run time, so every worker collects the same
    tests."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")
    return device
