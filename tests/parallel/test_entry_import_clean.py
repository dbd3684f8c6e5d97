"""__graft_entry__ must import without initializing any JAX backend.

A module-scope device op (e.g. `EXACT_LML = float(... jnp.log(...))`)
would initialize the default backend at import, so `dryrun_multichip`
could no longer switch a one-GPU machine to the virtual CPU mesh, and a
process that imports the module would claim a card it may not use. The
in-suite dryrun test cannot catch this because tests/conftest.py forces
the CPU backend *before* the import.

These tests run in clean subprocesses with conftest's environment
overrides stripped and assert:
  1. importing the module leaves `jax._src.xla_bridge._backends` empty;
  2. `dryrun_multichip(8)` succeeds with ONLY
     `XLA_FLAGS=--xla_force_host_platform_device_count=8` set.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(__file__)))


def _plain_env(**overrides):
    """A plain environment: conftest's JAX overrides removed."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    env.update(overrides)
    return env


def test_import_initializes_no_backend():
    # Platform plugins may be registered, but no backend may be
    # *initialized* by the import: that would fix the platform before any
    # caller could choose it.
    code = (
        "import __graft_entry__\n"
        "import jax._src.xla_bridge as xb\n"
        "assert not xb._backends, (\n"
        "    'importing __graft_entry__ initialized backend(s): '\n"
        "    + repr(list(xb._backends))\n"
        ")\n"
        "print('import clean')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO,
        env=_plain_env(),
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, (
        f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    )
    assert "import clean" in proc.stdout


@pytest.mark.slow
def test_dryrun_runs_in_driver_environment():
    # A fresh interpreter with only the virtual-device flag set — no
    # JAX_PLATFORMS=cpu, no conftest. dryrun_multichip must do the
    # platform switch itself.
    code = (
        "import __graft_entry__ as g\n"
        "g.dryrun_multichip(8)\n"
        "import jax\n"
        "assert jax.default_backend() == 'cpu', jax.default_backend()\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO,
        env=_plain_env(
            XLA_FLAGS="--xla_force_host_platform_device_count=8"
        ),
        capture_output=True,
        text=True,
        timeout=590,
    )
    assert proc.returncode == 0, (
        f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    )
    assert "dryrun_multichip(8)" in proc.stdout
