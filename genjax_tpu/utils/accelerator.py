"""Host-side set-up shared by the scripts that run on the card
(`chip_smoke.py`, `bench.py`): the persistent compile cache, the GPU
requirement, and the card's name and power limit. Nothing here runs on
package import; the scripts call it from `main`."""

import os
import pathlib
import subprocess

import jax

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir(root, environ=os.environ) -> str:
    """The persistent compile cache's directory: `$JAX_COMPILATION_CACHE_DIR`
    when it is set, else `<root>/.jax_cache`. The fallback is a fixed path
    inside the checkout (never a temporary name) so that the next run
    finds what this one stored.

    >>> compile_cache_dir("/repo", {})
    '/repo/.jax_cache'
    >>> compile_cache_dir("/repo", {"JAX_COMPILATION_CACHE_DIR": "/cache"})
    '/cache'
    """
    return environ.get(CACHE_ENV) or str(pathlib.Path(root) / ".jax_cache")


def use_compile_cache(root) -> str:
    """Point JAX's persistent compile cache at `compile_cache_dir(root)`
    and return that directory."""
    path = compile_cache_dir(root)
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpus(count: int) -> list:
    """The first `count` devices, which must be GPUs. Exits nonzero when
    JAX finds fewer: there is no CPU fallback."""
    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < count:
        raise SystemExit(
            f"needs {count} GPU(s); JAX found {len(devices)} "
            f"{devices[0].platform} device(s)"
        )
    return devices[:count]


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for every card, one line
    each. Runs as a child process that does not import JAX."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return proc.stdout.strip()
