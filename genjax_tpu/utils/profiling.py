"""Profiling helpers: `jax.profiler` trace capture and named scopes on
inference entry points.

The reference ships no profiling integration (SURVEY.md §5); this module
is new capability: wrap any inference step in `annotate` to get labelled
regions in profiler traces, or capture a full trace with
`profile_trace`.
"""

import contextlib
import functools
from typing import Callable

import jax


def annotate(name: str) -> Callable:
    """Decorator: wrap a function in a `jax.named_scope` so it appears as
    a labelled region in profiler traces and HLO."""

    def decorator(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with jax.named_scope(name):
                return fn(*args, **kwargs)

        return wrapped

    return decorator


@contextlib.contextmanager
def profile_trace(log_dir: str = "/tmp/genjax_tpu_profile"):
    """Capture a profiler trace (view with TensorBoard or xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def device_memory_stats(device=None) -> dict:
    """Live device memory counters (bytes) for capacity planning of
    particle/chain state: `bytes_in_use`, `peak_bytes_in_use`,
    `bytes_limit` where the backend reports them ({} where it doesn't,
    e.g. the CPU backend)."""
    device = device or jax.devices()[0]
    stats = device.memory_stats()
    return dict(stats) if stats else {}


def cost_summary(fn, *args, **kwargs) -> dict:
    """XLA cost analysis of `fn(*args)` as compiled: flops, bytes
    accessed, transcendentals. The framework's own performance work is
    driven by exactly this counter set (e.g. the shared-args layout was
    found via a 150 MB-vs-4 MB `bytes accessed` gap at identical flops
    — see ARCHITECTURE.md 4b).

    >>> import jax.numpy as jnp
    >>> from genjax_tpu.utils.profiling import cost_summary
    >>> s = cost_summary(lambda x: (x @ x.T).sum(), jnp.ones((64, 64)))
    >>> s["flops"] >= 2 * 64 * 64 * 64
    True
    """
    compiled = jax.jit(fn).lower(*args, **kwargs).compile()
    analysis = compiled.cost_analysis() or {}
    out = {
        k: float(analysis[k])
        for k in ("flops", "bytes accessed", "transcendentals")
        if k in analysis
    }
    out["memory_bytes"] = float(
        compiled.memory_analysis().temp_size_in_bytes
        if compiled.memory_analysis() is not None
        else 0.0
    )
    return out
