"""Sharded SVGD: Stein particle transport with the particle axis spanning
the device mesh.

New accelerator-native capability (the single-device SVGD driver is
`inference/svgd.py`; the reference has neither). SVGD's interaction
term is an N x N kernel against all particles, so sharding rows over
the mesh gives each device an (N/d, N) block of the kernel — computed
from two `all_gather`s per step (positions and gradients, each (N, D)
floats over ICI) followed by purely local matmuls. Log-density
gradients need no communication at all (each shard vmaps its own
particles), so the communication:compute ratio falls as D and the
per-shard particle count grow.

Bandwidth note: the median heuristic needs a global median of squared
distances; materializing the full N x N matrix on one chip would defeat
the sharding, so each shard takes the median of its own (N/d, N) block
and the blocks' medians are `pmean`-averaged — exact when shards are
statistically exchangeable (they are: particles are i.i.d. at init and
transported identically), and every shard uses the same resulting h.
Pass an explicit `bandwidth` for bit-exact parity with the dense
driver.
"""

from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from genjax_tpu.core.choice_map import ChoiceMap, Selection
from genjax_tpu.core.gfi import GenerativeFunction, Trace
from genjax_tpu.core.typing import PRNGKey
from genjax_tpu.inference.svgd import _prepare_particles, _rebuild_particles

__all__ = ["sharded_stein_direction", "sharded_svgd"]


def sharded_stein_direction(
    x_local: jax.Array,
    g_local: jax.Array,
    axis: str,
    n_total: int,
    bandwidth: float | None = None,
    kernel_dtype=None,
):
    """Per-shard rows of the Stein direction phi. Call inside
    `shard_map` with `x_local`/`g_local` the shard's (n_local, D)
    blocks; performs two `all_gather`s, then the fused single-matmul
    kernel block (`inference.svgd.stein_phi_block` — shared with the
    dense driver, so a given `h` gives bit-identical transport)."""
    x_all = jax.lax.all_gather(x_local, axis, tiled=True)
    g_all = jax.lax.all_gather(g_local, axis, tiled=True)
    if bandwidth is None:
        # Median over a column-capped local block (full-matrix medians
        # are a per-step n^2 sort — see inference/svgd.py::
        # _MEDIAN_SAMPLE), pmean-averaged so every shard uses the same h.
        from genjax_tpu.inference.svgd import _MEDIAN_SAMPLE

        m = min(x_all.shape[0], _MEDIAN_SAMPLE)
        x2_local = jnp.sum(x_local * x_local, axis=-1)
        x2_m = jnp.sum(x_all[:m] * x_all[:m], axis=-1)
        d2m = x2_local[:, None] + x2_m[None, :] - 2.0 * (
            x_local @ x_all[:m].T
        )
        h = jax.lax.pmean(
            jnp.median(jnp.maximum(d2m, 0.0)), axis
        ) / jnp.log(float(n_total + 1))
        h = jnp.maximum(h, 1e-12)
    else:
        h = jnp.asarray(bandwidth)
    from genjax_tpu.inference.svgd import stein_phi_block

    return stein_phi_block(x_local, x_all, g_all, h, n_total, kernel_dtype)


def sharded_svgd(
    key: PRNGKey,
    model: GenerativeFunction[Any],
    args: tuple,
    observations: ChoiceMap,
    selection: Selection,
    n_particles: int,
    n_steps: int,
    mesh: Mesh,
    axis: str = "particles",
    step_size: float = 0.1,
    bandwidth: float | None = None,
) -> tuple[Trace[Any], jax.Array]:
    """`inference.svgd.svgd` with the particle axis sharded over
    `mesh[axis]`. Returns `(traces, mean |phi| per step)`; the trace
    batch keeps the shared-args layout, with particle-batched leaves
    sharded over `axis`.

    `n_particles` must divide by the mesh axis size. With an explicit
    `bandwidth` the transport matches the dense driver exactly (same
    arithmetic, distributed); with the median heuristic, shards
    pmean-average their block medians (see module docstring).
    """
    n_dev = mesh.shape[axis]
    if n_particles % n_dev != 0:
        raise ValueError(
            f"sharded_svgd: n_particles={n_particles} must be divisible "
            f"by the '{axis}' mesh axis size {n_dev}."
        )
    k_init, k_edit = jax.random.split(key)
    traces, x0, unravel, complement, compl_axes = _prepare_particles(
        k_init, model, args, observations, selection, n_particles
    )

    def logp(vec, compl):
        full = unravel(vec).merge(compl)
        w, _ = model.assess(full, args)
        return w

    compl_specs = jtu.tree_map(
        lambda ax_leaf, v: P(axis, *([None] * (jnp.ndim(v) - 1)))
        if ax_leaf == 0
        else P(),
        compl_axes,
        complement,
        is_leaf=lambda x: x is None or isinstance(x, int),
    )

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), compl_specs),
        out_specs=(P(axis), P()),
        check_vma=False,
    )
    def transport(x_local, compl_local):
        grad_local = jax.vmap(jax.grad(logp), in_axes=(0, compl_axes))

        def step(x_loc, _):
            g_loc = grad_local(x_loc, compl_local)
            phi_loc = sharded_stein_direction(
                x_loc, g_loc, axis, n_particles, bandwidth
            )
            diag = jax.lax.pmean(jnp.mean(jnp.abs(phi_loc)), axis)
            return x_loc + step_size * phi_loc, diag

        return jax.lax.scan(step, x_local, None, length=n_steps)

    x, phi_norms = transport(x0, complement)
    new_traces = _rebuild_particles(
        k_edit, traces, x, unravel, args, n_particles
    )
    return new_traces, phi_norms
