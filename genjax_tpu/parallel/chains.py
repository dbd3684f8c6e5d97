"""Sharded MCMC chains: the chain axis spans the device mesh.

Chains are embarrassingly parallel — the only collectives are optional
cross-chain diagnostics (`psum` means for R-hat style statistics). Inside
each shard, chains vectorize with `vmap` (dense batched leapfrog /
proposal arithmetic).
"""

from functools import partial
from typing import Any, Callable, TypeVar

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from genjax_tpu.core.concepts import EditRequest
from genjax_tpu.core.gfi import Trace
from genjax_tpu.core.typing import PRNGKey

R = TypeVar("R")


def sharded_mh_chains(
    key: PRNGKey,
    traces: Trace[R],
    request: EditRequest,
    n_steps: int,
    mesh: Mesh,
    axis: str = "chains",
    collect: Callable[[Trace[R]], Any] | None = None,
):
    """Run MH chains (leading chain axis of `traces`) sharded over `axis`.

    Returns `(final_traces, collected)` with the chain axis sharded in the
    output as well.
    """
    from genjax_tpu.inference.mcmc import mh_chain

    n_chains = jnp.shape(traces.get_score())[0]
    keys = jax.random.split(key, n_chains)

    # Leaves carrying the leading chain axis shard over it; shared leaves
    # (e.g. model args after `mcmc.share_chain_args`) replicate — and the
    # per-shard vmap must treat them as broadcast too (matching per-leaf
    # axes, as in `mcmc.run_chains`).
    def _is_chain_leaf(v) -> bool:
        return jnp.ndim(v) >= 1 and jnp.shape(v)[0] == n_chains

    trace_specs = jtu.tree_map(
        lambda v: P(axis, *([None] * (jnp.ndim(v) - 1)))
        if _is_chain_leaf(v)
        else P(),
        traces,
    )
    vmap_axes = jtu.tree_map(lambda v: 0 if _is_chain_leaf(v) else None, traces)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), trace_specs),
        out_specs=(trace_specs, P(axis)),
        check_vma=False,
    )
    def _run(keys, traces):
        return jax.vmap(
            lambda k, tr: mh_chain(k, tr, request, n_steps, collect),
            in_axes=(0, vmap_axes),
            out_axes=(vmap_axes, 0),
        )(keys, traces)

    return _run(keys, traces)
