"""MCMC drivers: Metropolis-Hastings acceptance wrapper and vectorized
chain runners.

The reference leaves accept/reject and chain loops to user code (its
tests hand-roll MH loops, `tests/inference/test_requests.py:94-141`);
this module packages them as first-class, `vmap`/`shard_map`-ready
drivers — `mh` (one accept/reject step for any weight-returning edit
request), `mh_chain` (a `lax.scan` chain), and `run_chains` (vectorized
parallel chains, the BASELINE.md "8k chains" pattern).
"""

from typing import Any, Callable, TypeVar

import jax
import jax.numpy as jnp
import jax.tree_util as jtu

from genjax_tpu.core.concepts import EditRequest
from genjax_tpu.core.diff import Diff
from genjax_tpu.core.gfi import Trace
from genjax_tpu.core.typing import PRNGKey

R = TypeVar("R")


def _log_accept_ratio(
    key: PRNGKey, trace: Trace[R], proposed: Trace[R], request: EditRequest, w
):
    """Convert an edit weight into the MH log accept ratio.

    For `Rejuvenate`/`HMC`/`MALA` the SMCP3 weight already *is* the accept
    ratio. For `Regenerate(sel)`, the GFI weight is the full joint score
    delta (reference semantics, `distribution.py:258-300`); the
    prior-proposal terms at the regenerated addresses must be subtracted
    to obtain the accept ratio (Gen/MH semantics):
    `alpha = w - (project(new, sel) - project(old, sel))`.
    """
    from genjax_tpu.core.requests import Regenerate

    if isinstance(request, Regenerate):
        sel = request.selection
        return w - (proposed.project(key, sel) - trace.project(key, sel))
    return w


def mh(
    key: PRNGKey, trace: Trace[R], request: EditRequest
) -> tuple[Trace[R], Any]:
    """One Metropolis-Hastings step: apply `request` and accept/reject
    with the exact MH ratio (see `_log_accept_ratio`).

    Returns `(new_trace, accepted)`; realized with dense `where` selects
    (both branches present, no control flow) — the accelerator-native MH step.

    Block moves through `Switch`: regenerating an address that feeds a
    switch index (e.g. a mixture's `"mixture_component"`) re-simulates
    the entire selected branch, because the index is dynamic under jit.
    The selection must therefore cover the branch subtree too —
    `S["m", "mixture_component"] | S["m", "component_sample", ...]` —
    or the acceptance ratio misses the fresh branch's proposal density
    and the sampler is biased (see tests/inference/test_mixture_mh.py).

    >>> import jax
    >>> import genjax_tpu as gx
    >>> from genjax_tpu.inference.mcmc import mh
    >>> @gx.gen
    ... def model():
    ...     mu = gx.normal(0.0, 1.0) @ "mu"
    ...     _ = gx.normal(mu, 1.0) @ "obs"
    >>> tr, _ = model.importance(jax.random.key(0), gx.ChoiceMap.kw(obs=1.0), ())
    >>> new_tr, accepted = mh(jax.random.key(1), tr, gx.Regenerate(gx.Selection.at["mu"]))
    >>> bool(accepted) in (True, False)
    True
    """
    k_move, k_accept = jax.random.split(key)
    proposed, w, _, _ = request.edit(
        k_move, trace, Diff.no_change(trace.get_args())
    )
    alpha = _log_accept_ratio(k_move, trace, proposed, request, w)
    accept = jnp.log(jax.random.uniform(k_accept)) < alpha
    # Identity-aware select (core.staging.where_tree): leaves the edit
    # passed through untouched (model args, unedited subtrace values) are
    # the SAME tracer on both sides — selecting them would materialize a
    # copy of the whole trace per step (hundreds of MB at 8k chains).
    from genjax_tpu.core.staging import where_tree

    return where_tree(accept, proposed, trace), accept


def mh_chain(
    key: PRNGKey,
    trace: Trace[R],
    request: EditRequest,
    n_steps: int,
    collect: Callable[[Trace[R]], Any] | None = None,
) -> tuple[Trace[R], Any]:
    """Run `n_steps` MH steps as a `lax.scan`; `collect(trace)` extracts
    the per-step statistic recorded along the chain (defaults to the
    acceptance flag only).

    >>> import jax
    >>> import genjax_tpu as gx
    >>> from genjax_tpu.inference.mcmc import mh_chain
    >>> @gx.gen
    ... def model():
    ...     mu = gx.normal(0.0, 1.0) @ "mu"
    ...     _ = gx.normal(mu, 1.0) @ "obs"
    >>> tr, _ = model.importance(jax.random.key(0), gx.ChoiceMap.kw(obs=1.0), ())
    >>> final, mus = mh_chain(
    ...     jax.random.key(1), tr, gx.Regenerate(gx.Selection.at["mu"]),
    ...     100, collect=lambda t: t.get_choices()["mu"],
    ... )
    >>> mus.shape
    (100,)
    """

    def step(carry, step_key):
        trace = carry
        new_trace, accepted = mh(step_key, trace, request)
        out = collect(new_trace) if collect is not None else accepted
        return new_trace, out

    keys = jax.random.split(key, n_steps)
    final_trace, outs = jax.lax.scan(step, trace, keys)
    return final_trace, outs


def gibbs_sweep(
    key: PRNGKey,
    trace: Trace[R],
    selections,
) -> Trace[R]:
    """One Gibbs-style sweep: an MH-with-prior-regeneration step for each
    address block in `selections`, in order. With conjugate full
    conditionals this is systematic-scan Metropolis-within-Gibbs."""
    from genjax_tpu.core.requests import Regenerate

    for i, sel in enumerate(selections):
        trace, _ = mh(jax.random.fold_in(key, i), trace, Regenerate(sel))
    return trace


def gibbs_chain(
    key: PRNGKey,
    trace: Trace[R],
    selections,
    n_sweeps: int,
    collect: Callable[[Trace[R]], Any] | None = None,
):
    """`n_sweeps` Gibbs sweeps as a `lax.scan`."""
    selections = tuple(selections)

    def sweep(trace, sweep_key):
        new_trace = gibbs_sweep(sweep_key, trace, selections)
        out = collect(new_trace) if collect is not None else None
        return new_trace, out

    keys = jax.random.split(key, n_sweeps)
    return jax.lax.scan(sweep, trace, keys)


def enumerative_gibbs(
    key: PRNGKey, trace: Trace[R], addr, values
) -> Trace[R]:
    """Exact Gibbs move on a discrete site: enumerate the candidate
    `values` (an array with the candidates along axis 0), score each via
    an `Update` weight — `w(v) = log p(trace with addr=v) - log p(trace)`,
    so `softmax(w)` IS the full conditional — and apply the drawn value.
    No conjugacy derivation needed; always accepted; works wherever the
    site's support is small enough to enumerate (mixture assignments,
    regime indicators). `addr` is a top-level string or a nested address
    tuple.

    Caveat: the site must not gate model STRUCTURE. Enumerating a
    `Switch` index makes `Update` fresh-simulate the newly-active
    branch's unconstrained choices, so the weight is a joint-over-fresh-
    values estimate, not the marginal conditional of the index — use the
    block-`Regenerate` MH move for structural indices (see cookbook
    ch. 8 / tests/inference/test_mixture_mh.py).

    All candidates are scored with one `vmap` of the edit — a dense
    (n_values,)-batched density evaluation, the accelerator-native shape for
    enumeration.

    >>> import jax, jax.numpy as jnp
    >>> import genjax_tpu as gx
    >>> from genjax_tpu.inference.mcmc import enumerative_gibbs
    >>> @gx.gen
    ... def model():
    ...     z = gx.categorical(jnp.log(jnp.array([0.5, 0.5]))) @ "z"
    ...     _ = gx.normal(jnp.where(z == 0, -1.0, 1.0), 1.0) @ "y"
    >>> tr, _ = model.importance(jax.random.key(0), gx.ChoiceMap.kw(y=0.9), ())
    >>> new_tr = enumerative_gibbs(
    ...     jax.random.key(1), tr, "z", jnp.arange(2))
    >>> int(new_tr.get_choices()["z"]) in (0, 1)
    True
    """
    from genjax_tpu.core.choice_map import ChoiceMapBuilder
    from genjax_tpu.core.gfi import Update

    path = (addr,) if isinstance(addr, str) else tuple(addr)
    k_score, k_draw, k_apply = jax.random.split(key, 3)
    argdiffs = Diff.no_change(trace.get_args())

    def constraint(v):
        return ChoiceMapBuilder[path].set(v)

    def weight_of(v):
        _, w, _, _ = Update(constraint(v)).edit(k_score, trace, argdiffs)
        return w

    ws = jax.vmap(weight_of)(values)
    idx = jax.random.categorical(k_draw, ws)
    chosen = jtu.tree_map(lambda v: v[idx], values)
    new_trace, _, _, _ = Update(constraint(chosen)).edit(
        k_apply, trace, argdiffs
    )
    return new_trace


def share_chain_args(traces: Trace[R], args: tuple) -> Trace[R]:
    """Replace a batch-of-chains trace's per-chain argument copies with
    ONE shared (unbatched) copy.

    A `vmap`-built chain batch broadcasts the model arguments into every
    chain's trace; for data-conditioned models that N×data copy is most
    of the trace, and every density evaluation inside HMC/MALA re-reads
    its own copy — turning one shared-operand matmul into a batched
    matmul over N identical operands. `run_chains` detects the unbatched
    leaves (no leading chain axis) and maps them with `in_axes=None`, so
    the compiled program reads the single shared copy.

    Shared-vs-batched is distinguished by the leading dimension, so an
    argument leaf whose OWN leading dimension happens to equal the batch
    size is ambiguous: such leaves are left in their (correct, merely
    unoptimized) broadcast form rather than shared."""
    import dataclasses

    n = jnp.shape(traces.get_score())[0]

    def pick(shared, batched):
        ambiguous = (
            getattr(shared, "ndim", 0) >= 1 and jnp.shape(shared)[0] == n
        )
        return batched if ambiguous else shared

    new_args = jtu.tree_map(pick, args, traces.get_args())
    return dataclasses.replace(traces, args=new_args)


def _chain_axes(tree, n_chains: int):
    """Per-leaf vmap axes for a chain batch: 0 for leaves carrying the
    leading chain axis, None for shared (unbatched) leaves."""
    return jtu.tree_map(
        lambda v: 0
        if getattr(v, "ndim", 0) >= 1 and v.shape[0] == n_chains
        else None,
        tree,
    )


def run_chains(
    key: PRNGKey,
    traces: Trace[R],
    request: EditRequest,
    n_steps: int,
    collect: Callable[[Trace[R]], Any] | None = None,
    n_chains: int | None = None,
):
    """Vectorized MH over a batch of chains (traces with a leading chain
    axis). Shard the chain axis with `genjax_tpu.parallel.chains` to run
    across the device mesh.

    Leaves WITHOUT the chain axis (e.g. shared model arguments after
    `share_chain_args`) are mapped as broadcast (`in_axes=None`) and stay
    a single copy through the whole chain program. (A shared leaf whose
    leading dimension happens to equal the chain count is
    indistinguishable from a batched one — pass an explicit `n_chains`
    or reshape in that unlikely case.)"""
    if n_chains is None:
        n_chains = jnp.shape(traces.get_score())[0]
    axes = _chain_axes(traces, n_chains)
    keys = jax.random.split(key, n_chains)
    return jax.vmap(
        lambda k, tr: mh_chain(k, tr, request, n_steps, collect),
        in_axes=(0, axes),
        out_axes=(axes, 0),
    )(keys, traces)
