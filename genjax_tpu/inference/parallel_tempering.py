"""Replica-exchange MCMC (parallel tempering): a ladder of likelihood-
tempered chains that exchange temperatures so cold chains inherit the
mode-hopping mixing of hot ones.

New capability relative to the reference (SURVEY.md §2 C27 ships only
single-chain edit requests; nothing exchanges information across
chains). The bridge densities are `p(z) * p(y | z)^beta` — the same
family as `inference/tempered.py`, and the re-tempering identity is
shared: for any edit request whose full-joint MH ratio is `alpha_1`,
the ratio targeting the bridge at inverse temperature `beta` is
`alpha_1 - (1 - beta) * delta_loglik`, with `loglik` read off the GFI
as `trace.project(observed addresses)`.

Accelerator design notes:

- All T replicas advance as ONE vmapped tempered-MH sweep in the
  shared-args layout (per-leaf axes trees, one copy of the model data).
- The exchange step swaps TEMPERATURE ASSIGNMENTS — a (T,)-integer
  permutation `perm` with `perm[rank] = replica` — never replica
  states. Trace state (potentially MBs per replica) stays put in HBM;
  only the scalar beta ladder migrates, so a sweep's exchange phase is
  O(T) scalar work regardless of model size.
- Pairing follows the deterministic even-odd (DEO) schedule, alternating
  parity every sweep; non-reversible DEO maximizes ladder round-trip
  rates (Okabe et al. 2001; Syed et al. 2022, "Non-reversible parallel
  tempering").
- The whole run is one `lax.scan` over sweeps: dense selects for
  accept/reject, a vectorized pairwise swap, and a small gather of the
  cold replica's collected statistic. No data-dependent Python control
  flow anywhere.
"""

from typing import Any, Callable, Generic, TypeVar

import jax
import jax.numpy as jnp
import jax.tree_util as jtu

from genjax_tpu.core.choice_map import ChoiceMap, Selection
from genjax_tpu.core.concepts import EditRequest
from genjax_tpu.core.diff import Diff
from genjax_tpu.core.pytree import Pytree
from genjax_tpu.core.requests import Regenerate
from genjax_tpu.core.staging import where_tree
from genjax_tpu.core.typing import FloatArray, PRNGKey
from genjax_tpu.inference.mcmc import _chain_axes, share_chain_args
from genjax_tpu.inference.sp import Target

R = TypeVar("R")

__all__ = ["ParallelTempering", "PTResult", "tempered_mh"]


def tempered_mh(
    key: PRNGKey,
    trace,
    request: EditRequest,
    beta: FloatArray,
    obs_selection: Selection,
    loglik: FloatArray | None = None,
):
    """One MH step targeting the bridge `p(z) * p(y | z)^beta`.

    Works with any edit request: the full-joint acceptance ratio is
    re-tempered by subtracting `(1 - beta) * delta_loglik` (for
    `Regenerate`, whose GFI weight is the raw joint delta, the
    prior-proposal terms are first cancelled exactly as in
    `inference.mcmc._log_accept_ratio`). Passing the current `loglik`
    avoids recomputing the observed-address projection.

    Returns `(new_trace, new_loglik, accepted)`.
    """
    k_move, k_proj, k_acc = jax.random.split(key, 3)
    if loglik is None:
        loglik = trace.project(k_proj, obs_selection)
    proposed, w, _, _ = request.edit(
        k_move, trace, Diff.no_change(trace.get_args())
    )
    new_loglik = proposed.project(k_proj, obs_selection)
    delta_ll = new_loglik - loglik
    if isinstance(request, Regenerate):
        sel = request.selection
        proposal_term = proposed.project(k_proj, sel) - trace.project(
            k_proj, sel
        )
        alpha = (w - delta_ll) - proposal_term + beta * delta_ll
    else:
        alpha = w - (1.0 - beta) * delta_ll
    accepted = jnp.log(jax.random.uniform(k_acc)) < alpha
    new_trace = where_tree(accepted, proposed, trace)
    return new_trace, jnp.where(accepted, new_loglik, loglik), accepted


@Pytree.dataclass
class ParallelTempering(Generic[R], Pytree):
    """Replica-exchange MCMC over a beta ladder.

    `betas` is the (T,) inverse-temperature ladder, descending from
    `betas[0] = 1.0` (the cold chain whose samples are collected) toward
    hot, near-prior replicas. Within-temperature moves apply `request`
    (or `request_fn(beta)` for temperature-adapted kernels, e.g. wider
    drift scales when hot) `n_moves` times per sweep; the exchange phase
    then proposes DEO adjacent swaps.

    >>> import jax, jax.numpy as jnp
    >>> import genjax_tpu as gx
    >>> from genjax_tpu.inference import Target
    >>> from genjax_tpu.inference.parallel_tempering import ParallelTempering
    >>> from genjax_tpu.inference.requests import GaussianDrift
    >>> @gx.gen
    ... def model():
    ...     mu = gx.normal(0.0, 1.0) @ "mu"
    ...     _ = gx.normal(mu, 1.0) @ "y"
    >>> target = Target(model, (), gx.ChoiceMap.kw(y=1.0))
    >>> pt = ParallelTempering(
    ...     betas=jnp.array([1.0, 0.5, 0.25]),
    ...     request=GaussianDrift(gx.Selection.at["mu"], 0.8),
    ... )
    >>> out = pt.run(jax.random.key(0), target, 200,
    ...              collect=lambda t: t.get_choices()["mu"])
    >>> out.collected.shape
    (200,)
    >>> bool(jnp.all(out.swap_rates >= 0.0))
    True
    """

    betas: FloatArray = Pytree.field()
    request: EditRequest | None = Pytree.field(default=None)
    request_fn: Callable[[FloatArray], EditRequest] | None = Pytree.static(
        default=None
    )
    n_moves: int = Pytree.static(default=1)

    def _request_for(self, beta: FloatArray) -> EditRequest:
        if self.request_fn is not None:
            return self.request_fn(beta)
        assert self.request is not None, (
            "ParallelTempering needs `request` or `request_fn`."
        )
        return self.request

    def init(self, key: PRNGKey, target: Target[R], constraint=None):
        """Importance-initialize one replica per ladder rung (optionally
        from `constraint`, e.g. to start every replica at a known point)
        and return `(traces, logliks)` in the shared-args layout."""
        from genjax_tpu.inference.smc import share_constrained_values

        n = self.betas.shape[0]
        chm = ChoiceMap.empty() if constraint is None else constraint
        keys = jax.random.split(key, n)
        traces, _ = jax.vmap(target.importance, in_axes=(0, None))(keys, chm)
        traces = share_chain_args(traces, target.args)
        traces = share_constrained_values(traces, target.constraint, n)
        obs_sel = target.constraint.get_selection()
        axes = _chain_axes(traces, n)
        logliks = jax.vmap(
            lambda k, t: t.project(k, obs_sel), in_axes=(0, axes)
        )(keys, traces)
        return traces, logliks

    def run(
        self,
        key: PRNGKey,
        target: Target[R],
        n_sweeps: int,
        collect: Callable[[Any], Any] | None = None,
        init_constraint=None,
    ) -> "PTResult":
        """Run `n_sweeps` sweeps (moves + DEO exchange) as one
        `lax.scan`; collects `collect(trace)` from the replica currently
        holding `betas[0]` after every sweep."""
        n = self.betas.shape[0]
        betas = jnp.asarray(self.betas)
        obs_sel = target.constraint.get_selection()

        k_init, k_run = jax.random.split(key)
        traces, logliks = self.init(k_init, target, init_constraint)
        axes = _chain_axes(traces, n)

        def move(key, trace, loglik, beta):
            req = self._request_for(beta)
            for m in range(self.n_moves):
                trace, loglik, _ = tempered_mh(
                    jax.random.fold_in(key, m), trace, req, beta, obs_sel,
                    loglik,
                )
            return trace, loglik

        ranks = jnp.arange(n)

        def sweep(carry, scanned):
            traces, logliks, perm = carry
            sweep_key, parity = scanned
            k_move, k_swap = jax.random.split(sweep_key)

            # Each replica's current inverse temperature: replica
            # perm[r] holds ladder rung r.
            beta_by_replica = jnp.zeros(n).at[perm].set(betas)
            move_keys = jax.random.split(k_move, n)
            traces, logliks = jax.vmap(
                move, in_axes=(0, axes, 0, 0), out_axes=(axes, 0)
            )(move_keys, traces, logliks, beta_by_replica)

            # DEO exchange on adjacent rungs of parity `parity`. A swap
            # moves only the permutation entries; replica state stays put.
            ll_rank = logliks[perm]
            delta = (betas - jnp.roll(betas, -1)) * (
                jnp.roll(ll_rank, -1) - ll_rank
            )
            is_left = (ranks % 2 == parity) & (ranks < n - 1)
            u = jnp.log(jax.random.uniform(k_swap, (n,)))
            acc = is_left & (u < delta)
            acc_prev = jnp.roll(acc, 1).at[0].set(False)
            perm = jnp.where(
                acc,
                jnp.roll(perm, -1),
                jnp.where(acc_prev, jnp.roll(perm, 1), perm),
            )

            if collect is None:
                out = None
            else:
                per_replica = jax.vmap(collect, in_axes=(axes,))(traces)
                out = jtu.tree_map(lambda v: v[perm[0]], per_replica)
            return (traces, logliks, perm), (out, acc[:-1], is_left[:-1])

        sweep_keys = jax.random.split(k_run, n_sweeps)
        parities = jnp.arange(n_sweeps) % 2
        (traces, logliks, perm), (collected, accs, attempts) = jax.lax.scan(
            sweep, (traces, logliks, ranks), (sweep_keys, parities)
        )
        n_att = jnp.maximum(jnp.sum(attempts, axis=0), 1)
        swap_rates = jnp.sum(accs, axis=0) / n_att
        return PTResult(traces, logliks, perm, collected, swap_rates)


@Pytree.dataclass
class PTResult(Pytree):
    """Final replica states plus per-sweep cold-chain collection.

    `traces` are the T replica states (shared-args layout), `perm` the
    final rung->replica assignment (`perm[0]` is the cold replica),
    `collected` the stacked per-sweep `collect` outputs from the cold
    rung, and `swap_rates` the per-adjacent-pair empirical exchange
    acceptance rates (the ladder-tuning diagnostic: aim for roughly
    uniform 0.2-0.6; a near-zero rate means the ladder has a gap there).
    """

    traces: Any = Pytree.field()
    logliks: FloatArray = Pytree.field()
    perm: Any = Pytree.field()
    collected: Any = Pytree.field()
    swap_rates: FloatArray = Pytree.field()
