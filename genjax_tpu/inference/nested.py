"""Nested sampling: model-evidence estimation with live-point shrinkage.

Beyond the reference (genjax-community/genjax has no evidence estimator
besides importance sampling; this repo adds tempered SMC and SMC² —
nested sampling (Skilling 2006) completes the set with the estimator of
choice for multimodal posteriors and evidence-based model comparison).

The algorithm maintains `n_live` prior samples ("live points"); each
iteration retires the lowest-likelihood point (banking its likelihood
against the deterministic prior-volume shrinkage X_i = exp(-i/N)) and
replaces it with a fresh prior draw constrained to exceed the retired
likelihood, obtained by constrained-prior MCMC started from a surviving
live point.

GFI mapping: for a `Target`-style (model, args, observations) triple,
the likelihood of a trace factors out of the joint score as
`loglik = score - project(latent_selection)` (the projection is exactly
the prior term), and the constrained-prior random walk is an `Update`
edit accepted with the PRIOR ratio (`project` delta) under the hard
likelihood constraint — no model-specific density code anywhere.

Accelerator notes: the outer loop is inherently sequential (one retirement per
iteration) but each iteration is one `lax.scan` body of dense work:
an argmin over the live set, `n_mcmc` Update-edit density evaluations,
and a masked scatter back into the live batch. All shapes static.
"""

from typing import Any

import jax
import jax.numpy as jnp
import jax.random as jrand
import jax.tree_util as jtu
from jax.scipy.special import logsumexp

from genjax_tpu.core.choice_map import ChoiceMap, Selection
from genjax_tpu.core.diff import Diff
from genjax_tpu.core.gfi import GenerativeFunction, Update
from genjax_tpu.core.pytree import Pytree
from genjax_tpu.core.staging import where_tree
from genjax_tpu.core.typing import PRNGKey

__all__ = ["NestedSampler"]


@Pytree.dataclass
class NestedSampler(Pytree):
    """Nested sampling over the continuous latents selected by
    `selection` of `model(*args)` given `observations`.

    `n_live` live points, `n_iters` retirements (choose
    `n_iters >~ n_live * H` for information H in nats; the returned
    `remainder_frac` diagnoses truncation), `n_mcmc` constrained-prior
    random-walk steps per replacement with per-leaf scale `step_scale`.

    `run` returns a dict: `lml` (evidence estimate, including the final
    live-point remainder), `dead_choices` / `dead_logliks` /
    `log_post_weights` (the retired points with posterior importance
    weights — resample by `softmax(log_post_weights)` for posterior
    draws), `accept_rate` (constrained-walk acceptance, tune
    `step_scale` toward ~0.3), and `remainder_frac` (evidence fraction
    contributed by the final live set; large values mean more
    iterations were needed).

    >>> import jax, jax.numpy as jnp
    >>> import genjax_tpu as gx
    >>> from genjax_tpu.inference.nested import NestedSampler
    >>> @gx.gen
    ... def model():
    ...     x = gx.normal(0.0, 1.0) @ "x"
    ...     _ = gx.normal(x, 0.5) @ "y"
    >>> ns = NestedSampler(model, (), gx.ChoiceMap.kw(y=1.0),
    ...                    gx.Selection.at["x"], n_live=100, n_iters=400)
    >>> out = ns.run(jax.random.key(0))
    >>> bool(jnp.isfinite(out["lml"]))
    True
    """

    model: GenerativeFunction[Any]
    args: tuple
    observations: ChoiceMap
    selection: Selection
    n_live: int = Pytree.static(default=500)
    n_iters: int = Pytree.static(default=2000)
    n_mcmc: int = Pytree.static(default=20)
    step_scale: Any = Pytree.field(default=0.5)

    def _loglik(self, key, trace):
        return trace.get_score() - trace.project(key, self.selection)

    def _constrained_walk(self, key, trace, loglik, lstar, argdiffs):
        """`n_mcmc` random-walk steps invariant for the prior restricted
        to {loglik > lstar}: propose values + scale * xi, accept on the
        prior-density ratio AND the hard likelihood constraint."""

        def step(carry, step_key):
            trace, loglik, n_acc = carry
            k_prop, k_edit, k_proj, k_acc = jrand.split(step_key, 4)
            values = trace.get_choices().filter(self.selection)
            leaves_ct = len(jtu.tree_leaves(values))
            seeds = jtu.tree_unflatten(
                jtu.tree_structure(values), list(range(leaves_ct))
            )
            proposed = jtu.tree_map(
                lambda v, s: v
                + self.step_scale
                * jrand.normal(jrand.fold_in(k_prop, s), jnp.shape(v)),
                values,
                seeds,
            )
            cand, _, _, _ = Update(proposed).edit(k_edit, trace, argdiffs)
            cand_ll = self._loglik(k_proj, cand)
            prior_delta = cand.project(k_proj, self.selection) - trace.project(
                k_proj, self.selection
            )
            accept = jnp.logical_and(
                jnp.log(jrand.uniform(k_acc)) < prior_delta,
                cand_ll > lstar,
            )
            new_trace = where_tree(accept, cand, trace)
            new_ll = jnp.where(accept, cand_ll, loglik)
            return (new_trace, new_ll, n_acc + accept), None

        (trace, loglik, n_acc), _ = jax.lax.scan(
            step, (trace, loglik, jnp.zeros((), jnp.int32)),
            jrand.split(key, self.n_mcmc),
        )
        return trace, loglik, n_acc

    def run(self, key: PRNGKey) -> dict:
        from genjax_tpu.inference.mcmc import _chain_axes, share_chain_args

        n = self.n_live
        k_init, k_proj, k_scan = jrand.split(key, 3)
        init_keys = jrand.split(k_init, n)
        live, _ = jax.vmap(
            lambda k: self.model.importance(k, self.observations, self.args)
        )(init_keys)
        # Shared-args layout (ARCHITECTURE.md 4b): one copy of the model
        # args for the whole live set; the per-iteration donor gather and
        # worst scatter below only touch the genuinely per-point leaves.
        live = share_chain_args(live, self.args)
        axes = _chain_axes(live, n)
        logliks = jax.vmap(
            lambda tr: self._loglik(k_proj, tr), in_axes=(axes,)
        )(live)
        argdiffs = Diff.no_change(self.args)

        def iteration(carry, it_key):
            live, logliks = carry
            k_pick, k_walk = jrand.split(it_key)
            worst = jnp.argmin(logliks)
            lstar = logliks[worst]
            dead_choices = jtu.tree_map(
                lambda v: v[worst], live.get_choices().filter(self.selection)
            )

            # Clone a surviving point (never the worst itself) and walk
            # it within the constrained prior.
            offset = jrand.randint(k_pick, (), 1, n)
            donor = (worst + offset) % n
            seed_tr = jtu.tree_map(
                lambda ax, v: v[donor] if ax == 0 else v,
                axes,
                live,
                is_leaf=lambda x: x is None,
            )
            seed_ll = logliks[donor]
            new_tr, new_ll, n_acc = self._constrained_walk(
                k_walk, seed_tr, seed_ll, lstar, argdiffs
            )

            live = jtu.tree_map(
                lambda ax, batch, leaf: batch.at[worst].set(leaf)
                if ax == 0
                else batch,
                axes,
                live,
                new_tr,
                is_leaf=lambda x: x is None,
            )
            logliks = logliks.at[worst].set(new_ll)
            return (live, logliks), (dead_choices, lstar, n_acc)

        (live, logliks), (dead, dead_ll, n_accs) = jax.lax.scan(
            iteration, (live, logliks), jrand.split(k_scan, self.n_iters)
        )

        # Evidence: dead shells use the deterministic shrinkage
        # X_i = exp(-i/N); the surviving live set contributes the final
        # volume X_T / N each.
        i = jnp.arange(1, self.n_iters + 1, dtype=jnp.float32)
        log_x = -i / float(n)
        log_prev = jnp.concatenate([jnp.zeros(1), log_x[:-1]])
        # log(X_{i-1} - X_i) = log_prev + log(1 - exp(-1/N))
        log_w = log_prev + jnp.log1p(-jnp.exp(-1.0 / float(n)))
        log_dead_terms = dead_ll + log_w
        log_live_terms = logliks + log_x[-1] - jnp.log(float(n))
        lml = logsumexp(jnp.concatenate([log_dead_terms, log_live_terms]))
        remainder = logsumexp(log_live_terms)
        return {
            "lml": lml,
            "dead_choices": dead,
            "dead_logliks": dead_ll,
            "log_post_weights": log_dead_terms - lml,
            "accept_rate": jnp.mean(n_accs / float(self.n_mcmc)),
            "remainder_frac": jnp.exp(remainder - lml),
            "live_logliks": logliks,
        }
