"""Approximate Bayesian computation: likelihood-free inference from
the GFI's simulator.

Beyond the reference (genjax-community/genjax has no likelihood-free
machinery; every algorithm it ships needs `assess`). ABC targets models
where only SIMULATION is available — the posterior is approximated by
matching summaries of simulated data to the observed summary within a
tolerance. In GFI terms nothing new is needed: `importance` with the
latents constrained IS the simulator p(x | theta), and `project` scores
the prior — so ABC here works for any generative function, with the
observation sites simply left unconstrained.

`ABCSMC` is the adaptive SMC sampler of Del Moral et al. (2012) in its
dense, fixed-shape form (the vectorized variant): each generation
tightens the tolerance to a quantile of the current population's
distances, resamples the survivors, and applies MCMC moves whose
"likelihood" is the tolerance indicator — no rejection loops, no
dynamic shapes, every stage a vmap/scan.
"""

from typing import Any, Callable

import jax
import jax.numpy as jnp
import jax.random as jrand
import jax.tree_util as jtu

from genjax_tpu.core.choice_map import Selection
from genjax_tpu.core.diff import Diff
from genjax_tpu.core.gfi import GenerativeFunction, Trace, Update
from genjax_tpu.core.pytree import Pytree
from genjax_tpu.core.staging import where_tree
from genjax_tpu.core.typing import PRNGKey
from genjax_tpu.inference.smc import systematic_resample
from genjax_tpu.core.gather import take_rows

__all__ = ["ABCSMC", "abc_rejection"]


def abc_rejection(
    key: PRNGKey,
    model: GenerativeFunction[Any],
    args: tuple,
    summary_fn: Callable[[Trace[Any]], Any],
    observed_summary: Any,
    tolerance: float,
    n_particles: int,
) -> dict:
    """Plain rejection ABC: simulate `n_particles` traces from the
    prior, accept those whose summary lands within `tolerance`
    (Euclidean) of the observed summary. Returns the full batch with an
    `accepted` mask (dense — filter on the host if needed), distances,
    and the acceptance rate."""
    keys = jrand.split(key, n_particles)
    traces = jax.vmap(lambda k: model.simulate(k, args))(keys)
    s = jax.vmap(summary_fn)(traces)
    d = jax.vmap(
        lambda si: jnp.sqrt(
            jnp.sum(jnp.square(jnp.asarray(si) - jnp.asarray(observed_summary)))
        )
    )(s)
    accepted = d < tolerance
    return {
        "traces": traces,
        "distances": d,
        "accepted": accepted,
        "accept_rate": jnp.mean(accepted.astype(jnp.float32)),
    }


@Pytree.dataclass
class ABCSMC(Pytree):
    """Adaptive ABC-SMC over the latents selected by `selection`.

    `summary_fn(trace) -> vector` computes the data summary;
    `observed_summary` is its target. Each of `n_generations` the
    tolerance drops to the `quantile` of the surviving distances,
    survivors are systematically resampled, and `n_moves` indicator-MH
    moves (Gaussian perturbation scaled by `move_scale` x the
    population std per dimension, fresh data simulated through
    `importance`) rejuvenate the population.

    `run` returns: `traces` (the final population — equally weighted
    draws from the eps-final ABC posterior), `distances`, `epsilons`
    (the adaptive schedule), and `accept_rate` (mean MH acceptance).

    >>> import jax, jax.numpy as jnp
    >>> import genjax_tpu as gx
    >>> from genjax_tpu.inference.abc import ABCSMC
    >>> @gx.gen
    ... def model():
    ...     t = gx.normal(0.0, 1.0) @ "theta"
    ...     _ = gx.normal(t, 0.5) @ "y"
    >>> alg = ABCSMC(model, (), gx.Selection.at["theta"],
    ...              summary_fn=lambda tr: tr.get_choices()["y"],
    ...              observed_summary=1.0, n_particles=256,
    ...              n_generations=5)
    >>> out = alg.run(jax.random.key(0))
    >>> out["epsilons"].shape
    (5,)
    """

    model: GenerativeFunction[Any]
    args: tuple
    selection: Selection
    summary_fn: Callable[[Trace[Any]], Any] = Pytree.static()
    observed_summary: Any = Pytree.field(default=None)
    n_particles: int = Pytree.static(default=1024)
    n_generations: int = Pytree.static(default=8)
    n_moves: int = Pytree.static(default=5)
    quantile: float = Pytree.static(default=0.5)
    move_scale: float = Pytree.static(default=1.0)

    def _distance(self, trace):
        s = jnp.asarray(self.summary_fn(trace))
        return jnp.sqrt(
            jnp.sum(jnp.square(s - jnp.asarray(self.observed_summary)))
        )

    def _flat_latents(self, traces):
        vals = traces.get_choices().filter(self.selection)
        from jax.flatten_util import ravel_pytree

        template = jtu.tree_map(lambda v: v[0], vals)
        _, unravel = ravel_pytree(template)
        flat = jax.vmap(lambda t: ravel_pytree(t)[0])(vals)
        return flat, unravel

    def _move(self, key, trace, d, eps, scales):
        """One indicator-MH move: perturb latents, re-simulate data,
        accept on the prior ratio AND the tolerance indicator."""
        from jax.flatten_util import ravel_pytree

        # Build argdiffs from THIS trace's args (not the constructor's
        # copies): under `lax.scan` the shared arg leaves are carry
        # tracers, and `where_tree`'s identity shortcut only keeps them
        # unbatched if the edit passes the very same tracers through
        # (the `mh` driver pattern).
        argdiffs = Diff.no_change(trace.get_args())
        k_prop, k_gen, k_proj, k_acc = jrand.split(key, 4)
        vals = trace.get_choices().filter(self.selection)
        flat, unravel = ravel_pytree(vals)
        prop = flat + scales * jrand.normal(k_prop, flat.shape)
        cand, _, _, _ = Update(unravel(prop)).edit(k_gen, trace, argdiffs)
        # fresh data given the proposed latents: regenerate everything
        # NOT selected (the observation sites) by one more edit
        from genjax_tpu.core.requests import Regenerate

        cand, _, _, _ = Regenerate(~self.selection).edit(
            jrand.fold_in(k_gen, 1), cand, argdiffs
        )
        d_cand = self._distance(cand)
        prior_delta = cand.project(k_proj, self.selection) - trace.project(
            k_proj, self.selection
        )
        accept = jnp.logical_and(
            jnp.log(jrand.uniform(k_acc)) < prior_delta, d_cand <= eps
        )
        return (
            where_tree(accept, cand, trace),
            jnp.where(accept, d_cand, d),
            accept,
        )

    def run(self, key: PRNGKey) -> dict:
        from genjax_tpu.inference.mcmc import _chain_axes, share_chain_args

        n = self.n_particles
        k_init, k_gens = jrand.split(key)
        init_keys = jrand.split(k_init, n)
        traces = jax.vmap(lambda k: self.model.simulate(k, self.args))(
            init_keys
        )
        # Shared-args layout (ARCHITECTURE.md 4b): model args stored once,
        # not broadcast per particle; gathers and move vmaps below honor
        # the per-leaf axes accordingly.
        traces = share_chain_args(traces, self.args)
        tr_axes = _chain_axes(traces, n)
        d = jax.vmap(self._distance, in_axes=(tr_axes,))(traces)

        def generation(carry, gen_key):
            traces, d, acc_sum = carry
            k_res, k_moves = jrand.split(gen_key)
            eps = jnp.quantile(d, self.quantile)
            # <= not <: when the population collapses (or summaries are
            # discrete) the quantile can EQUAL the minimum distance, and
            # a strict < would leave zero survivors — softmax of an
            # all -inf weight vector is NaN and silently corrupts every
            # later generation.
            lw = jnp.where(d <= eps, 0.0, -jnp.inf)
            anc = systematic_resample(k_res, lw, n)
            traces, d = take_rows((traces, d), anc, n_rows=n)

            flat, _ = self._flat_latents(traces)
            scales = self.move_scale * jnp.std(flat, axis=0) + 1e-8

            def one_sweep(carry, sweep_key):
                traces, d, acc = carry
                move_keys = jrand.split(sweep_key, n)
                traces, d, accs = jax.vmap(
                    lambda k, t, di: self._move(k, t, di, eps, scales),
                    in_axes=(0, tr_axes, 0),
                    out_axes=(tr_axes, 0, 0),
                )(move_keys, traces, d)
                return (traces, d, acc + jnp.mean(accs.astype(jnp.float32))), None

            (traces, d, acc_sum), _ = jax.lax.scan(
                one_sweep,
                (traces, d, acc_sum),
                jrand.split(k_moves, self.n_moves),
            )
            return (traces, d, acc_sum), eps

        (traces, d, acc_sum), epsilons = jax.lax.scan(
            generation,
            (traces, d, jnp.zeros(())),
            jrand.split(k_gens, self.n_generations),
        )
        total = float(self.n_generations * self.n_moves)
        return {
            "traces": traces,
            "distances": d,
            "epsilons": epsilons,
            "accept_rate": acc_sum / total,
        }
