"""Bootstrap particle filter for state-space models built from the GFI.

New capability relative to the reference (which ships no step-wise SMC
driver, SURVEY.md §2 C26): a `lax.scan`-over-time particle filter whose
per-step transition/observation model is any generative function of
signature `(z_prev, t) -> step trace` with an observation address.

Accelerator design: particles are a dense `(K, ...)` state pytree; each step is
`vmap(step_model.importance)` (one fused density evaluation per particle)
followed by search-free systematic resampling (cumsum + scatter +
`lax.cummax`, see `inference/smc.py`).
"""

from typing import Any, TypeVar

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
from jax.scipy.special import logsumexp

from genjax_tpu.core.choice_map import ChoiceMap
from genjax_tpu.core.gfi import GenerativeFunction
from genjax_tpu.core.pytree import Pytree
from genjax_tpu.core.typing import FloatArray, PRNGKey
from genjax_tpu.inference.smc import RESAMPLERS

R = TypeVar("R")


@Pytree.dataclass
class BootstrapFilter(Pytree):
    """Particle filter over a generative step model.

    `step_model(z_prev, t)` must trace the new latent state (returned as
    the step's return value) and the observation at address `obs_addr`.
    `init_model(t=0 args)` traces the initial state similarly.
    """

    step_model: GenerativeFunction[Any]
    init_model: GenerativeFunction[Any]
    n_particles: int = Pytree.static()
    obs_addr: str = Pytree.static(default="y")
    resampling: str = Pytree.static(default="systematic")
    ess_threshold: float = Pytree.static(default=0.5)

    def run(
        self, key: PRNGKey, observations: Any, model_args: tuple = (),
        collect=None,
    ) -> "tuple[FloatArray, Any] | tuple[FloatArray, Any, Any]":
        """Filter the observation sequence; returns (log marginal
        likelihood estimate, final particle states) — or, with `collect`,
        `(lml, final_states, collected)` where `collect(z, log_weights)`
        is evaluated at every time index (post-resampling state) and
        stacked along a leading T axis (e.g. the filtering mean
        `lambda z, lw: jnp.sum(jax.nn.softmax(lw) * z)`).

        `model_args` are extra (traced) arguments appended to both
        models' signatures — `init_model(*model_args)` and
        `step_model(z_prev, t, *model_args)` — the hook for
        parameter-dependent filters (e.g. `inference.pmmh.PMMH`, which
        re-runs the filter at each proposed parameter value).

        Resampling is ADAPTIVE (fires when ESS < ess_threshold * K) and
        realized with `lax.cond`, so steps that keep their weights skip
        the resampling pass entirely at runtime (set
        `ess_threshold >= 1.0` to resample every step). Weights carry
        across non-resampled steps; the LML telescopes exactly:
        `lml += logsumexp(lw) - log K` is banked at each resample and the
        remainder is settled at the end, which reduces to the per-step
        accumulation when resampling always fires.
        """
        from genjax_tpu.core.gather import take_rows
        from genjax_tpu.inference.smc import ess

        k_init, k_steps = jax.random.split(key)
        n = self.n_particles
        resampler = RESAMPLERS[self.resampling]

        obs0 = jtu.tree_map(lambda v: v[0], observations)
        init_keys = jax.random.split(k_init, n)
        init_trs, init_ws = jax.vmap(
            lambda k: self.init_model.importance(
                k, ChoiceMap.kw(**{self.obs_addr: obs0}), model_args
            )
        )(init_keys)
        z = init_trs.get_retval()

        def step(carry, inp):
            z, lw, lml, t = carry
            key, obs_t = inp
            k_prop, k_res = jax.random.split(key)
            prop_keys = jax.random.split(k_prop, n)
            trs, ws = jax.vmap(
                lambda k, z_i: self.step_model.importance(
                    k, ChoiceMap.kw(**{self.obs_addr: obs_t}), (z_i, t, *model_args)
                )
            )(prop_keys, z)
            z_new = trs.get_retval()
            lw = lw + ws

            def _resample(z, lw, lml):
                lml = lml + logsumexp(lw) - jnp.log(float(n))
                if self.resampling == "systematic":
                    # Streaming expansion: skips both the ancestor
                    # scatter and the per-index row gather (ops/expand.py).
                    from genjax_tpu.inference.smc import systematic_cum_counts
                    from genjax_tpu.ops.expand import expand_rows

                    cum = systematic_cum_counts(k_res, lw, n)
                    return expand_rows(z, cum, n_rows=n), jnp.zeros_like(lw), lml
                anc = resampler(k_res, lw, n)
                return take_rows(z, anc), jnp.zeros_like(lw), lml

            def _keep(z, lw, lml):
                return z, lw, lml

            z_new, lw, lml = jax.lax.cond(
                ess(lw) < self.ess_threshold * n,
                _resample,
                _keep,
                z_new,
                lw,
                lml,
            )
            out = collect(z_new, lw) if collect is not None else None
            return (z_new, lw, lml, t + 1), out

        T = jtu.tree_leaves(observations)[0].shape[0]
        step_keys = jax.random.split(k_steps, T - 1)
        rest_obs = jtu.tree_map(lambda v: v[1:], observations)
        (z_final, lw, lml, _), outs = jax.lax.scan(
            step,
            (z, init_ws, jnp.zeros(()), 1),
            (step_keys, rest_obs),
        )
        lml = lml + logsumexp(lw) - jnp.log(float(n))
        # One final resample so the returned states are equally weighted
        # (the historical contract; a single gather amortized over T steps).
        anc = resampler(jax.random.fold_in(k_steps, T), lw, n)
        z_out = take_rows(z_final, anc)
        if collect is None:
            return lml, z_out
        out0 = collect(z, init_ws)
        collected = jtu.tree_map(
            lambda a, rest: jnp.concatenate([a[None], rest], axis=0),
            out0,
            outs,
        )
        return lml, z_out, collected
