"""Particle smoothing: forward-filter backward-sample (FFBS) over stored
particle clouds.

Beyond the reference (its FFBS lives only inside the exact DiscreteHMM
distribution, `_src/.../discrete_hmm.py:98-192`): a GENERIC particle
smoother for any `BootstrapFilter`-style model. Filtering clouds answer
"where is the state NOW"; smoothed trajectories answer "where WAS it,
given everything observed since" — the difference is a backward pass
that reweights each step's cloud by the transition density to the
already-chosen next state (Godsill, Doucet & West 2004):

    P(pick particle i at t) ~ w_t^i * f(z_{t+1}^chosen | z_t^i).

Accelerator shape: run the filter once storing clouds+weights via the `collect`
hook; the backward pass is a `lax.scan` over time whose body scores one
vmapped `assess` of the step model against the whole cloud per drawn
trajectory (M trajectories vectorize with an inner vmap), then draws one
categorical — dense (M, K) work per step, no Python loops.
"""

from typing import Any

import jax
import jax.numpy as jnp
import jax.tree_util as jtu

from genjax_tpu.core.choice_map import ChoiceMap
from genjax_tpu.core.typing import FloatArray, PRNGKey
from genjax_tpu.inference.particle_filter import BootstrapFilter

__all__ = ["ffbs_sample", "smoothing_clouds"]


def smoothing_clouds(
    filter: BootstrapFilter,
    key: PRNGKey,
    observations: Any,
    model_args: tuple = (),
):
    """Run the filter storing per-step clouds; returns
    `(lml, clouds (T, K, ...), log_weights (T, K))` — the inputs
    `ffbs_sample` needs."""
    out = filter.run(
        key, observations, model_args, collect=lambda z, lw: (z, lw)
    )
    lml, _, (clouds, lws) = out
    return lml, clouds, lws


def ffbs_sample(
    key: PRNGKey,
    filter: BootstrapFilter,
    clouds: Any,
    log_weights: FloatArray,
    n_paths: int,
    observations: Any,
    model_args: tuple = (),
    latent_addr: str = "z",
):
    """Draw `n_paths` smoothed trajectories from stored filtering clouds.

    `clouds` / `log_weights` come from `smoothing_clouds` (leaves with
    leading axes (T, K)); `observations` is the same sequence the filter
    ran on. Returns a pytree with leading axes `(n_paths, T)`.

    Preconditions (the `BootstrapFilter` contract plus two FFBS-specific
    ones): the step model's RETURN VALUE must equal the choice traced at
    `latent_addr` (the stored cloud values are constrained back into the
    model to read transition densities), and the observation density may
    depend on the NEW latent only, not on `z_prev` (the observation term
    must be constant across cloud members so it cancels in the backward
    categorical — a `z_prev`-dependent emission would bias the weights).
    """
    T = jtu.tree_leaves(clouds)[0].shape[0]
    obs_addr = filter.obs_addr

    # assess(step_model, {z: z_next, y: y_t}) = log f(z_next | z_i) +
    # log g(y_t | z_next); the g term is constant across cloud members i
    # and cancels inside the backward categorical. Scoring against the
    # TRUE observation keeps the g term finite for any observation
    # support (a dummy value outside the support would -inf every
    # weight) and shape-correct for vector observations.
    def trans_scores(z_next, cloud_t, y_t, t):
        def one(z_i):
            score, _ = filter.step_model.assess(
                ChoiceMap.kw(**{latent_addr: z_next, obs_addr: y_t}),
                (z_i, t, *model_args),
            )
            return score

        return jax.vmap(one)(cloud_t)

    k_last, k_back = jax.random.split(key)
    last_cloud = jtu.tree_map(lambda v: v[-1], clouds)
    idx_last = jax.random.categorical(
        k_last, log_weights[-1], shape=(n_paths,)
    )
    z_last = jtu.tree_map(lambda v: v[idx_last], last_cloud)

    # backward over t = T-2 .. 0; inputs reversed via scan(reverse=True)
    def back(carry, inp):
        z_next = carry  # (n_paths, ...) pytree
        cloud_t, lw_t, y_next, t, step_key = inp

        def draw(k, z_n):
            scores = trans_scores(z_n, cloud_t, y_next, t + 1)
            idx = jax.random.categorical(k, lw_t + scores)
            return jtu.tree_map(lambda v: v[idx], cloud_t)

        keys = jax.random.split(step_key, n_paths)
        z_t = jax.vmap(draw)(keys, z_next)
        return z_t, z_t

    clouds_head = jtu.tree_map(lambda v: v[:-1], clouds)
    lw_head = log_weights[:-1]
    # the transition from t to t+1 is scored with observation y_{t+1}
    obs_next = jtu.tree_map(lambda v: v[1:], observations)
    ts = jnp.arange(T - 1)
    step_keys = jax.random.split(k_back, T - 1)
    _, path_head = jax.lax.scan(
        back, z_last, (clouds_head, lw_head, obs_next, ts, step_keys),
        reverse=True,
    )
    # stack: head is (T-1, n_paths, ...), append the t = T-1 states
    full = jtu.tree_map(
        lambda h, last: jnp.concatenate([h, last[None]], axis=0),
        path_head,
        z_last,
    )
    return jtu.tree_map(lambda v: jnp.swapaxes(v, 0, 1), full)
