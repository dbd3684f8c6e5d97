"""Dirichlet-categorical Gaussian mixture model + conjugate Gibbs sampler.

The application model of the reference cookbook
`docs/cookbook/inactive/update/7_application_dirichlet_mixture_model.ipynb`:
cluster means with a normal prior, mixture weights with a Dirichlet
prior, categorical assignments per datapoint, Gaussian observations —
and a Gibbs sweep whose three blocks are all *exact* conjugate updates
(accept probability 1), realized as `Update` edits so the trace's joint
score stays exact throughout.

Accelerator notes: every Gibbs block is dense over the data/cluster axes (one
(N, K) density matrix per assignment block, `segment_sum`s for the
sufficient statistics) and the whole sweep jits into a single XLA
program via `lax.scan`.
"""

from functools import partial

import jax
import jax.numpy as jnp

from genjax_tpu import ChoiceMap, Const, categorical, dirichlet, gen, normal
from genjax_tpu.core.typing import PRNGKey

import math as _math

# python float, NOT a jnp op: a module-level jnp call initializes the
# backend at import time, fixing the platform (and claiming a card)
# before the caller can choose one
_HALF_LOG_2PI = 0.5 * _math.log(2.0 * _math.pi)


def make_gmm(
    k: int,
    n: int,
    alpha: float = 1.0,
    mu0: float = 0.0,
    sigma0: float = 10.0,
    obs_sigma: float = 0.5,
):
    """Build the mixture model (a generative function of no arguments).

    Addresses: `"means"` (K,), `"probs"` (K,), `"idx"` (N,), `"obs"` (N,).
    """
    alphas = jnp.full((k,), alpha)

    @gen
    def gmm():
        means = normal(mu0, sigma0, sample_shape=Const((k,))) @ "means"
        probs = dirichlet(alphas) @ "probs"
        idx = categorical(logits=jnp.log(probs), sample_shape=Const((n,))) @ "idx"
        _ = normal(means[idx], obs_sigma) @ "obs"
        return means

    return gmm


def _normal_lp(v, mu, sigma):
    return -0.5 * ((v - mu) / sigma) ** 2 - jnp.log(sigma) - _HALF_LOG_2PI


@partial(jax.jit, static_argnames=("k", "n_sweeps"))
def run_gibbs(
    key: PRNGKey,
    observations,
    k: int,
    n_sweeps: int = 100,
    alpha: float = 1.0,
    mu0: float = 0.0,
    sigma0: float = 10.0,
    obs_sigma: float = 0.5,
):
    """Exact conjugate Gibbs over (idx | rest), (probs | rest),
    (means | rest). Returns the final trace.

    Each block samples from its exact full conditional and applies it
    with a single vectorized `Update` edit; because the conditional is
    exact, the move is always accepted and the chain's stationary
    distribution is the posterior.
    """
    n = observations.shape[0]
    model = make_gmm(k, n, alpha, mu0, sigma0, obs_sigma)
    key, k_init = jax.random.split(key)
    trace, _ = model.importance(k_init, ChoiceMap.kw(obs=observations), ())

    def sweep(trace, key):
        chm = trace.get_choices()
        means, probs, idx = chm["means"], chm["probs"], chm["idx"]
        k_idx, k_probs, k_means, k_next = jax.random.split(key, 4)

        # -- assignments: exact categorical posterior per datapoint ------
        # (N, K) joint densities; one dense matrix, no per-point loop.
        lp = jnp.log(probs)[None, :] + _normal_lp(
            observations[:, None], means[None, :], obs_sigma
        )
        new_idx = jax.random.categorical(k_idx, lp, axis=-1)
        trace, _, _, _ = trace.update(k_idx, ChoiceMap.kw(idx=new_idx), ())

        # -- weights: Dirichlet-categorical conjugacy ---------------------
        counts = jnp.zeros(k).at[new_idx].add(1.0)
        new_probs = jax.random.dirichlet(k_probs, alpha + counts)
        trace, _, _, _ = trace.update(k_probs, ChoiceMap.kw(probs=new_probs), ())

        # -- means: normal-normal conjugacy per cluster -------------------
        sums = jnp.zeros(k).at[new_idx].add(observations)
        prec = 1.0 / sigma0**2 + counts / obs_sigma**2
        post_mean = (mu0 / sigma0**2 + sums / obs_sigma**2) / prec
        post_std = jax.lax.rsqrt(prec)
        new_means = post_mean + post_std * jax.random.normal(k_means, (k,))
        trace, _, _, _ = trace.update(k_means, ChoiceMap.kw(means=new_means), ())

        return trace, None

    keys = jax.random.split(key, n_sweeps)
    trace, _ = jax.lax.scan(sweep, trace, keys)
    return trace


def simulate_gmm_data(key: PRNGKey, n: int, true_means, true_probs, obs_sigma=0.5):
    """Draw `n` observations from a known mixture (test fixture)."""
    k_idx, k_obs = jax.random.split(key)
    idx = jax.random.categorical(k_idx, jnp.log(true_probs), shape=(n,))
    obs = true_means[idx] + obs_sigma * jax.random.normal(k_obs, (n,))
    return idx, obs
