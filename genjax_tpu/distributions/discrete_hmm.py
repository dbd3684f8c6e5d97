"""Exact-posterior discrete HMM: forward filtering backward sampling
(FFBS), exact data marginals, and the `DiscreteHMM` distribution over
latent paths.

Capability parity with reference
`_src/generative_functions/distributions/custom/discrete_hmm.py:42-267`
(`DiscreteHMMConfiguration` with circulant transition/observation tensors,
`forward_filtering_backward_sampling`, `DiscreteHMM` with exact
`estimate_logpdf` / data marginal). The reference leans on
`tfd.HiddenMarkovModel` for marginals; this build computes them directly
with a `lax.scan` forward algorithm (logsumexp recursions are dense
matrix-ish ops, ideal for the accelerator's vector and matrix units).
"""

from typing import Any

import jax
import jax.numpy as jnp
from jax.scipy.special import logsumexp

from genjax_tpu.core.concepts import Score
from genjax_tpu.core.pytree import Pytree
from genjax_tpu.core.typing import FloatArray, IntArray, PRNGKey
from genjax_tpu.distributions.distribution import Distribution


def _circulant(source: jnp.ndarray) -> jnp.ndarray:
    """Circulant matrix whose first column is `source` (pure JAX)."""
    n = source.shape[0]
    idx = (jnp.arange(n)[:, None] - jnp.arange(n)[None, :]) % n
    return source[idx]


def scaled_circulant(N: int, k: int, epsilon, delta) -> jnp.ndarray:
    """Banded circulant logit tensor: entries within distance `k` of the
    diagonal get `epsilon^|distance|`, the rest `-delta`."""
    index = jnp.arange(N)
    vals = jnp.where(
        index <= k,
        jnp.asarray(epsilon) ** jnp.abs(index),
        jnp.where(
            index - N >= -k,
            jnp.asarray(epsilon) ** jnp.abs(index - N),
            -jnp.asarray(delta),
        ),
    )
    return _circulant(vals)


@Pytree.dataclass
class DiscreteHMMConfiguration(Pytree):
    """Grid-structured HMM with banded-circulant transition/observation
    logits (the reference's exact-inference testbed family)."""

    linear_grid_dim: int = Pytree.static()
    adjacency_distance_trans: int = Pytree.static()
    adjacency_distance_obs: int = Pytree.static()
    sigma_trans: float = Pytree.static()
    sigma_obs: float = Pytree.static()

    def transition_tensor(self) -> FloatArray:
        if self.sigma_trans > 0.0:
            return scaled_circulant(
                self.linear_grid_dim,
                self.adjacency_distance_trans,
                self.sigma_trans,
                1.0 / self.sigma_trans,
            )
        return scaled_circulant(
            self.linear_grid_dim, self.adjacency_distance_trans, -jnp.inf, jnp.inf
        )

    def observation_tensor(self) -> FloatArray:
        if self.sigma_obs > 0.0:
            return scaled_circulant(
                self.linear_grid_dim,
                self.adjacency_distance_obs,
                self.sigma_obs,
                1.0 / self.sigma_obs,
            )
        return scaled_circulant(
            self.linear_grid_dim, self.adjacency_distance_obs, -jnp.inf, jnp.inf
        )

    def prior_logits(self) -> FloatArray:
        init = self.linear_grid_dim // 2
        return jax.nn.log_softmax(self.transition_tensor()[init, :])

    def transition_log_probs(self) -> FloatArray:
        return jax.nn.log_softmax(self.transition_tensor(), axis=-1)

    def observation_log_probs(self) -> FloatArray:
        return jax.nn.log_softmax(self.observation_tensor(), axis=-1)


def forward_filter(
    prior: FloatArray, trans: FloatArray, obs: FloatArray, observations: IntArray
):
    """Forward algorithm: returns per-step filtering distributions
    `p(z_t | x_{1:t})` (log space) and the exact log data marginal.

    `prior`: [N] log p(z_0); `trans`: [N, N] log p(z_t | z_{t-1}) with
    rows indexed by z_{t-1}; `obs`: [N, M] log p(x | z).
    """

    def step(carry, x_t):
        log_alpha, t = carry
        # predict: p(z_t | x_{1:t-1})
        pred = jnp.where(
            t == 0,
            log_alpha,
            logsumexp(log_alpha[:, None] + trans, axis=0),
        )
        post = pred + obs[:, x_t]
        log_evidence_t = logsumexp(post)
        filtered = post - log_evidence_t
        return (filtered, t + 1), (filtered, log_evidence_t)

    (_, _), (filters, log_evidences) = jax.lax.scan(
        step, (prior, 0), observations
    )
    return filters, jnp.sum(log_evidences)


def backward_sample(
    key: PRNGKey, trans: FloatArray, filters: FloatArray
) -> IntArray:
    """Backward pass of FFBS: sample `z_T` from the last filter, then
    `z_{t} ~ p(z_t | x_{1:t}, z_{t+1})` backwards."""
    T = filters.shape[0]

    def step(carry, xs):
        key, next_z = carry
        t, filt = xs
        key, sub_key = jax.random.split(key)
        logits = jnp.where(
            t == T - 1,
            filt,
            filt + trans[:, next_z],
        )
        z = jax.random.categorical(sub_key, logits)
        return (key, z), z

    ts = jnp.arange(T - 1, -1, -1)
    flipped_filters = jnp.flip(filters, axis=0)
    (_, _), zs_rev = jax.lax.scan(step, (key, 0), (ts, flipped_filters))
    return jnp.flip(zs_rev)


def forward_filtering_backward_sampling(
    key: PRNGKey, config: DiscreteHMMConfiguration, observation_sequence: IntArray
):
    """Sample an exact posterior latent path for the configured HMM."""
    prior = config.prior_logits()
    trans = config.transition_log_probs()
    obs = config.observation_log_probs()
    filters, _ = forward_filter(prior, trans, obs, observation_sequence)
    samples = backward_sample(key, trans, filters)
    return key, (samples, filters)


def path_joint_logpdf(
    prior: FloatArray,
    trans: FloatArray,
    obs: FloatArray,
    latents: IntArray,
    observations: IntArray,
) -> Score:
    """log p(z_{1:T}, x_{1:T}) for a concrete latent path."""
    z0 = latents[0]
    init_term = prior[z0]
    trans_terms = trans[latents[:-1], latents[1:]]
    obs_terms = obs[latents, observations]
    return init_term + jnp.sum(trans_terms) + jnp.sum(obs_terms)


@Pytree.dataclass
class _DiscreteHMM(Distribution[Any]):
    """Distribution over latent paths of a discrete HMM, with *exact*
    posterior sampling (FFBS) and exact posterior density — the
    ground-truth oracle used to validate approximate inference."""

    def data_logpdf(
        self, config: DiscreteHMMConfiguration, observations: IntArray
    ) -> Score:
        """Exact log marginal p(x_{1:T}) via the forward algorithm."""
        _, log_marginal = forward_filter(
            config.prior_logits(),
            config.transition_log_probs(),
            config.observation_log_probs(),
            observations,
        )
        return log_marginal

    def random_weighted(
        self, key: PRNGKey, config: DiscreteHMMConfiguration, observations: IntArray
    ):
        prior = config.prior_logits()
        trans = config.transition_log_probs()
        obs = config.observation_log_probs()
        filters, log_marginal = forward_filter(prior, trans, obs, observations)
        latents = backward_sample(key, trans, filters)
        score = (
            path_joint_logpdf(prior, trans, obs, latents, observations) - log_marginal
        )
        return score, latents

    def estimate_logpdf(
        self,
        key: PRNGKey,
        v: IntArray,
        config: DiscreteHMMConfiguration,
        observations: IntArray,
    ) -> Score:
        """Exact posterior density log p(z | x) = log p(z, x) - log p(x)."""
        prior = config.prior_logits()
        trans = config.transition_log_probs()
        obs = config.observation_log_probs()
        _, log_marginal = forward_filter(prior, trans, obs, observations)
        return path_joint_logpdf(prior, trans, obs, v, observations) - log_marginal


DiscreteHMM = _DiscreteHMM()
