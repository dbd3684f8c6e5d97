"""Cookbook: custom proposals and mapping over inference.

Mirrors the reference cookbook's
inactive/inference/{custom_proposal,importance_sampling,mapping_tutorial}
notebooks: why prior proposals fail in the tails, writing a data-driven
proposal as a `@gen` program, plugging it into `Importance`/`ImportanceK`,
and vmapping whole inference pipelines over observations.
"""

import jax
import jax.numpy as jnp

import genjax_tpu as genjax
from genjax_tpu import ChoiceMap, Target, gen, normal
from genjax_tpu.inference.smc import Importance, ImportanceK


def main():
    key = jax.random.key(0)

    # Conjugate pair with a known posterior:
    #   mu ~ N(0, 1);  y ~ N(mu, 0.3)
    # Posterior given y: N(y/(1+0.09), sqrt(0.09/1.09)).
    @gen
    def model():
        mu = normal(0.0, 1.0) @ "mu"
        return normal(mu, 0.3) @ "y"

    y_obs = 2.5  # far in the prior's tail: prior proposals mostly miss
    target = Target(model, (), ChoiceMap.kw(y=y_obs))
    post_mean = y_obs / (1.0 + 0.09)
    post_std = jnp.sqrt(0.09 / 1.09)

    def lml_exact():
        var = 1.0 + 0.09
        return -0.5 * y_obs**2 / var - 0.5 * jnp.log(2 * jnp.pi * var)

    # --- default (prior) proposal ------------------------------------------
    prior_alg = ImportanceK(target, k_particles=100)
    keys = jax.random.split(key, 200)
    lml_prior = jax.vmap(
        lambda k: prior_alg.log_marginal_likelihood_estimate(k)
    )(keys)

    # --- custom proposal: a @gen program over the latent address ------------
    # A proposal is any SampleDistribution over (a subset of) the latents.
    # `marginal()` on a @gen program whose addresses match the target's
    # latents is the idiomatic way to build one. It may peek at the target
    # (its single argument) — here reading the observation to center
    # itself near the posterior.
    @genjax.marginal()
    @gen
    def smart_proposal(tgt):
        obs = tgt.constraint["y"]
        _ = normal(obs / 1.09, 0.4) @ "mu"

    smart_alg = ImportanceK(target, smart_proposal, k_particles=100)
    lml_smart = jax.vmap(
        lambda k: smart_alg.log_marginal_likelihood_estimate(k)
    )(keys)

    # Both are unbiased, but the data-driven proposal has far lower
    # variance in the tails:
    assert lml_smart.std() < 0.5 * lml_prior.std()
    assert jnp.abs(
        jax.scipy.special.logsumexp(lml_smart) - jnp.log(200) - lml_exact()
    ) < 0.02

    # Posterior samples via 1-particle importance with the custom proposal:
    one = Importance(target, smart_proposal)
    _, chm = one.random_weighted(jax.random.key(7), target)
    assert jnp.abs(chm["mu"] - post_mean) < 5 * post_std

    # --- mapping inference over data ----------------------------------------
    # Targets are pytrees, so a *batch of inference problems* is one
    # vmapped call — the accelerator-friendly way to amortize across observations.
    ys = jnp.linspace(-2.0, 2.0, 8)

    def infer_one(key, y):
        tgt = Target(model, (), ChoiceMap.kw(y=y))
        alg = ImportanceK(tgt, k_particles=200)
        _, chm = alg.random_weighted(key, tgt)
        return chm["mu"]

    mus = jax.vmap(infer_one)(jax.random.split(key, 8), ys)
    # posterior means scale like y/1.09
    assert jnp.corrcoef(mus, ys / 1.09)[0, 1] > 0.9

    print("custom-proposal cookbook: all checks passed")


if __name__ == "__main__":
    main()
