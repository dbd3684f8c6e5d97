"""Cookbook: replica-exchange MCMC (parallel tempering).

Multimodal posteriors defeat single-chain MCMC: a chain that equilibrates
inside one mode crosses to another only through a vanishing-probability
corridor. Parallel tempering runs a LADDER of chains targeting the
bridges `p(z) * p(y | z)^beta` — hot replicas (small beta) see a nearly
flat likelihood and roam freely; exchanges let cold chains inherit their
mode discoveries.

The accelerator-shaped design decisions (inference/parallel_tempering.py):

- all T replicas advance as ONE vmapped sweep (shared-args layout);
- exchanges swap scalar TEMPERATURE ASSIGNMENTS, never replica states —
  O(T) scalar work per sweep, no matter how big each trace is;
- the deterministic even-odd (DEO) schedule alternates which adjacent
  pairs may swap, maximizing ladder round trips;
- the whole run is one `lax.scan` — no Python control flow under jit.

On a mesh, `parallel.sharded_pt_run` shards the replica axis: the only
per-sweep collective is a (T,)-float all-gather of log-likelihoods.
"""

import jax
import jax.numpy as jnp
import numpy as np

import genjax_tpu as genjax
from genjax_tpu import ChoiceMap as C
from genjax_tpu import Selection as S
from genjax_tpu import gen, normal
from genjax_tpu.inference import Target
from genjax_tpu.inference.mcmc import mh_chain
from genjax_tpu.inference.parallel_tempering import ParallelTempering
from genjax_tpu.inference.requests import GaussianDrift


def main():
    # --- a bimodal posterior: y ~ N(mu^2, 0.3) with y = 4 puts symmetric
    # modes near mu = -2 and mu = +2, separated by a deep valley. ---
    @gen
    def model():
        mu = normal(0.0, 2.0) @ "mu"
        _ = normal(mu * mu, 0.3) @ "y"
        return mu

    target = Target(model, (), C.kw(y=4.0))
    drift = GaussianDrift(S.at["mu"], 0.5)

    # --- 1. a cold chain gets stuck in whichever mode it starts in ---
    tr, _ = model.importance(jax.random.key(0), C.kw(y=4.0, mu=2.0), ())
    _, cold = mh_chain(
        jax.random.key(1), tr, drift, 4000,
        collect=lambda t: t.get_choices()["mu"],
    )
    cold_neg = float(np.mean(np.asarray(cold[500:]) < 0))
    print(f"cold chain: fraction in the mu<0 mode = {cold_neg:.3f}")

    # --- 2. a geometric beta ladder fixes it. Rungs should be close
    # enough that adjacent swap rates land around 0.2-0.6. ---
    pt = ParallelTempering(
        betas=jnp.array([1.0, 0.5, 0.25, 0.1, 0.02]),
        request=drift,
        n_moves=2,  # moves per replica per sweep, between exchanges
    )
    out = jax.jit(
        lambda k: pt.run(
            k, target, 4000,
            collect=lambda t: t.get_choices()["mu"],
            init_constraint=C.kw(mu=2.0),  # same stuck start
        )
    )(jax.random.key(2))
    pt_neg = float(np.mean(np.asarray(out.collected[500:]) < 0))
    print(f"parallel tempering: fraction in the mu<0 mode = {pt_neg:.3f}")
    print("adjacent swap rates:", np.round(np.asarray(out.swap_rates), 2))
    assert pt_neg > max(0.1, cold_neg), "PT must visit both modes"

    # --- 3. ladder tuning: swap_rates IS the diagnostic. A near-zero
    # entry means a gap (insert a rung); near-one means wasted rungs.
    # Temperature-adapted kernels via request_fn: hot replicas take
    # bigger steps. ---
    pt_adapted = ParallelTempering(
        betas=jnp.array([1.0, 0.5, 0.25, 0.1, 0.02]),
        request_fn=lambda beta: GaussianDrift(
            S.at["mu"], 0.5 / jnp.sqrt(jnp.maximum(beta, 0.02))
        ),
        n_moves=2,
    )
    out2 = jax.jit(
        lambda k: pt_adapted.run(
            k, target, 2000, collect=lambda t: t.get_choices()["mu"]
        )
    )(jax.random.key(3))
    assert bool(jnp.all(out2.swap_rates > 0.02))
    print("adapted-kernel swap rates:", np.round(np.asarray(out2.swap_rates), 2))

    # --- 4. any edit request re-tempers: gradient-based moves work on
    # the bridges too (here MALA on the cold-to-hot ladder). ---
    from genjax_tpu.inference.requests import MALA

    pt_mala = ParallelTempering(
        betas=jnp.array([1.0, 0.4, 0.1]),
        request=MALA(S.at["mu"], 0.05),
    )
    out3 = jax.jit(
        lambda k: pt_mala.run(
            k, target, 500, collect=lambda t: t.get_choices()["mu"]
        )
    )(jax.random.key(4))
    assert bool(jnp.all(jnp.isfinite(out3.collected)))
    print("MALA-within-PT ok; final rung->replica perm:", out3.perm)


if __name__ == "__main__":
    main()
