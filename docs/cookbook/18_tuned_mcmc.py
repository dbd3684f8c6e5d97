"""Cookbook: tuned MCMC at scale — warmup adaptation, preconditioned
HMC, convergence diagnostics, and particle marginal MH.

These are capabilities beyond the reference (genjax-community/genjax
ships raw HMC with a user-chosen step size and no diagnostics): the
many-chain layout this framework runs on an accelerator makes the full Stan-style
warmup cheap — the mass matrix is a one-step cross-chain variance — and
split R-hat / ESS read convergence straight off the `(chains, steps)`
sample array.
"""

import jax
import jax.numpy as jnp

import genjax_tpu as genjax
from genjax_tpu import ChoiceMap as C
from genjax_tpu import Selection, gen, normal
from genjax_tpu.inference.adaptation import warmup_chains
from genjax_tpu.inference.diagnostics import effective_sample_size, split_rhat
from genjax_tpu.inference.mcmc import run_chains
from genjax_tpu.inference.particle_filter import BootstrapFilter
from genjax_tpu.inference.pmmh import PMMH
from genjax_tpu.inference.requests import HMC


# A badly-scaled target: two posterior scales 100x apart. Unit-mass HMC
# cannot pick one eps that serves both dimensions.
@gen
def aniso():
    slow = normal(0.0, 0.1) @ "slow"
    fast = normal(0.0, 10.0) @ "fast"
    return slow + fast


def main():
    # --- 1. warmup: step size + mass matrix from the chain batch ---
    keys = jax.random.split(jax.random.key(0), 256)
    trs = jax.vmap(lambda k: aniso.simulate(k, ()))(keys)
    sel = Selection.at["slow"] | Selection.at["fast"]
    warmed, tuned = jax.jit(
        lambda k, t: warmup_chains(k, t, sel, n_steps=120, L=8)
    )(jax.random.key(1), trs)
    # the metric recovered both scales; acceptance sits near the 0.8 target
    assert 0.0025 < float(tuned.inv_mass["slow"]) < 0.04
    assert 25.0 < float(tuned.inv_mass["fast"]) < 400.0
    assert 0.6 < float(tuned.accept_rate) < 0.95

    # --- 2. sample with the tuned kernel (keep the trajectory jitter!) ---
    req = HMC(sel, tuned.eps, 8, tuned.inv_mass, jitter=0.2)
    final, samples = run_chains(
        jax.random.key(2), warmed, req, 120,
        collect=lambda t: t.get_choices()["fast"],
    )

    # --- 3. diagnostics on the (chains, steps) array ---
    post = samples[:, 40:]
    rhat = float(split_rhat(post))
    ess = float(effective_sample_size(post))
    assert rhat < 1.05, rhat
    assert ess > 0.1 * post.size  # well-mixed, not a frozen resonance
    assert abs(float(jnp.var(post)) - 100.0) < 35.0

    # --- 3b. ChEES: automatic trajectory lengths (the NUTS alternative
    # that keeps a SIMD chain batch fully utilized) ---
    from genjax_tpu.inference.chees import chees_warmup, run_chees_chains

    keys2 = jax.random.split(jax.random.key(6), 128)
    trs2 = jax.vmap(lambda k: aniso.simulate(k, ()))(keys2)
    # no mass matrix: the trajectory length must grow to traverse the
    # slow coordinate (optimum ~ pi * sigma_max / 2 ~ 15.7)
    warmed2, tuned2 = jax.jit(
        lambda k, t: chees_warmup(k, t, sel, n_steps=150, adapt_mass=False)
    )(jax.random.key(7), trs2)
    assert float(tuned2.trajectory_length) > 4.0
    final2, _ = run_chees_chains(
        jax.random.key(8), warmed2, sel, tuned2, 150
    )
    assert abs(float(jnp.var(final2.get_choices()["fast"])) - 100.0) < 50.0

    # --- 3c. NUTS: per-draw adaptive trajectories. The static-budget
    # formulation costs 2^max_depth - 1 gradient passes per draw no
    # matter when the trajectory turns, which is exactly what SIMD
    # batching requires anyway — but for LARGE chain batches ChEES
    # (above) extracts the same adaptivity at ~1 trajectory per draw.
    # One-call version: sample_posterior(..., algorithm="nuts"). ---
    from genjax_tpu.inference.requests import NUTS
    from genjax_tpu.inference.requests.nuts import nuts_warmup

    keys3 = jax.random.split(jax.random.key(9), 64)
    trs3 = jax.vmap(lambda k: aniso.simulate(k, ()))(keys3)
    warmed3, tuned3 = nuts_warmup(
        jax.random.key(10), trs3, sel, n_steps=60, max_depth=6
    )
    # warmup finds the 100x mass-scale split on its own
    assert (
        float(tuned3.inv_mass["fast"]) / float(tuned3.inv_mass["slow"]) > 100
    )
    final3, _ = run_chains(
        jax.random.key(11), warmed3,
        NUTS(sel, tuned3.eps, 6, tuned3.inv_mass), 60,
    )
    assert abs(float(jnp.var(final3.get_choices()["fast"])) - 100.0) < 50.0

    # --- 4. PMMH: learn a state-space model's parameter ---
    @gen
    def init_model(a):
        z = normal(0.0, 1.0) @ "z"
        _ = normal(z, 0.4) @ "y"
        return z

    @gen
    def step_model(z_prev, t, a):
        z = normal(a * z_prev, 0.5) @ "z"
        _ = normal(z, 0.4) @ "y"
        return z

    ys = jnp.array([0.3, 1.0, 0.5, -0.2, 0.8, 1.4, 0.9, 0.1, -0.3, 0.6])
    pf = BootstrapFilter(step_model, init_model, 512, obs_addr="y")
    alg = PMMH(
        pf,
        log_prior=lambda a: normal.logpdf(a, 0.0, 1.0),
        step_scales=jnp.asarray(0.25),
    )
    _, (a_chain, lmls, accepts) = jax.jit(
        lambda k: alg.run(k, jnp.asarray(0.0), ys, n_steps=150)
    )(jax.random.key(3))
    assert bool(jnp.isfinite(lmls).all())
    assert 0.05 < float(jnp.mean(accepts)) < 0.95

    print("tuned mcmc cookbook OK")


if __name__ == "__main__":
    main()
