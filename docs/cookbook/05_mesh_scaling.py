"""Cookbook: scaling inference over a device mesh.

Run on GPUs, or on CPU with
`XLA_FLAGS=--xla_force_host_platform_device_count=8` for a virtual mesh.
"""

import jax
import jax.numpy as jnp

import genjax_tpu as genjax
from genjax_tpu import ChoiceMap, Regenerate, Selection, Target, gen, normal
from genjax_tpu.parallel import (
    ShardedSMC,
    particle_mesh,
    shard_leading_axis,
    sharded_mh_chains,
)


@gen
def model():
    x = normal(0.0, 1.0) @ "x"
    y = normal(x, 1.0) @ "y"
    return y


def main():
    # --- particle-parallel SMC over the mesh ---
    mesh = particle_mesh()  # 1-D mesh over all devices
    smc = ShardedSMC(n_particles=4096, mesh=mesh, ess_threshold=2.0)
    target = Target(model, (), ChoiceMap.kw(y=1.0))

    @jax.jit
    def smc_round(key):
        col = smc.init(key, target)                       # sharded init
        lml = smc.lml(col)                                # psum logsumexp
        col = smc.maybe_resample(jax.random.fold_in(key, 1), col)
        col = smc.rejuvenate(
            jax.random.fold_in(key, 2), col, Regenerate(Selection.at["x"])
        )
        return lml, col

    lml, col = smc_round(jax.random.key(0))
    exact = -0.25 - 0.5 * jnp.log(2 * jnp.pi * 2.0)
    assert jnp.abs(lml - exact) < 0.1

    # --- chain-parallel MCMC over the mesh ---
    cmesh = particle_mesh(axis_name="chains")
    keys = jax.random.split(jax.random.key(1), 256)
    trs = jax.vmap(lambda k: model.importance(k, ChoiceMap.kw(y=1.0), ())[0])(keys)
    trs = shard_leading_axis(trs, cmesh, "chains")
    finals, _ = sharded_mh_chains(
        jax.random.key(2), trs, Regenerate(Selection.at["x"]), 100, cmesh, "chains"
    )
    assert jnp.abs(jnp.mean(finals.get_choices()["x"]) - 0.5) < 0.15

    # --- multi-host: islands over DCN, particles over ICI ---
    # The island decomposition runs the SAME GridSMC driver with its
    # chain axis on the slow interconnect tier: islands never exchange
    # particles, only O(1) scalar diagnostics; per-island LML estimates
    # pool without bias in density space. Single-process this degrades
    # to a reshaped local mesh, so the code is identical in tests and
    # on a pod (after `initialize_multihost()`).
    from genjax_tpu.parallel import hybrid_mesh, island_smc, pooled_lml

    n_dev = len(jax.devices())
    hmesh = (
        hybrid_mesh(island_devices=2, particle_devices=n_dev // 2)
        if n_dev >= 2
        else hybrid_mesh()
    )
    islands = island_smc(n_islands=2, n_particles=2048, mesh=hmesh)
    col = jax.jit(islands.init)(jax.random.key(3), target)
    lmls = jax.jit(islands.per_chain_lml)(col)           # (2,) per island
    assert jnp.abs(pooled_lml(lmls) - exact) < 0.1
    col = jax.jit(islands.maybe_resample)(jax.random.key(4), col)

    # --- feature-packing: many small-D problems in one SVGD transport ---
    # A D=16 posterior gives each Stein contraction only 16-33 columns.
    # packed_svgd runs C same-shaped problems (folds / groups /
    # replicates) as ONE joint transport on the product target — at
    # C*D = 128 the matmuls are 128 wide, and each
    # problem's marginal is still its own posterior (oracle-certified in
    # tests/inference/test_svgd.py). Here: two conjugate problems with
    # opposite observations, recovered in one transport.
    from genjax_tpu.inference.svgd import packed_svgd

    @gen
    def scalar():
        mu = normal(0.0, 1.0) @ "mu"
        _ = normal(mu, 1.0) @ "obs"

    packed_traces, _ = jax.jit(
        lambda k: packed_svgd(
            k, scalar, [(), ()],
            [ChoiceMap.kw(obs=2.0), ChoiceMap.kw(obs=-2.0)],
            Selection.at["mu"], n_particles=128, n_steps=300,
            step_size=0.3,
        )
    )(jax.random.key(5))
    m0 = jnp.mean(packed_traces[0].get_choices()["mu"])  # -> +1.0
    m1 = jnp.mean(packed_traces[1].get_choices()["mu"])  # -> -1.0
    assert jnp.abs(m0 - 1.0) < 0.15 and jnp.abs(m1 + 1.0) < 0.15

    print("mesh scaling cookbook OK")


if __name__ == "__main__":
    main()
