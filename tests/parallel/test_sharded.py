"""Sharded inference tests on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import pytest

import genjax_tpu as g
from genjax_tpu import ChoiceMap, Regenerate, Selection, Target
from genjax_tpu.inference.smc import systematic_resample
from genjax_tpu.parallel import (
    ShardedSMC,
    particle_mesh,
    shard_leading_axis,
    sharded_ess,
    sharded_lml,
    sharded_mh_chains,
    sharded_systematic_ancestors,
)


@g.gen
def conjugate():
    x = g.normal(0.0, 1.0) @ "x"
    y = g.normal(x, 1.0) @ "y"
    return y


EXACT_LML = -0.25 - 0.5 * jnp.log(2 * jnp.pi * 2.0)  # log N(1; 0, sqrt 2)


@pytest.fixture(scope="module")
def mesh():
    return particle_mesh()


class TestShardedReductions:
    def test_sharded_lml_matches_dense(self, mesh):
        lw = jax.random.normal(jax.random.key(0), (1024,))
        from jax.scipy.special import logsumexp

        expected = logsumexp(lw) - jnp.log(1024.0)
        assert jnp.allclose(sharded_lml(lw, mesh), expected, atol=1e-5)

    def test_sharded_ess_matches_dense(self, mesh):
        from genjax_tpu.inference.smc import ess

        lw = jax.random.normal(jax.random.key(1), (1024,))
        assert jnp.allclose(sharded_ess(lw, mesh), ess(lw), rtol=1e-5)

    def test_sharded_ancestors_match_dense(self, mesh):
        lw = jax.random.normal(jax.random.key(2), (1024,))
        key = jax.random.key(3)
        anc_sharded = sharded_systematic_ancestors(key, lw, mesh)
        anc_dense = systematic_resample(key, lw, 1024)
        mismatch = jnp.mean((anc_sharded != anc_dense).astype(jnp.float32))
        assert mismatch < 1e-3  # exact ties only


class TestShardedSMC:
    def test_lml_and_resample(self, mesh):
        # ess_threshold > 1 forces resampling, so the unweighted particle
        # mean is a valid posterior estimate afterward.
        smc = ShardedSMC(n_particles=2048, mesh=mesh, ess_threshold=2.0)
        target = Target(conjugate, (), ChoiceMap.kw(y=1.0))

        @jax.jit
        def run(key):
            col = smc.init(key, target)
            lml = smc.lml(col)
            col = smc.maybe_resample(jax.random.fold_in(key, 1), col)
            for i in range(3):
                col = smc.rejuvenate(
                    jax.random.fold_in(key, 10 + i),
                    col,
                    Regenerate(Selection.at["x"]),
                )
            return lml, smc.ess(col), col

        lml, ess_after, col = run(jax.random.key(0))
        assert jnp.allclose(lml, EXACT_LML, atol=0.1)
        assert jnp.allclose(ess_after, 2048.0, atol=1.0)  # equal weights
        # posterior mean of x given y=1 is 0.5
        xs = col.get_particles().get_choices()["x"]
        assert jnp.allclose(jnp.mean(xs), 0.5, atol=0.1)

    def test_extend_weights(self, mesh):
        smc = ShardedSMC(n_particles=4096, mesh=mesh)
        col = smc.init(jax.random.key(0), Target(conjugate, (), ChoiceMap.empty()))
        col = smc.extend(jax.random.key(1), col, ChoiceMap.kw(y=1.0))
        assert jnp.allclose(smc.lml(col), EXACT_LML, atol=0.1)


class TestShardedChains:
    def test_chains_converge(self, mesh_unused=None):
        cmesh = particle_mesh(axis_name="chains")
        keys = jax.random.split(jax.random.key(7), 512)
        trs = jax.vmap(
            lambda k: conjugate.importance(k, ChoiceMap.kw(y=1.0), ())[0]
        )(keys)
        trs = shard_leading_axis(trs, cmesh, "chains")
        finals, _ = sharded_mh_chains(
            jax.random.key(8),
            trs,
            Regenerate(Selection.at["x"]),
            200,
            cmesh,
            "chains",
        )
        xs = finals.get_choices()["x"]
        assert jnp.allclose(jnp.mean(xs), 0.5, atol=0.1)
