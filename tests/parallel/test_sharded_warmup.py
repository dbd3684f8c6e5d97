"""Warmup adaptation over a sharded chain axis (GSPMD path).

`warmup_chains` / `chees_warmup` are pure batched-jnp programs, so the
accelerator-native scale-out is compiler-driven: `jit` them with the chain axis
sharded over the mesh and XLA partitions the per-chain work and inserts
all-reduces for the cross-chain statistics (mean acceptance, variance,
ChEES gradient). These tests pin that contract on the 8-device virtual
mesh: results agree with the unsharded run and the compiled HLO carries
the expected collectives.
"""

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import genjax_tpu as gx
from genjax_tpu import ChoiceMap, Selection
from genjax_tpu.inference.adaptation import warmup_chains
from genjax_tpu.inference.chees import chees_warmup

N_CHAINS = 64


@gx.gen
def conjugate():
    mu = gx.normal(0.0, 1.0) @ "mu"
    _ = gx.normal(mu, 1.0) @ "obs"


def mesh8():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    return Mesh(devs[:8], ("chains",))


def chain_batch():
    keys = jax.random.split(jax.random.key(0), N_CHAINS)
    trs, _ = jax.vmap(
        lambda k: conjugate.importance(k, ChoiceMap.kw(obs=1.0), ())
    )(keys)
    return trs


def shard_chain_batch(trs, mesh):
    def spec(v):
        if jnp.ndim(v) >= 1 and jnp.shape(v)[0] == N_CHAINS:
            return NamedSharding(mesh, P("chains", *([None] * (jnp.ndim(v) - 1))))
        return NamedSharding(mesh, P())

    return jtu.tree_map(lambda v: jax.device_put(v, spec(v)), trs)


class TestShardedWarmup:
    def test_matches_unsharded_and_stays_sharded(self):
        mesh = mesh8()
        trs = chain_batch()
        sel = Selection.at["mu"]
        fn = jax.jit(lambda k, t: warmup_chains(k, t, sel, n_steps=40, L=5))

        warmed_ref, res_ref = fn(jax.random.key(1), trs)
        warmed_sh, res_sh = fn(jax.random.key(1), shard_chain_batch(trs, mesh))

        # Statistically equivalent adaptation (NOT bitwise: reduction
        # order differs across layouts, and a single flipped MH accept
        # cascades — the kernel is chaotic in its float inputs).
        assert jnp.abs(jnp.log(res_ref.eps) - jnp.log(res_sh.eps)) < 0.3
        assert (
            jnp.abs(
                jnp.log(res_ref.inv_mass["mu"]) - jnp.log(res_sh.inv_mass["mu"])
            )
            < 0.3
        )
        assert jnp.abs(res_ref.accept_rate - res_sh.accept_rate) < 0.08
        # both warmed batches sit on the same posterior (N(0.5, 0.5))
        for warmed in (warmed_ref, warmed_sh):
            mus = warmed.get_choices()["mu"]
            assert jnp.abs(jnp.mean(mus) - 0.5) < 6 * jnp.sqrt(0.5 / N_CHAINS)
        # the chain state stayed sharded over the mesh
        sh = warmed_sh.get_choices()["mu"].sharding
        assert isinstance(sh, NamedSharding) and sh.spec == P("chains")

    def test_hlo_carries_cross_chain_allreduce(self):
        mesh = mesh8()
        trs = shard_chain_batch(chain_batch(), mesh)
        sel = Selection.at["mu"]
        txt = (
            jax.jit(lambda k, t: warmup_chains(k, t, sel, n_steps=20, L=3))
            .lower(jax.random.key(2), trs)
            .compile()
            .as_text()
        )
        assert "all-reduce" in txt, "cross-chain stats must lower to all-reduce"

    def test_chees_sharded(self):
        mesh = mesh8()
        trs = chain_batch()
        sel = Selection.at["mu"]
        fn = jax.jit(
            lambda k, t: chees_warmup(
                k, t, sel, n_steps=40, max_leapfrog=16
            )
        )
        _, res_ref = fn(jax.random.key(3), trs)
        _, res_sh = fn(jax.random.key(3), shard_chain_batch(trs, mesh))
        # statistical (not bitwise) agreement — same chaos caveat as the
        # warmup test above: reduction order can flip an MH accept
        assert jnp.abs(jnp.log(res_ref.eps) - jnp.log(res_sh.eps)) < 0.3
        assert (
            jnp.abs(
                jnp.log(res_ref.trajectory_length)
                - jnp.log(res_sh.trajectory_length)
            )
            < 0.5
        )
