"""2-D (chains × particles) mesh SMC: `GridSMC` on a
2×4 virtual mesh must agree with the dense single-device computation —
per-chain LML/ESS exactly, per-chain resampling ancestor-for-ancestor."""

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import pytest

import genjax_tpu as g
from genjax_tpu import ChoiceMap, Regenerate, Selection, Target
from genjax_tpu.inference.smc import ess, systematic_resample
from genjax_tpu.parallel import GridSMC, grid_mesh
from jax.scipy.special import logsumexp


@g.gen
def conjugate():
    x = g.normal(0.0, 1.0) @ "x"
    y = g.normal(x, 1.0) @ "y"
    return y


EXACT_LML = -0.25 - 0.5 * jnp.log(2 * jnp.pi * 2.0)  # log N(1; 0, sqrt 2)
TARGET = Target(conjugate, (), ChoiceMap.kw(y=1.0))


@pytest.fixture(scope="module")
def smc():
    mesh = grid_mesh(2, 4)
    return GridSMC(n_chains=4, n_particles=512, mesh=mesh)


class TestGridReductions:
    def test_per_chain_lml_matches_dense(self, smc):
        coll = jax.jit(smc.init)(jax.random.key(0), TARGET)
        lmls = jax.jit(smc.per_chain_lml)(coll)
        assert lmls.shape == (4,)
        lw = coll.get_log_weights()
        dense = jax.vmap(lambda row: logsumexp(row) - jnp.log(512.0))(lw)
        assert jnp.allclose(lmls, dense, atol=1e-5)
        # And each chain's estimate is near the exact marginal.
        assert jnp.max(jnp.abs(lmls - EXACT_LML)) < 0.1

    def test_per_chain_ess_matches_dense(self, smc):
        coll = jax.jit(smc.init)(jax.random.key(1), TARGET)
        esses = jax.jit(smc.per_chain_ess)(coll)
        dense = jax.vmap(ess)(coll.get_log_weights())
        assert jnp.allclose(esses, dense, rtol=1e-5)


class TestGridResampling:
    def test_per_chain_ancestors_match_dense(self, smc):
        coll = jax.jit(smc.init)(jax.random.key(2), TARGET)
        key = jax.random.key(3)
        anc = jax.jit(smc._per_chain_ancestors)(key, coll.get_log_weights())
        assert anc.shape == (4, 512)
        chain_keys = jax.random.split(key, 4)
        for c in range(4):
            dense = systematic_resample(
                chain_keys[c], coll.get_log_weights()[c], 512
            )
            assert jnp.array_equal(anc[c], dense), f"chain {c}"

    def test_resample_preserves_per_chain_lml(self, smc):
        coll = jax.jit(smc.init)(jax.random.key(4), TARGET)
        before = jax.jit(smc.per_chain_lml)(coll)
        res = jax.jit(smc.resample)(jax.random.key(5), coll)
        after = jax.jit(smc.per_chain_lml)(res)
        assert jnp.allclose(before, after, atol=1e-5)

    def test_maybe_resample_is_per_chain(self, smc):
        """Degenerate one chain's weights; only that chain resamples."""
        coll = jax.jit(smc.init)(jax.random.key(6), TARGET)
        lw = coll.get_log_weights()
        degen = lw.at[1].set(-1e9).at[1, 0].set(0.0)
        coll = type(coll)(coll.get_particles(), degen, coll.is_valid)
        out = jax.jit(smc.maybe_resample)(jax.random.key(7), coll)
        new_lw = out.get_log_weights()
        # Chain 1 resampled (weights flattened to its average).
        assert jnp.allclose(new_lw[1], new_lw[1, 0])
        # Other chains untouched.
        for c in (0, 2, 3):
            assert jnp.array_equal(new_lw[c], lw[c])
        # Chain 1's particles are now copies of its dominant particle.
        x1 = out.get_particles().get_choices()["x"][1]
        assert jnp.allclose(x1, x1[0])


class TestGridCarryStability:
    def test_maybe_resample_preserves_avals_in_scan(self, smc):
        """maybe_resample must not change any leaf's aval (a reshaped 0-d
        `is_valid` breaks scan/cond carries — code-review r2 finding)."""
        coll = jax.jit(smc.init)(jax.random.key(10), TARGET)
        out = jax.jit(smc.maybe_resample)(jax.random.key(11), coll)
        for a, b in zip(jtu.tree_leaves(coll), jtu.tree_leaves(out)):
            assert a.shape == b.shape and a.dtype == b.dtype

        # And the real usage: carry the collection through a lax.scan.
        @jax.jit
        def loop(key, coll):
            def body(c, k):
                c = smc.maybe_resample(k, c)
                c = smc.rejuvenate(
                    jax.random.fold_in(k, 1), c, Regenerate(Selection.at["x"])
                )
                return c, smc.per_chain_ess(c)
            return jax.lax.scan(body, coll, jax.random.split(key, 3))

        coll2, esses = loop(jax.random.key(12), coll)
        assert esses.shape == (3, 4)
        assert bool(jnp.all(jnp.isfinite(smc.per_chain_lml(coll2))))


class TestGridMoves:
    def test_full_round_runs_and_estimates(self, smc):
        @jax.jit
        def round_(key):
            coll = smc.init(key, TARGET)
            lml0 = smc.per_chain_lml(coll)
            coll = smc.resample(jax.random.fold_in(key, 1), coll)
            coll = smc.rejuvenate(
                jax.random.fold_in(key, 2), coll, Regenerate(Selection.at["x"])
            )
            # Post-resample the weights are uniform per chain, so the plain
            # mean estimates the posterior mean.
            return lml0, jnp.mean(coll.get_particles().get_choices()["x"], axis=1)

        lmls, post_means = round_(jax.random.key(8))
        assert jnp.max(jnp.abs(lmls - EXACT_LML)) < 0.1
        # Posterior mean of x given y=1 is 0.5 — each chain near it
        # (MC noise ~ 1/sqrt(512) * posterior sd ~ 0.03; 4 chains).
        assert jnp.max(jnp.abs(post_means - 0.5)) < 0.15

    def test_extend_accumulates_weights(self, smc):
        @g.gen
        def two_obs():
            x = g.normal(0.0, 1.0) @ "x"
            _ = g.normal(x, 1.0) @ "y"
            _ = g.normal(x, 1.0) @ "z"

        tgt = Target(two_obs, (), ChoiceMap.kw(y=1.0))
        smc2 = GridSMC(
            n_chains=4, n_particles=512, mesh=smc.mesh
        )

        @jax.jit
        def run(key):
            coll = smc2.init(key, tgt)
            coll = smc2.extend(
                jax.random.fold_in(key, 1), coll, ChoiceMap.kw(z=0.5)
            )
            return smc2.per_chain_lml(coll)

        lmls = run(jax.random.key(9))
        # Exact log p(y=1, z=0.5): joint of two observations of x.
        # y,z | x ~ N(x,1); marginal covariance [[2,1],[1,2]].
        cov = jnp.array([[2.0, 1.0], [1.0, 2.0]])
        v = jnp.array([1.0, 0.5])
        exact = -0.5 * v @ jnp.linalg.solve(cov, v) - 0.5 * jnp.log(
            (2 * jnp.pi) ** 2 * jnp.linalg.det(cov)
        )
        assert jnp.max(jnp.abs(lmls - exact)) < 0.15


class TestGridSharedArgs:
    """GridSMC with a data-conditioned target keeps ONE copy of the
    dataset across the whole (chains x particles) grid."""

    def test_full_round_with_shared_args(self):
        import genjax_tpu as g

        @g.gen
        def reg(X):
            w = g.mv_normal_diag(jnp.zeros(3), jnp.ones(3)) @ "w"
            _ = g.normal(X @ w, 1.0) @ "ys"

        X = jax.random.normal(jax.random.key(11), (16, 3))
        tgt = Target(reg, (X,), ChoiceMap.kw(ys=jnp.zeros(16)))
        mesh = grid_mesh(2, 4)
        smc = GridSMC(n_chains=2, n_particles=64, mesh=mesh)
        coll = jax.jit(smc.init)(jax.random.key(0), tgt)
        # args stored once, unbatched
        assert coll.get_particles().get_args()[0].shape == (16, 3)
        lmls = jax.jit(smc.per_chain_lml)(coll)
        assert lmls.shape == (2,)
        coll = jax.jit(smc.maybe_resample)(jax.random.key(1), coll)
        coll = jax.jit(
            lambda k, c: smc.rejuvenate(
                k, c, g.Regenerate(Selection.at["w"])
            )
        )(jax.random.key(2), coll)
        parts = coll.get_particles()
        assert parts.get_args()[0].shape == (16, 3)
        # every grid cell's score is the exact joint of its choices
        ws = parts.get_choices()["w"]
        scores = jax.vmap(
            jax.vmap(
                lambda w: reg.assess(
                    ChoiceMap.kw(w=w, ys=jnp.zeros(16)), (X,)
                )[0]
            )
        )(ws)
        assert jnp.allclose(parts.get_score(), scores, atol=1e-4)


class TestGridAmbiguousArgs:
    def test_data_rows_equal_particle_count(self):
        """A design matrix with exactly n_particles rows must stay in
        broadcast form (code-review finding: pre-fix, resample gathered
        its data rows and crashed under out_axes=None)."""
        import genjax_tpu as g

        n_part = 16

        @g.gen
        def reg(X):
            w = g.mv_normal_diag(jnp.zeros(3), jnp.ones(3)) @ "w"
            _ = g.normal(X @ w, 1.0) @ "ys"

        X = jax.random.normal(jax.random.key(40), (n_part, 3))
        tgt = Target(reg, (X,), ChoiceMap.kw(ys=jnp.zeros(n_part)))
        smc = GridSMC(n_chains=4, n_particles=n_part, mesh=grid_mesh(2, 4))
        coll = jax.jit(smc.init)(jax.random.key(41), tgt)
        # ambiguous leaf kept broadcast: (C, K, n_part, 3)
        assert coll.get_particles().get_args()[0].shape == (4, n_part, n_part, 3)
        out = jax.jit(smc.resample)(jax.random.key(42), coll)
        parts = out.get_particles()
        scores = jax.vmap(
            jax.vmap(
                lambda w: reg.assess(
                    ChoiceMap.kw(w=w, ys=jnp.zeros(n_part)), (X,)
                )[0]
            )
        )(parts.get_choices()["w"])
        assert jnp.allclose(parts.get_score(), scores, atol=1e-4)
