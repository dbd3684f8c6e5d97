"""Vmap-soundness of every ADEV gradient strategy.

Each strategy's batched form is checked against exact derivatives where
the estimator is exact (linear continuations under Rao-Blackwellized
enumeration) and against closed-form gradients by Monte Carlo otherwise.
The reference gives up here (`_src/adev/core.py:159-163` raises for all
non-reparam strategies under vmap); these tests pin the capability that
goes beyond it.
"""

import jax
import jax.numpy as jnp

from genjax_tpu.adev import (
    Dual,
    baseline,
    categorical_enum_parallel,
    expectation,
    flip_enum,
    flip_enum_parallel,
    flip_mvd,
    flip_reinforce,
    normal_reinforce,
    sample_primitive,
)


def _vmapped_site(prim, keys, *args):
    """A vmapped sample site: one draw per key (this is exactly the shape
    `ImportanceK` produces for a guide's sites)."""
    return jax.vmap(lambda k: sample_primitive(prim, *args, key=k))(keys)


class TestBatchedFlipEnum:
    def test_linear_sum_exact(self):
        """Linear continuation: per-site RB enumeration is exact — the
        gradient is deterministic whatever the coupling sample."""

        @expectation
        def loss(p):
            ks = jax.random.split(jax.random.key(1), 3)
            bs = _vmapped_site(flip_enum, ks, p)
            return jnp.sum(jnp.where(bs, 1.0, 0.0))

        for seed in range(3):
            (grad,) = loss.grad_estimate(jax.random.key(seed), (0.3,))
            assert jnp.allclose(grad, 3.0, atol=1e-5)

    def test_per_site_parameters_exact(self):
        vals = jnp.array([1.0, -2.0, 5.0])

        @expectation
        def loss(ps):
            ks = jax.random.split(jax.random.key(1), 3)
            bs = jax.vmap(
                lambda k, pi: sample_primitive(flip_enum, pi, key=k)
            )(ks, ps)
            return jnp.sum(jnp.where(bs, vals, 0.0))

        ps = jnp.array([0.2, 0.5, 0.7])
        (grad,) = loss.grad_estimate(jax.random.key(0), (ps,))
        # E = Σ p_i v_i → ∂E/∂p_i = v_i, exactly.
        assert jnp.allclose(grad, vals, atol=1e-5)

    def test_nonlinear_unbiased(self):
        """(Σ b_i)² with n=3 iid Bern(p): dE/dp = n(1-2p) + 2n²p."""

        @expectation
        def loss(p):
            ks = jax.random.split(jax.random.key(1), 3)
            bs = _vmapped_site(flip_enum, ks, p)
            s = jnp.sum(jnp.where(bs, 1.0, 0.0))
            return s * s

        p = 0.4
        exact = 3 * (1 - 2 * p) + 2 * 9 * p
        keys = jax.random.split(jax.random.key(7), 4000)
        grads = jax.vmap(lambda k: loss.grad_estimate(k, (p,))[0])(keys)
        se = jnp.std(grads) / jnp.sqrt(grads.shape[0])
        assert jnp.abs(jnp.mean(grads) - exact) < 6 * se + 1e-3

    def test_parallel_variant_matches(self):
        @expectation
        def loss(p):
            ks = jax.random.split(jax.random.key(1), 3)
            bs = _vmapped_site(flip_enum_parallel, ks, p)
            return jnp.sum(jnp.where(bs, 1.0, 0.0))

        (grad,) = loss.grad_estimate(jax.random.key(0), (0.3,))
        assert jnp.allclose(grad, 3.0, atol=1e-5)


class TestBatchedCategoricalEnum:
    def test_linear_sum_exact(self):
        vals = jnp.array([0.0, 1.0, 4.0])

        @expectation
        def loss(probs):
            ks = jax.random.split(jax.random.key(1), 4)
            idxs = _vmapped_site(categorical_enum_parallel, ks, probs)
            return jnp.sum(vals[idxs])

        probs = jnp.array([0.2, 0.3, 0.5])
        (grad,) = loss.grad_estimate(jax.random.key(0), (probs,))
        exact = jax.grad(
            lambda pr: 4.0 * jnp.sum(pr / jnp.sum(pr) * vals)
        )(probs)
        assert jnp.allclose(grad, exact, atol=1e-5)


class TestBatchedFlipMVD:
    def test_nonlinear_unbiased(self):
        @expectation
        def loss(p):
            ks = jax.random.split(jax.random.key(1), 3)
            bs = _vmapped_site(flip_mvd, ks, p)
            s = jnp.sum(jnp.where(bs, 1.0, 0.0))
            return s * s

        p = 0.4
        exact = 3 * (1 - 2 * p) + 2 * 9 * p
        keys = jax.random.split(jax.random.key(11), 6000)
        grads = jax.vmap(lambda k: loss.grad_estimate(k, (p,))[0])(keys)
        se = jnp.std(grads) / jnp.sqrt(grads.shape[0])
        assert jnp.abs(jnp.mean(grads) - exact) < 6 * se + 1e-3


class TestBatchedREINFORCE:
    def test_normal_unbiased(self):
        """Σ (x_i - 2)², x_i ~ N(mu, 1), n=4: dE/dmu = 8(mu - 2)."""

        @expectation
        def loss(mu):
            ks = jax.random.split(jax.random.key(1), 4)
            xs = _vmapped_site(normal_reinforce, ks, mu, 1.0)
            return jnp.sum(jnp.square(xs - 2.0))

        keys = jax.random.split(jax.random.key(5), 20000)
        grads = jax.vmap(lambda k: loss.grad_estimate(k, (0.5,))[0])(keys)
        se = jnp.std(grads) / jnp.sqrt(grads.shape[0])
        assert jnp.abs(jnp.mean(grads) - (-12.0)) < 6 * se + 1e-2

    def test_flip_reinforce_unbiased(self):
        @expectation
        def loss(p):
            ks = jax.random.split(jax.random.key(1), 3)
            bs = _vmapped_site(flip_reinforce, ks, p)
            return jnp.sum(jnp.where(bs, 1.0, 0.0))

        keys = jax.random.split(jax.random.key(6), 20000)
        grads = jax.vmap(lambda k: loss.grad_estimate(k, (0.4,))[0])(keys)
        se = jnp.std(grads) / jnp.sqrt(grads.shape[0])
        assert jnp.abs(jnp.mean(grads) - 3.0) < 6 * se + 1e-2


class TestBatchedBaseline:
    def test_reinforce_baseline_unbiased_same_expectation(self):
        wrapped = baseline(flip_reinforce)

        @expectation
        def loss(p):
            ks = jax.random.split(jax.random.key(1), 3)
            bs = jax.vmap(
                lambda k: sample_primitive(wrapped, 0.5, p, key=k)
            )(ks)
            return jnp.sum(jnp.where(bs, 1.0, 0.0))

        keys = jax.random.split(jax.random.key(8), 20000)
        grads = jax.vmap(lambda k: loss.grad_estimate(k, (0.4,))[0])(keys)
        se = jnp.std(grads) / jnp.sqrt(grads.shape[0])
        assert jnp.abs(jnp.mean(grads) - 3.0) < 6 * se + 1e-2

    def test_enum_baseline_is_exact_no_op(self):
        wrapped = baseline(flip_enum)

        @expectation
        def loss(p):
            ks = jax.random.split(jax.random.key(1), 3)
            bs = jax.vmap(
                lambda k: sample_primitive(wrapped, 7.0, p, key=k)
            )(ks)
            return jnp.sum(jnp.where(bs, 1.0, 0.0))

        (grad,) = loss.grad_estimate(jax.random.key(0), (0.3,))
        assert jnp.allclose(grad, 3.0, atol=1e-5)
