"""Distributional properties of the four resamplers: unbiased counts with
the canonical variance ordering systematic <= stratified <= multinomial."""

import jax
import jax.numpy as jnp
import pytest

from genjax_tpu.inference.smc import (
    multinomial_resample,
    residual_resample,
    stratified_resample,
    systematic_resample,
)

N = 256
TRIALS = 400


def count_stats(resampler, lw):
    w = jax.nn.softmax(lw)

    def counts(key):
        anc = resampler(key, lw, N)
        return jnp.bincount(anc, length=N)

    keys = jax.random.split(jax.random.key(0), TRIALS)
    cs = jax.vmap(counts)(keys)
    mean_err = jnp.max(jnp.abs(jnp.mean(cs, 0) - N * w))
    total_var = jnp.sum(jnp.var(cs.astype(jnp.float32), axis=0))
    return mean_err, total_var


class TestResamplerDistributions:
    def test_unbiased_and_variance_ordered(self):
        lw = jax.random.normal(jax.random.key(42), (N,))
        stats = {
            name: count_stats(fn, lw)
            for name, fn in [
                ("systematic", systematic_resample),
                ("stratified", stratified_resample),
                ("residual", residual_resample),
                ("multinomial", multinomial_resample),
            ]
        }
        for name, (mean_err, _) in stats.items():
            # E[counts_i] = N w_i; SE of the max-count estimate is small
            assert mean_err < 0.6, (name, float(mean_err))
        # canonical variance ordering (allow slack for MC noise)
        v_sys = stats["systematic"][1]
        v_strat = stats["stratified"][1]
        v_resid = stats["residual"][1]
        v_mult = stats["multinomial"][1]
        assert v_sys <= v_strat * 1.2
        assert v_strat <= v_mult * 1.2
        assert v_resid <= v_mult * 1.2
        # multinomial total count variance ~ sum N w (1-w)
        w = jax.nn.softmax(lw)
        expected = jnp.sum(N * w * (1 - w))
        assert jnp.allclose(v_mult, expected, rtol=0.25)


class TestStreamingExpansionEquivalence:
    """ops/expand.py must agree exactly with the ancestor-gather
    formulation for systematic resampling (round-3 perf rewrite)."""

    def test_expand_matches_take_on_collection(self):
        import jax
        import jax.numpy as jnp
        import jax.tree_util as jtu

        from genjax_tpu.core.gather import take_rows
        from genjax_tpu.inference.smc import (
            systematic_cum_counts,
            systematic_resample,
        )
        from genjax_tpu.ops.expand import expand_rows

        key = jax.random.key(0)
        n = 512
        lw = jax.random.normal(jax.random.key(1), (n,)) * 2.0
        tree = {
            "x": jax.random.normal(jax.random.key(2), (n,)),
            "m": jax.random.normal(jax.random.key(3), (n, 3)),
            "i": jnp.arange(n, dtype=jnp.int32),
            "shared": jnp.arange(7.0),
        }
        anc = systematic_resample(key, lw, n)
        cum = systematic_cum_counts(key, lw, n)
        want = take_rows(tree, anc, n_rows=n)
        got = expand_rows(tree, cum, n_rows=n)
        for a, b in zip(jtu.tree_leaves(want), jtu.tree_leaves(got)):
            assert jnp.array_equal(a, b)

    def test_expand_under_jit_and_vmap_batching(self):
        import jax
        import jax.numpy as jnp

        from genjax_tpu.inference.smc import (
            systematic_cum_counts,
            systematic_resample,
        )
        from genjax_tpu.ops.expand import expand_rows

        n = 128

        @jax.jit
        def run(key, lw, x):
            cum = systematic_cum_counts(key, lw, n)
            return expand_rows({"x": x}, cum, n_rows=n)["x"]

        key = jax.random.key(5)
        lw = jax.random.normal(jax.random.key(6), (n,))
        x = jnp.arange(float(n))
        anc = systematic_resample(key, lw, n)
        assert jnp.array_equal(run(key, lw, x), x[anc])


# (log-weight seed, key seed) at n = 2^16 with log-weights 3 * N(0, 1):
# the first makes XLA's float32 prefix sum of the weights dip below an
# integer boundary of n * cdf - u0; the second pairs a total that falls
# short of 1 with u0 near 1, which would drop the last output slot.
@pytest.mark.parametrize("lw_seed,key_seed", [(1, 0), (4, 3593)])
def test_systematic_counts_fill_every_slot_in_order(lw_seed, key_seed):
    from genjax_tpu.core.gather import take_rows
    from genjax_tpu.inference.smc import systematic_cum_counts
    from genjax_tpu.ops.expand import expand_rows

    n = 2**16
    lw = 3.0 * jax.random.normal(jax.random.key(lw_seed), (n,))
    key = jax.random.key(key_seed)
    cum = systematic_cum_counts(key, lw, n)
    assert int(cum[-1]) == n
    assert bool(jnp.all(jnp.diff(cum) >= 0))
    x = jnp.arange(n, dtype=jnp.int32)
    assert jnp.array_equal(
        expand_rows(x, cum, n_rows=n), take_rows(x, systematic_resample(key, lw, n))
    )
