"""SVGD: exactness against conjugate Gaussian posteriors.

SVGD's fixed point with enough particles matches posterior moments on
Gaussian targets; these tests pin the transported particle mean and
spread against closed-form normal-normal posteriors (the reference's
exactness-oracle idiom)."""

import jax
import jax.numpy as jnp
import optax

import genjax_tpu as g
from genjax_tpu import ChoiceMap, Selection
from genjax_tpu.inference.svgd import rbf_kernel, stein_direction, svgd


@g.gen
def scalar_model():
    mu = g.normal(0.0, 1.0) @ "mu"
    _ = g.normal(mu, 1.0) @ "obs"
    return mu


class TestScalarConjugate:
    # obs=2 -> posterior N(1.0, 0.5)
    def test_recovers_posterior_moments(self):
        traces, phi = jax.jit(
            lambda k: svgd(
                k,
                scalar_model,
                (),
                ChoiceMap.kw(obs=2.0),
                Selection.at["mu"],
                n_particles=128,
                n_steps=400,
                step_size=0.3,
            )
        )(jax.random.key(0))
        mus = traces.get_choices()["mu"]
        assert jnp.abs(jnp.mean(mus) - 1.0) < 0.05
        assert jnp.abs(jnp.std(mus) - 0.5**0.5) < 0.08
        # the Stein direction has converged
        assert phi[-1] < 1e-3

    def test_scores_consistent_with_choices(self):
        traces, _ = svgd(
            jax.random.key(1),
            scalar_model,
            (),
            ChoiceMap.kw(obs=2.0),
            Selection.at["mu"],
            n_particles=32,
            n_steps=50,
        )
        chm0 = jax.tree_util.tree_map(lambda v: v[0], traces.get_choices())
        score, _ = scalar_model.assess(chm0, ())
        assert jnp.allclose(score, traces.get_score()[0], atol=1e-5)


D = 4


@g.gen
def vector_model(y):
    w = g.normal(jnp.zeros(D), 1.0) @ "w"
    _ = g.normal(w, 0.5) @ "y"
    return w


class TestVectorWithOptax:
    def test_adagrad_recovers_posterior(self):
        y = jnp.linspace(-1.0, 1.0, D)
        post_mean = 4.0 * y / 5.0
        post_std = (1.0 / 5.0) ** 0.5
        traces, _ = jax.jit(
            lambda k: svgd(
                k,
                vector_model,
                (y,),
                ChoiceMap.kw(y=y),
                Selection.at["w"],
                n_particles=256,
                n_steps=500,
                optimizer=optax.adagrad(0.5),
            )
        )(jax.random.key(0))
        ws = traces.get_choices()["w"]
        assert jnp.max(jnp.abs(jnp.mean(ws, 0) - post_mean)) < 0.03
        assert jnp.max(jnp.abs(jnp.std(ws, 0) - post_std)) < 0.08

    def test_shared_args_layout(self):
        """Model args are stored once (shared-args layout), not copied
        per particle."""
        y = jnp.linspace(-1.0, 1.0, D)
        traces, _ = svgd(
            jax.random.key(0),
            vector_model,
            (y,),
            ChoiceMap.kw(y=y),
            Selection.at["w"],
            n_particles=16,
            n_steps=5,
        )
        (arg_leaf,) = jax.tree_util.tree_leaves(traces.get_args())
        assert arg_leaf.shape == (D,)  # no leading particle axis


class TestGuards:
    def test_discrete_selection_raises(self):
        @g.gen
        def m2():
            z = g.categorical(jnp.log(jnp.array([0.5, 0.5]))) @ "z"
            _ = g.normal(jnp.where(z == 0, -1.0, 1.0), 1.0) @ "y"

        try:
            svgd(
                jax.random.key(0),
                m2,
                (),
                ChoiceMap.kw(y=0.5),
                Selection.at["z"],
                n_particles=8,
                n_steps=2,
            )
            raise AssertionError("expected TypeError")
        except TypeError as e:
            assert "non-differentiable" in str(e)


class TestKernelPieces:
    def test_rbf_kernel_symmetric_unit_diag(self):
        x = jax.random.normal(jax.random.key(0), (32, 3))
        K, h = rbf_kernel(x)
        assert jnp.allclose(K, K.T, atol=1e-6)
        assert jnp.allclose(jnp.diag(K), 1.0, atol=1e-6)
        assert h > 0

    def test_stein_direction_zero_at_symmetric_fixed_point(self):
        """Two particles placed symmetrically around a standard normal's
        mode at the equilibrium spacing: smoothed attraction balances
        repulsion, so phi vanishes at the fixed point of the dynamics."""
        # For x = (-a, a) with grad = -x and explicit bandwidth h:
        # phi(a) = [-a - K*(-a)*... ] closed form; instead verify
        # antisymmetry + sign structure: phi pushes outward when too
        # close, inward when too far.
        grads = lambda x: -x  # N(0,1) score
        close = jnp.array([[-0.05], [0.05]])
        far = jnp.array([[-3.0], [3.0]])
        phi_close, _ = stein_direction(close, grads(close), bandwidth=1.0)
        phi_far, _ = stein_direction(far, grads(far), bandwidth=1.0)
        # antisymmetric configurations give antisymmetric phi
        assert jnp.allclose(phi_close[0], -phi_close[1], atol=1e-6)
        # too close -> repulsion dominates (moves apart)
        assert phi_close[0, 0] < 0 and phi_close[1, 0] > 0
        # too far -> gradient term dominates (moves together)
        assert phi_far[0, 0] > 0 and phi_far[1, 0] < 0


class TestPackedSVGD:
    """packed_svgd: the feature-packing variant — SVGD on the product
    target with a joint kernel (see its docstring for the
    rationale)."""

    def test_single_problem_is_plain_svgd_bitwise(self):
        """With one problem the joint kernel reduces to the plain RBF
        kernel and the PRNG stream matches `svgd` — the packed driver
        must be the plain driver bit-for-bit."""
        from genjax_tpu.inference.svgd import packed_svgd

        kwargs = dict(
            selection=Selection.at["mu"],
            n_particles=64,
            n_steps=50,
            step_size=0.3,
            bandwidth=0.7,
        )
        key = jax.random.key(3)
        plain, phi_plain = svgd(
            key, scalar_model, (), ChoiceMap.kw(obs=2.0), **kwargs
        )
        packed, phi_packed = packed_svgd(
            key, scalar_model, [()], [ChoiceMap.kw(obs=2.0)], **kwargs
        )
        assert len(packed) == 1
        assert jnp.array_equal(
            packed[0].get_choices()["mu"], plain.get_choices()["mu"]
        )
        assert jnp.array_equal(packed[0].get_score(), plain.get_score())
        assert jnp.array_equal(phi_packed, phi_plain)

    def test_marginals_match_conjugate_oracles(self):
        """Three problems, three different observations: each packed
        slot's marginal must recover ITS OWN conjugate posterior
        (obs=y -> posterior N(y/2, 1/2)) — this certifies both the
        product-target transport and the pack/unpack layout (a slot
        swap would be a gross mean error)."""
        from genjax_tpu.inference.svgd import packed_svgd

        obs = [-2.0, 0.0, 2.0]
        traces, phi = jax.jit(
            lambda k: packed_svgd(
                k,
                scalar_model,
                [(), (), ()],
                [ChoiceMap.kw(obs=y) for y in obs],
                Selection.at["mu"],
                n_particles=256,
                n_steps=500,
                step_size=0.3,
            )
        )(jax.random.key(0))
        for c, y in enumerate(obs):
            mus = traces[c].get_choices()["mu"]
            assert jnp.abs(jnp.mean(mus) - y / 2.0) < 0.08, (c, y)
            # Joint-kernel coupling slightly perturbs finite-N spread
            # relative to independent runs; the band is loose but a
            # variance collapse (the high-dim SVGD failure mode) or a
            # wrong repulsion still trips it.
            assert jnp.abs(jnp.std(mus) - 0.5**0.5) < 0.15, (c, y)
        assert phi[-1] < 5e-3

    def test_scores_consistent_per_problem(self):
        """Each returned trace batch is a standard shared-args batch:
        scores must equal the model density of the transported
        choices."""
        from genjax_tpu.inference.svgd import packed_svgd

        traces, _ = packed_svgd(
            jax.random.key(1),
            scalar_model,
            [(), ()],
            [ChoiceMap.kw(obs=1.0), ChoiceMap.kw(obs=-1.0)],
            Selection.at["mu"],
            n_particles=32,
            n_steps=20,
            step_size=0.2,
        )
        for tr in traces:
            mus = tr.get_choices()["mu"]
            obs = tr.get_choices()["obs"]
            expected = jax.vmap(
                lambda m, o: scalar_model.assess(
                    ChoiceMap.kw(mu=m, obs=o), ()
                )[0]
            )(mus, jnp.broadcast_to(obs, mus.shape))
            assert jnp.allclose(tr.get_score(), expected, atol=1e-5)

    def test_length_mismatch_raises(self):
        from genjax_tpu.inference.svgd import packed_svgd

        try:
            packed_svgd(
                jax.random.key(0),
                scalar_model,
                [()],
                [ChoiceMap.kw(obs=1.0), ChoiceMap.kw(obs=2.0)],
                Selection.at["mu"],
                n_particles=8,
                n_steps=1,
            )
            raise AssertionError("expected ValueError")
        except ValueError as e:
            assert "same length" in str(e)
