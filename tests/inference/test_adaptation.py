"""Warmup adaptation: dual averaging, cross-chain mass estimation, and
preconditioned HMC/MALA correctness.

The exactness tests follow the repo's oracle strategy (conjugate
normal-normal posteriors, anisotropic Gaussians with known variances);
tolerances are set at >=4-6 standard errors per CLAUDE.md.
"""

import jax
import jax.numpy as jnp

import genjax_tpu as gx
from genjax_tpu import ChoiceMap, Selection
from genjax_tpu.inference.adaptation import (
    cross_chain_inv_mass,
    da_final,
    da_init,
    da_update,
    warmup_chains,
)
from genjax_tpu.inference.mcmc import run_chains
from genjax_tpu.inference.requests import HMC, MALA


@gx.gen
def aniso():
    a = gx.normal(0.0, 0.1) @ "a"
    b = gx.normal(0.0, 10.0) @ "b"
    return a + b


@gx.gen
def conjugate():
    mu = gx.normal(0.0, 1.0) @ "mu"
    _ = gx.normal(mu, 1.0) @ "obs"


# posterior of conjugate given obs=1.0: N(0.5, 0.5)
POST_MEAN, POST_VAR = 0.5, 0.5


def chain_batch(model, key, n, constraint=None):
    keys = jax.random.split(key, n)
    if constraint is None:
        return jax.vmap(lambda k: model.simulate(k, ()))(keys)
    trs, _ = jax.vmap(lambda k: model.importance(k, constraint, ()))(keys)
    return trs


class TestDualAveraging:
    def test_low_acceptance_shrinks_eps(self):
        da = da_init(0.5)
        for _ in range(50):
            da = da_update(da, jnp.asarray(0.0), target=0.8)
        assert float(da_final(da)) < 0.5

    def test_high_acceptance_grows_eps(self):
        da = da_init(0.5)
        for _ in range(50):
            da = da_update(da, jnp.asarray(1.0), target=0.8)
        assert float(da_final(da)) > 0.5

    def test_converges_to_fixed_point_of_synthetic_curve(self):
        # accept_prob = exp(-eps): dual averaging should settle where
        # exp(-eps) = 0.8, i.e. eps = -log(0.8) ~ 0.223.
        da = da_init(1.0)
        for _ in range(400):
            da = da_update(da, jnp.exp(-jnp.exp(da.log_eps)), target=0.8)
        assert abs(float(da_final(da)) - 0.2231) < 0.05


class TestCrossChainInvMass:
    def test_estimates_prior_variance(self):
        # i.i.d. prior draws across chains: cross-chain variance is the
        # exact posterior (= prior) variance, up to sampling error.
        trs = chain_batch(aniso, jax.random.key(0), 4096)
        sel = Selection.at["a"] | Selection.at["b"]
        im = cross_chain_inv_mass(trs, sel)
        assert abs(float(im["a"]) - 0.01) < 0.002
        assert abs(float(im["b"]) - 100.0) < 15.0

    def test_shared_leaves_fall_back_to_unit(self):
        # A leaf WITHOUT the expected chain axis (leading dim != the
        # declared n_chains, as in shared-args layouts) has no
        # cross-chain spread to measure: the estimator must fall back to
        # unit mass for it, not crash or mis-shape.
        trs = chain_batch(aniso, jax.random.key(1), 8)
        im = cross_chain_inv_mass(trs, Selection.at["a"], n_chains=16)
        assert im["a"].shape == (8,)
        assert bool(jnp.all(im["a"] == 1.0))
        # and the normal batched path still measures variance
        im2 = cross_chain_inv_mass(trs, Selection.at["a"], n_chains=8)
        assert im2["a"].shape == ()
        assert 0.0 < float(im2["a"]) < 1.0


class TestWarmupHMC:
    def test_anisotropic_target_adapts_metric_and_eps(self):
        trs = chain_batch(aniso, jax.random.key(0), 256)
        sel = Selection.at["a"] | Selection.at["b"]
        warmed, res = jax.jit(
            lambda k, t: warmup_chains(k, t, sel, n_steps=150, L=8)
        )(jax.random.key(1), trs)
        # acceptance lands near the 0.8 target
        assert 0.6 < float(res.accept_rate) < 0.95
        # the metric recovers the two variances within a factor of 2
        assert 0.005 < float(res.inv_mass["a"]) < 0.02
        assert 50.0 < float(res.inv_mass["b"]) < 200.0
        # post-warmup sampling under the tuned kernel reproduces both
        # scales (this fails badly with unit mass at any single eps)
        final, _ = run_chains(
            jax.random.key(2), warmed,
            HMC(sel, res.eps, 8, res.inv_mass, jitter=0.2), 100,
        )
        ch = final.get_choices()
        assert abs(float(jnp.var(ch["a"])) - 0.01) < 0.005
        assert abs(float(jnp.var(ch["b"])) - 100.0) < 40.0

    def test_posterior_exactness_after_warmup(self):
        trs = chain_batch(
            conjugate, jax.random.key(3), 512, ChoiceMap.kw(obs=1.0)
        )
        sel = Selection.at["mu"]
        warmed, res = warmup_chains(
            jax.random.key(4), trs, sel, n_steps=100, L=5
        )
        final, _ = run_chains(
            jax.random.key(5), warmed,
            HMC(sel, res.eps, 5, res.inv_mass, jitter=0.2), 150,
        )
        mus = final.get_choices()["mu"]
        # SE of the mean over 512 approx-independent chains ~ sqrt(0.5/512)
        se = float(jnp.sqrt(POST_VAR / 512))
        assert abs(float(jnp.mean(mus)) - POST_MEAN) < 6 * se
        assert abs(float(jnp.var(mus)) - POST_VAR) < 0.15


class TestWarmupMALA:
    def test_acceptance_targets_mala_optimum(self):
        trs = chain_batch(
            conjugate, jax.random.key(6), 256, ChoiceMap.kw(obs=1.0)
        )
        sel = Selection.at["mu"]
        warmed, res = warmup_chains(
            jax.random.key(7), trs, sel, n_steps=150, algorithm="mala"
        )
        assert 0.4 < float(res.accept_rate) < 0.75
        final, _ = run_chains(
            jax.random.key(8), warmed, MALA(sel, res.eps, res.inv_mass), 200
        )
        mus = final.get_choices()["mu"]
        se = float(jnp.sqrt(POST_VAR / 256))
        assert abs(float(jnp.mean(mus)) - POST_MEAN) < 6 * se


class TestPreconditionedKernelsExact:
    """A WRONG mass matrix must not bias the stationary distribution —
    MH correctness is independent of the metric; only mixing changes."""

    def test_hmc_arbitrary_mass_is_unbiased(self):
        trs = chain_batch(
            conjugate, jax.random.key(9), 512, ChoiceMap.kw(obs=1.0)
        )
        sel = Selection.at["mu"]
        bad_mass = jnp.asarray(7.3)  # deliberately not the posterior var
        final, _ = run_chains(
            jax.random.key(10),
            trs,
            HMC(sel, jnp.asarray(0.15), 5, bad_mass),
            200,
        )
        mus = final.get_choices()["mu"]
        se = float(jnp.sqrt(POST_VAR / 512))
        assert abs(float(jnp.mean(mus)) - POST_MEAN) < 6 * se
        assert abs(float(jnp.var(mus)) - POST_VAR) < 0.15

    def test_mala_arbitrary_scale_is_unbiased(self):
        trs = chain_batch(
            conjugate, jax.random.key(11), 512, ChoiceMap.kw(obs=1.0)
        )
        sel = Selection.at["mu"]
        final, _ = run_chains(
            jax.random.key(12),
            trs,
            MALA(sel, jnp.asarray(0.3), jnp.asarray(2.5)),
            200,
        )
        mus = final.get_choices()["mu"]
        se = float(jnp.sqrt(POST_VAR / 512))
        assert abs(float(jnp.mean(mus)) - POST_MEAN) < 6 * se
        assert abs(float(jnp.var(mus)) - POST_VAR) < 0.15

    def test_jitter_breaks_leapfrog_resonance(self):
        """Regression: at eps*L*sqrt(inv_mass)/sd near 2*pi the unjittered
        trajectory returns to its start (high acceptance, zero movement)
        and split R-hat explodes; jitter=0.2 must restore mixing. This is
        the pathology step-size adaptation is attracted to, found by the
        diagnostics on the first accelerator run of warmup_chains."""
        from genjax_tpu.inference.diagnostics import split_rhat

        trs = chain_batch(
            conjugate, jax.random.key(15), 128, ChoiceMap.kw(obs=1.0)
        )
        sel = Selection.at["mu"]
        # With inv_mass = posterior var, the conditioned target is a unit
        # Gaussian; the LEAPFROG rotation per step is theta with
        # cos(theta) = 1 - eps^2/2, so the exact period-L orbit sits at
        # eps = sqrt(2*(1 - cos(2*pi/L))) ~ 1.1756 for L=5 (the same
        # region dual averaging kept landing in before jitter existed).
        eps = jnp.sqrt(2.0 * (1.0 - jnp.cos(2.0 * jnp.pi / 5.0)))
        im = jnp.asarray(POST_VAR)
        _, mus_res = run_chains(
            jax.random.key(16), trs, HMC(sel, eps, 5, im), 100,
            collect=lambda t: t.get_choices()["mu"],
        )
        _, mus_jit = run_chains(
            jax.random.key(16), trs, HMC(sel, eps, 5, im, jitter=0.2), 100,
            collect=lambda t: t.get_choices()["mu"],
        )
        r_res = float(split_rhat(mus_res[:, 50:]))
        r_jit = float(split_rhat(mus_jit[:, 50:]))
        assert r_res > 10.0, f"expected resonance pathology, rhat={r_res}"
        assert r_jit < 1.2, f"jitter failed to restore mixing, rhat={r_jit}"

    def test_unit_mass_matches_default_alpha(self):
        # inv_mass=None and inv_mass=1.0 must produce identical proposals
        # and identical alpha (bitwise same computation modulo broadcast).
        tr, _ = conjugate.importance(
            jax.random.key(13), ChoiceMap.kw(obs=1.0), ()
        )
        sel = Selection.at["mu"]
        nd = gx.Diff.no_change(())
        t1, a1, _, _ = HMC(sel, jnp.asarray(0.2), 5).edit(
            jax.random.key(14), tr, nd
        )
        t2, a2, _, _ = HMC(sel, jnp.asarray(0.2), 5, jnp.asarray(1.0)).edit(
            jax.random.key(14), tr, nd
        )
        assert jnp.allclose(a1, a2, atol=1e-6)
        assert jnp.allclose(
            t1.get_choices()["mu"], t2.get_choices()["mu"], atol=1e-6
        )
