"""Variational inference convergence tests on conjugate models
(parity: reference tests/inference/test_vi.py)."""

import jax
import jax.numpy as jnp
import pytest

import genjax_tpu as g
from genjax_tpu import ChoiceMap as C
from genjax_tpu import Target
from genjax_tpu.inference import vi


class TestELBO:
    def test_normal_normal_tight_variance(self):
        @g.gen
        def model(v):
            mu = g.normal(0.0, 10.0) @ "mu"
            _ = g.normal(mu, 0.1) @ "v"

        @g.marginal()
        @g.gen
        def guide(target):
            (v,) = target.args
            _ = vi.normal_reparam(v, 0.1) @ "mu"

        elbo_grad = vi.ELBO(guide, lambda v: Target(model, (v,), C.kw(v=3.0)))
        key = jax.random.key(314159)
        v = 0.1
        jitted = jax.jit(elbo_grad)
        for _ in range(400):
            (v_grad,) = jitted(key, (v,))
            v -= 1e-3 * v_grad
        assert v == pytest.approx(3.0, 5e-2)

    def test_elbo_learns_posterior_mean_and_scale(self):
        # latent mu ~ N(0, 1); y ~ N(mu, 1); observe y=2 -> posterior
        # N(1, 1/sqrt(2)).
        @g.gen
        def model(_vmu, _log_vsigma):
            mu = g.normal(0.0, 1.0) @ "mu"
            _ = g.normal(mu, 1.0) @ "y"

        @g.marginal()
        @g.gen
        def guide(target):
            vmu, log_vsigma = target.args
            _ = vi.normal_reparam(vmu, jnp.exp(log_vsigma)) @ "mu"

        def make_target(vmu, log_vsigma):
            return Target(model, (vmu, log_vsigma), C.kw(y=2.0))

        elbo_grad = jax.jit(vi.ELBO(guide, make_target))
        params = (0.0, 0.0)
        key = jax.random.key(0)
        trail = []
        for i in range(1200):
            key, sub = jax.random.split(key)
            grads = elbo_grad(sub, params)
            lr = 2e-2 if i < 600 else 5e-3
            params = tuple(p - lr * gr for p, gr in zip(params, grads))
            if i >= 1000:
                trail.append(params)
        avg = tuple(jnp.mean(jnp.array(ps)) for ps in zip(*trail))
        assert avg[0] == pytest.approx(1.0, abs=0.15)
        assert jnp.exp(avg[1]) == pytest.approx(1.0 / jnp.sqrt(2.0), abs=0.1)


class TestIWELBO:
    def test_iwelbo_gradient_finite(self):
        @g.gen
        def model(v):
            mu = g.normal(0.0, 10.0) @ "mu"
            _ = g.normal(mu, 0.1) @ "v"

        @g.marginal()
        @g.gen
        def guide(target):
            (v,) = target.args
            _ = vi.normal_reparam(v, 0.1) @ "mu"

        iwelbo_grad = vi.IWELBO(
            guide, lambda v: Target(model, (v,), C.kw(v=3.0)), N=4
        )
        (grad,) = jax.jit(iwelbo_grad)(jax.random.key(0), (1.0,))
        assert jnp.isfinite(grad)
        # gradient should point toward 3.0 (loss is -LML estimate)
        assert grad < 0.0

    def test_iwelbo_reparam_recovers_posterior_mean(self):
        """IWELBO (N=8) gradient descent drives the variational mean to
        the exact posterior mean, like ELBO does."""

        @g.gen
        def model(_vmu):
            mu = g.normal(0.0, 10.0) @ "mu"
            _ = g.normal(mu, 0.1) @ "v"

        @g.marginal()
        @g.gen
        def guide(target):
            (vmu,) = target.args
            _ = vi.normal_reparam(vmu, 0.1) @ "mu"

        step = jax.jit(
            vi.IWELBO(guide, lambda vmu: Target(model, (vmu,), C.kw(v=3.0)), N=8)
        )
        vmu, key = 0.5, jax.random.key(17)
        for _ in range(400):
            key, sub = jax.random.split(key)
            (dv,) = step(sub, (vmu,))
            vmu -= 1e-3 * dv
        assert vmu == pytest.approx(3.0, abs=5e-2)

    def test_iwelbo_reinforce_guide_unbiased(self):
        """IWELBO (N=4) with a `normal_reinforce` guide — exercises the
        batched REINFORCE strategy through ImportanceK's particle vmap
        (the reference raises NotImplementedError here). Check the
        estimator is unbiased against brute-force: E[grad] must vanish at
        the posterior optimum."""

        @g.gen
        def model(_vmu):
            mu = g.normal(0.0, 10.0) @ "mu"
            _ = g.normal(mu, 0.1) @ "v"

        @g.marginal()
        @g.gen
        def guide(target):
            (vmu,) = target.args
            _ = vi.normal_reinforce(vmu, 0.1) @ "mu"

        # Posterior: N(3.0 * 100/(100+0.01), ~0.1) — the guide family
        # contains it (sd fixed at 0.1), so grad E = 0 at the optimum.
        opt = 3.0 * 100.0 / (100.0 + 0.01)
        step = jax.jit(
            vi.IWELBO(guide, lambda vmu: Target(model, (vmu,), C.kw(v=3.0)), N=4)
        )
        keys = jax.random.split(jax.random.key(23), 4096)
        grads = jax.vmap(lambda k: step(k, (opt,))[0])(keys)
        assert jnp.all(jnp.isfinite(grads))
        se = jnp.std(grads) / jnp.sqrt(grads.shape[0])
        assert jnp.abs(jnp.mean(grads)) < 6 * se + 1e-3

    def test_iwelbo_flip_enum_guide_matches_closed_form(self):
        """IWELBO (N=4) with a `flip_enum` guide over a binary latent —
        exercises the batched (Rao-Blackwellized) enumeration strategy.
        The exact IWELBO gradient is computable by enumerating all 2^4
        particle assignments; the ADEV estimate must match in mean."""
        p_z, p_y_given = 0.3, (0.2, 0.9)  # P(y=T | z=F), P(y=T | z=T)

        @g.gen
        def model(_q):
            z = g.flip(p_z) @ "z"
            _ = g.flip(jnp.where(z, p_y_given[1], p_y_given[0])) @ "y"

        @g.marginal()
        @g.gen
        def guide(target):
            (q,) = target.args
            _ = vi.flip_enum(q) @ "z"

        N = 4

        def exact_neg_iwelbo(q):
            # Enumerate all 2^N particle assignments z_1..z_N ~ q iid.
            def log_w(z):
                joint = jnp.where(
                    z,
                    jnp.log(p_z) + jnp.log(p_y_given[1]),
                    jnp.log(1 - p_z) + jnp.log(p_y_given[0]),
                )
                q_z = jnp.where(z, jnp.log(q), jnp.log(1 - q))
                return joint - q_z

            total = 0.0
            for bits in range(2**N):
                zs = jnp.array([(bits >> i) & 1 for i in range(N)], dtype=bool)
                prob = jnp.prod(jnp.where(zs, q, 1 - q))
                lml_hat = jax.scipy.special.logsumexp(log_w(zs)) - jnp.log(N)
                total += prob * lml_hat
            return -total

        q0 = 0.4
        exact_grad = jax.grad(exact_neg_iwelbo)(q0)
        step = jax.jit(
            vi.IWELBO(guide, lambda q: Target(model, (q,), C.kw(y=True)), N=N)
        )
        keys = jax.random.split(jax.random.key(29), 3000)
        grads = jax.vmap(lambda k: step(k, (q0,))[0])(keys)
        assert jnp.all(jnp.isfinite(grads))
        se = jnp.std(grads) / jnp.sqrt(grads.shape[0])
        assert jnp.abs(jnp.mean(grads) - exact_grad) < 6 * se + 1e-4


class TestAmortizedVmap:
    def test_vmapped_grad_estimates_all_guides(self):
        """The amortized-training shape: `jax.vmap(grad_estimate)` over a
        batch of keys, for reparam AND reinforce guides, ELBO and IWELBO
        (the IWELBO+reinforce case stacks the particle vmap inside the
        outer batch vmap)."""

        @g.gen
        def model(_vmu):
            mu = g.normal(0.0, 1.0) @ "mu"
            _ = g.normal(mu, 1.0) @ "y"

        @g.marginal()
        @g.gen
        def guide_reparam(target):
            (vmu,) = target.args
            _ = vi.normal_reparam(vmu, 1.0) @ "mu"

        @g.marginal()
        @g.gen
        def guide_reinforce(target):
            (vmu,) = target.args
            _ = vi.normal_reinforce(vmu, 1.0) @ "mu"

        make_target = lambda vmu: Target(model, (vmu,), C.kw(y=2.0))
        keys = jax.random.split(jax.random.key(0), 16)
        for guide in (guide_reparam, guide_reinforce):
            for objective in (
                vi.ELBO(guide, make_target),
                vi.IWELBO(guide, make_target, N=4),
            ):
                grads = jax.vmap(lambda k: objective(k, (0.0,))[0])(keys)
                assert grads.shape == (16,)
                assert jnp.all(jnp.isfinite(grads))
                # Gradient points toward the posterior mean (1.0) from 0.
                assert jnp.mean(grads) < 0.0


class TestWakeSleep:
    def test_pwake_qwake_finite(self):
        @g.gen
        def model(theta):
            mu = g.normal(theta, 1.0) @ "mu"
            _ = g.normal(mu, 0.5) @ "y"

        @g.marginal()
        @g.gen
        def approx(target):
            (theta,) = target.args
            _ = vi.normal_reparam(theta, 0.7) @ "mu"

        make_target = lambda theta: Target(model, (theta,), C.kw(y=1.0))
        p_grad = vi.PWake(approx, make_target)(jax.random.key(0), (0.5,))
        q_grad = vi.QWake(approx, approx, make_target)(jax.random.key(1), (0.5,))
        assert jnp.isfinite(p_grad[0])
        assert jnp.isfinite(q_grad[0])

    def test_wake_sleep_drives_params_to_known_optima(self):
        """A 60-step wake-sleep loop (PWake for model θ, QWake for
        proposal φ) with a FIXED posterior approximation q* = N(0.8, 0.6):

        * PWake minimizes E_{mu~q*}[-log p(y, mu; θ)]; the θ-dependent
          term is the prior N(mu; θ, 1), so θ* = E_q*[mu] = 0.8.
        * QWake fits the proposal to q*'s samples by maximum likelihood,
          so (φ_mu, φ_sd) → (0.8, 0.6).
        (replaces finiteness-only asserts.)"""
        q_star = (0.8, 0.6)

        @g.gen
        def model(theta, _pmu, _plogsd):
            mu = g.normal(theta, 1.0) @ "mu"
            _ = g.normal(mu, 0.5) @ "y"

        @g.marginal()
        @g.gen
        def posterior_approx(target):
            _ = vi.normal_reparam(q_star[0], q_star[1]) @ "mu"

        @g.marginal()
        @g.gen
        def proposal(target):
            (_theta, pmu, plogsd) = target.args
            _ = vi.normal_reparam(pmu, jnp.exp(plogsd)) @ "mu"

        def make_target(theta, pmu, plogsd):
            return Target(model, (theta, pmu, plogsd), C.kw(y=1.0))

        p_step = jax.jit(vi.PWake(posterior_approx, make_target))
        q_step = jax.jit(vi.QWake(proposal, posterior_approx, make_target))

        params = (0.0, 0.0, 0.0)  # theta, phi_mu, phi_log_sd
        key = jax.random.key(41)
        trail = []
        for i in range(600):
            key, kp, kq = jax.random.split(key, 3)
            d_theta = p_step(kp, params)[0]
            d_phi = q_step(kq, params)
            lr = 5e-2 if i < 400 else 1e-2
            params = (
                params[0] - lr * d_theta,
                params[1] - lr * d_phi[1],
                params[2] - lr * d_phi[2],
            )
            if i >= 500:
                trail.append(params)
        avg = tuple(float(jnp.mean(jnp.array(ps))) for ps in zip(*trail))
        assert avg[0] == pytest.approx(q_star[0], abs=0.15)
        assert avg[1] == pytest.approx(q_star[0], abs=0.15)
        assert float(jnp.exp(avg[2])) == pytest.approx(q_star[1], abs=0.12)
