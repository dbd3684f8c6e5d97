"""MCMC edit-request convergence tests against conjugate posteriors
(parity: reference tests/inference/test_requests.py idioms)."""

import jax
import jax.numpy as jnp

import genjax_tpu as g
from genjax_tpu import ChoiceMap, Regenerate, Selection
from genjax_tpu.inference.mcmc import mh, mh_chain, run_chains
from genjax_tpu.inference.requests import HMC, MALA, Rejuvenate


@g.gen
def normal_normal():
    mu = g.normal(0.0, 1.0) @ "mu"
    _ = g.normal(mu, 1.0) @ "obs"
    return mu


# Posterior given obs=y: N(y/2, 1/sqrt(2)).
OBS = 2.0
POST_MEAN = 1.0
POST_STD = 1.0 / jnp.sqrt(2.0)


def init_trace(key):
    tr, _ = normal_normal.importance(key, ChoiceMap.kw(obs=OBS), ())
    return tr


class TestRegenerateMH:
    def test_chain_converges_to_posterior(self):
        key = jax.random.key(0)
        tr = init_trace(key)
        req = Regenerate(Selection.at["mu"])
        final, mus = jax.jit(
            lambda k, t: mh_chain(k, t, req, 2000, collect=lambda tr: tr.get_choices()["mu"])
        )(jax.random.key(1), tr)
        samples = mus[500:]
        assert jnp.allclose(jnp.mean(samples), POST_MEAN, atol=0.1)
        assert jnp.allclose(jnp.std(samples), POST_STD, atol=0.1)

    def test_mh_accept_flag(self):
        tr = init_trace(jax.random.key(0))
        req = Regenerate(Selection.at["mu"])
        new_tr, accepted = mh(jax.random.key(2), tr, req)
        assert accepted.dtype == jnp.bool_


class TestRejuvenate:
    def test_random_walk_rejuvenation(self):
        @g.gen
        def proposal(prev_mu):
            return g.normal(prev_mu, 0.5) @ "mu"

        req = Rejuvenate(proposal, lambda chm: (chm["mu"],))
        tr = init_trace(jax.random.key(0))
        final, mus = jax.jit(
            lambda k, t: mh_chain(
                k, t, req, 8000, collect=lambda tr: tr.get_choices()["mu"]
            )
        )(jax.random.key(5), tr)
        samples = mus[1000:]
        assert jnp.allclose(jnp.mean(samples), POST_MEAN, atol=0.1)
        assert jnp.allclose(jnp.std(samples), POST_STD, atol=0.1)


class TestHMC:
    def test_alpha_is_detailed_balance_ratio(self):
        tr = init_trace(jax.random.key(0))
        req = HMC(Selection.at["mu"], jnp.array(0.1), L=5)
        new_tr, alpha, _, bwd = req.edit(
            jax.random.key(1), tr, g.Diff.no_change(tr.get_args())
        )
        assert jnp.isfinite(alpha)
        assert isinstance(bwd, HMC)

    def test_chain_converges(self):
        tr = init_trace(jax.random.key(0))
        req = HMC(Selection.at["mu"], jnp.array(0.3), L=10)
        final, mus = jax.jit(
            lambda k, t: mh_chain(k, t, req, 1000, collect=lambda tr: tr.get_choices()["mu"])
        )(jax.random.key(1), tr)
        samples = mus[200:]
        assert jnp.allclose(jnp.mean(samples), POST_MEAN, atol=0.12)
        assert jnp.allclose(jnp.std(samples), POST_STD, atol=0.12)


class TestMALA:
    def test_chain_converges(self):
        tr = init_trace(jax.random.key(0))
        req = MALA(Selection.at["mu"], jnp.array(0.25))
        final, mus = jax.jit(
            lambda k, t: mh_chain(k, t, req, 2000, collect=lambda tr: tr.get_choices()["mu"])
        )(jax.random.key(3), tr)
        samples = mus[500:]
        assert jnp.allclose(jnp.mean(samples), POST_MEAN, atol=0.1)
        assert jnp.allclose(jnp.std(samples), POST_STD, atol=0.12)


def _rts_smoother_means(a, q, r, ys, m0=0.0):
    """Exact posterior means E[z_t | y_{1:T}] for the scan SSM
    z_t ~ N(a·c_{t-1}, q), y_t ~ N(z_t, r), carry c_0 = m0 (so the t=1
    prior is N(a·m0, q²)) — forward Kalman filter + RTS backward pass."""
    import numpy as np

    T = len(ys)
    mu_pred = np.zeros(T)
    p_pred = np.zeros(T)
    mu_f = np.zeros(T)
    p_f = np.zeros(T)
    mu_pred[0], p_pred[0] = a * m0, q**2
    for t in range(T):
        s = p_pred[t] + r**2
        k = p_pred[t] / s
        mu_f[t] = mu_pred[t] + k * (ys[t] - mu_pred[t])
        p_f[t] = (1 - k) * p_pred[t]
        if t + 1 < T:
            mu_pred[t + 1] = a * mu_f[t]
            p_pred[t + 1] = a**2 * p_f[t] + q**2
    ms = np.zeros(T)
    ms[-1] = mu_f[-1]
    for t in range(T - 2, -1, -1):
        c = p_f[t] * a / p_pred[t + 1]
        ms[t] = mu_f[t] + c * (ms[t + 1] - mu_pred[t + 1])
    return ms


def _ssm(a=0.8, q=0.6, r=0.5, T=6):
    @g.gen
    def step(c, _x):
        z = g.normal(a * c, q) @ "z"
        _ = g.normal(z, r) @ "y"
        return (z, None)

    return g.scan(n=T)(step)


class TestHMCStructured:
    """HMC on structured (scan / nested-scan) models with exact-oracle
    convergence and an exact alpha identity (parity
    with reference tests/inference/test_requests.py:197-428)."""

    YS = jnp.array([0.4, 1.1, 0.3, -0.5, 0.9, 1.3])
    A, Q, R = 0.8, 0.6, 0.5

    def test_alpha_identity_small_step(self):
        """Leapfrog is symplectic: as eps → 0 the energy error — which IS
        the returned alpha — vanishes. Black-box check of the alpha
        construction (new joint + new momenta − old joint − old momenta)."""
        tr = init_trace(jax.random.key(0))
        for eps, tol in [(1e-3, 1e-4), (1e-2, 1e-2)]:
            req = HMC(Selection.at["mu"], jnp.array(eps), L=3)
            _, alpha, _, _ = req.edit(
                jax.random.key(1), tr, g.Diff.no_change(tr.get_args())
            )
            assert jnp.abs(alpha) < tol, (eps, alpha)

    def test_alpha_matches_hand_leapfrog(self):
        """Replicate the HMC move by hand (same key discipline, same
        leapfrog) and check alpha == ΔH exactly."""
        import jax.random as jrand

        from genjax_tpu.inference.requests.hmc import (
            assess_momenta,
            make_selection_grad_fn,
            sample_momenta,
        )

        tr = init_trace(jax.random.key(0))
        sel = Selection.at["mu"]
        eps, L = jnp.array(0.3), 4
        key = jax.random.key(9)
        new_tr, alpha, _, _ = HMC(sel, eps, L=L).edit(
            key, tr, g.Diff.no_change(tr.get_args())
        )

        # Hand replication.
        argdiffs = g.Diff.no_change(tr.get_args())
        grad_fn = make_selection_grad_fn(sel, tr, argdiffs)
        values = tr.get_choices().filter(sel)
        _, grads = grad_fn(values)
        _, sub_key = jrand.split(key)
        momenta, mom0_score = sample_momenta(sub_key, grads)
        import jax.tree_util as jtu

        v, gr, m = values, grads, momenta
        for _ in range(L):
            m = jtu.tree_map(lambda mm, gg: mm + (eps / 2) * gg, m, gr)
            v = jtu.tree_map(lambda vv, mm: vv + eps * mm, v, m)
            _, gr = grad_fn(v)
            m = jtu.tree_map(lambda mm, gg: mm + (eps / 2) * gg, m, gr)
        new_score, _ = grad_fn(v)
        expected_alpha = (
            new_score - tr.get_score() + assess_momenta(m, mul=-1.0) - mom0_score
        )
        assert jnp.allclose(alpha, expected_alpha, atol=1e-5)
        # And the returned trace really holds the integrated values.
        assert jnp.allclose(
            new_tr.get_choices()["mu"], v.get_submap("mu").get_value(), atol=1e-5
        )

    def test_scan_hmc_converges_to_kalman_smoother(self):
        """HMC over every latent of a scan SSM (wildcard selection
        `S[..., "z"]`): pooled chain means match the exact RTS smoother
        (parity: reference `test_simple_scan_hmc`/`test_hmm_hmc`)."""
        model = _ssm(self.A, self.Q, self.R, T=len(self.YS))
        exact = _rts_smoother_means(self.A, self.Q, self.R, list(self.YS))

        def init(key):
            tr, _ = model.importance(
                key, ChoiceMap.kw(y=self.YS), (0.0, None)
            )
            return tr

        keys = jax.random.split(jax.random.key(0), 32)
        trs = jax.vmap(init)(keys)
        req = HMC(Selection.at[..., "z"], jnp.array(0.12), L=10)
        _, zs = jax.jit(
            lambda k, t: run_chains(
                k, t, req, 500, collect=lambda tr: tr.get_choices()["z"]
            )
        )(jax.random.key(1), trs)
        pooled = zs[:, 150:, :].reshape(-1, len(self.YS))
        assert jnp.max(jnp.abs(jnp.mean(pooled, 0) - exact)) < 0.1, (
            jnp.mean(pooled, 0),
            exact,
        )

    def test_nested_scan_hmc_runs_and_converges(self):
        """HMC through a Scan *submodel* of a static model (selection
        `S["ssm", ..., "z"]`)."""
        inner = _ssm(self.A, self.Q, self.R, T=len(self.YS))

        @g.gen
        def outer():
            out = inner(0.0, None) @ "ssm"
            return out

        def init(key):
            tr, _ = outer.importance(
                key, ChoiceMap.entry(ChoiceMap.kw(y=self.YS), "ssm"), ()
            )
            return tr

        exact = _rts_smoother_means(self.A, self.Q, self.R, list(self.YS))
        keys = jax.random.split(jax.random.key(3), 32)
        trs = jax.vmap(init)(keys)
        req = HMC(Selection.at["ssm", ..., "z"], jnp.array(0.12), L=10)
        _, zs = jax.jit(
            lambda k, t: run_chains(
                k, t, req, 500, collect=lambda tr: tr.get_choices()["ssm", "z"]
            )
        )(jax.random.key(4), trs)
        pooled = zs[:, 150:, :].reshape(-1, len(self.YS))
        assert jnp.max(jnp.abs(jnp.mean(pooled, 0) - exact)) < 0.1


class TestSafeHMC:
    """Behavioral SafeHMC coverage."""

    def test_safe_hmc_accepts_retval_independent_site(self):
        from genjax_tpu.inference.requests import SafeHMC

        @g.gen
        def model():
            mu = g.normal(0.0, 1.0) @ "mu"
            obs = g.normal(mu, 1.0) @ "obs"
            return obs  # retval reads "obs", not "mu" directly

        tr, _ = model.importance(jax.random.key(0), ChoiceMap.kw(obs=1.0), ())
        req = SafeHMC(Selection.at["mu"], jnp.array(0.2), L=5)
        new_tr, alpha, _, _ = req.edit(
            jax.random.key(1), tr, g.Diff.no_change(())
        )
        assert jnp.isfinite(alpha)

    def test_safe_hmc_rejects_retval_dependent_site(self):
        import pytest

        from genjax_tpu.inference.requests import SafeHMC

        @g.gen
        def model():
            mu = g.normal(0.0, 1.0) @ "mu"
            _ = g.normal(mu, 1.0) @ "obs"
            return mu  # retval IS the selected site

        tr, _ = model.importance(jax.random.key(0), ChoiceMap.kw(obs=1.0), ())
        req = SafeHMC(Selection.at["mu"], jnp.array(0.2), L=5)
        with pytest.raises(AssertionError, match="SafeHMC"):
            req.edit(jax.random.key(1), tr, g.Diff.no_change(()))


class TestRunChains:
    def test_parallel_chains(self):
        keys = jax.random.split(jax.random.key(0), 32)
        trs = jax.vmap(init_trace)(keys)
        req = Regenerate(Selection.at["mu"])
        finals, mus = jax.jit(
            lambda k, t: run_chains(k, t, req, 300, collect=lambda tr: tr.get_choices()["mu"])
        )(jax.random.key(1), trs)
        assert mus.shape == (32, 300)
        pooled = mus[:, 100:].reshape(-1)
        assert jnp.allclose(jnp.mean(pooled), POST_MEAN, atol=0.05)
