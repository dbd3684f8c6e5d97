"""SMC-squared: sequential inference over state-space-model parameters.

Beyond the reference (genjax-community/genjax ships no parameter-learning
driver at all; `_src/inference/smc.py` is SIR/CSMC only). SMC² (Chopin,
Jacob & Papaspiliopoulos 2013) maintains a population of parameter
particles, each carrying its own bootstrap particle filter over the
latent states; parameter weights are updated with the filters' unbiased
incremental-evidence estimates, and when the parameter ESS degenerates
the population is resampled and rejuvenated with PMMH moves (a fresh
masked filter over the observations seen so far). The result is an
*online* joint posterior over parameters and states plus an unbiased
model-evidence estimate — the sequential counterpart of
`inference.pmmh.PMMH`.

Accelerator shape
-----------------
Three nested structures, all dense: `vmap` over parameter particles,
`vmap` over state particles inside each, `lax.scan` over time. The
rejuvenation (the only O(t) work) sits behind a SCALAR `lax.cond` —
the parameter-ESS trigger is global, so XLA executes the masked
re-filter only on the steps where it actually fires, not per particle.
All resampling reuses the search-free systematic kernels from
`inference.smc`.
"""

from typing import Any, Callable

import jax
import jax.numpy as jnp
import jax.random as jrand
import jax.tree_util as jtu
from jax.scipy.special import logsumexp

from genjax_tpu.core.choice_map import ChoiceMap
from genjax_tpu.core.gather import take_rows
from genjax_tpu.core.gfi import GenerativeFunction
from genjax_tpu.core.pytree import Pytree
from genjax_tpu.core.staging import where_tree
from genjax_tpu.core.typing import PRNGKey
from genjax_tpu.inference.pmmh import _walk
from genjax_tpu.inference.smc import ess, systematic_resample

__all__ = ["SMC2"]


@Pytree.dataclass
class SMC2(Pytree):
    """SMC² over the parameters of a state-space model.

    Model contract (same as `inference.pmmh.PMMH`): `init_model(theta)`
    traces the initial latent state (returned) and the first observation
    at `obs_addr`; `step_model(z_prev, t, theta)` traces the transition
    and the observation at time `t`. `prior_sample(key) -> theta` draws
    a parameter pytree from the prior and `log_prior(theta)` scores it.

    `n_theta` parameter particles each carry `n_x` state particles.
    When the parameter ESS drops below `theta_ess_threshold * n_theta`,
    the parameter population is resampled and each particle gets
    `n_rejuv` PMMH moves (random-walk scale `step_scales`), whose
    likelihood estimates come from a fresh filter over the prefix of
    observations processed so far (time-masked, so the scan length stays
    static under jit).

    >>> import jax, jax.numpy as jnp
    >>> import genjax_tpu as gx
    >>> from genjax_tpu.inference.smc2 import SMC2
    >>> @gx.gen
    ... def init_model(theta):
    ...     z = gx.normal(0.0, 1.0) @ "z"
    ...     _ = gx.normal(z, 0.4) @ "y"
    ...     return z
    >>> @gx.gen
    ... def step_model(z_prev, t, theta):
    ...     z = gx.normal(theta * z_prev, 0.5) @ "z"
    ...     _ = gx.normal(z, 0.4) @ "y"
    ...     return z
    >>> alg = SMC2(step_model, init_model,
    ...            prior_sample=lambda k: jax.random.normal(k),
    ...            log_prior=lambda a: gx.normal.logpdf(a, 0.0, 1.0),
    ...            n_theta=32, n_x=64, step_scales=jnp.asarray(0.3))
    >>> ys = jnp.array([0.3, 1.0, 0.5, -0.2, 0.8])
    >>> out = alg.run(jax.random.key(0), ys)
    >>> out["thetas"].shape, bool(jnp.isfinite(out["lml"]))
    ((32,), True)
    """

    step_model: GenerativeFunction[Any]
    init_model: GenerativeFunction[Any]
    prior_sample: Callable[[PRNGKey], Any] = Pytree.static()
    log_prior: Callable[[Any], Any] = Pytree.static()
    n_theta: int = Pytree.static()
    n_x: int = Pytree.static()
    step_scales: Any = Pytree.field(default=0.25)
    obs_addr: str = Pytree.static(default="y")
    theta_ess_threshold: float = Pytree.static(default=0.5)
    inner_ess_threshold: float = Pytree.static(default=0.5)
    n_rejuv: int = Pytree.static(default=2)

    # -- inner filter pieces (per parameter particle) ---------------------
    #
    # Deliberately NOT shared with BootstrapFilter.run: these run under
    # the theta-vmap, where `lax.cond` lowers to select (both branches
    # execute) and the streaming expand_rows path loses its advantage —
    # the dense where-select + take_rows forms below are the right
    # shapes for that context. BootstrapFilter keeps the scalar-cond /
    # streaming-expansion forms for the un-vmapped large-K case.

    def _init_one(self, key: PRNGKey, theta, obs0):
        """Start one inner filter: returns (z, lw_x, incremental loglik)."""
        keys = jrand.split(key, self.n_x)
        trs, ws = jax.vmap(
            lambda k: self.init_model.importance(
                k, ChoiceMap.kw(**{self.obs_addr: obs0}), (theta,)
            )
        )(keys)
        return trs.get_retval(), ws, logsumexp(ws) - jnp.log(float(self.n_x))

    def _advance_one(self, key: PRNGKey, theta, z, lw, obs_t, t):
        """One filter step: returns (z', lw', incremental log evidence).

        The evidence increment telescopes over carried weights:
        log p_hat(y_t | y_1:t-1, theta) = lse(lw + w) - lse(lw). Inner
        resampling is adaptive; under the theta-vmap the `where` select
        evaluates both branches, which is the dense vectorized shape
        (the gather is the same cost whether or not it is kept).
        """
        k_prop, k_res = jrand.split(key)
        prop_keys = jrand.split(k_prop, self.n_x)
        trs, ws = jax.vmap(
            lambda k, z_i: self.step_model.importance(
                k, ChoiceMap.kw(**{self.obs_addr: obs_t}), (z_i, t, theta)
            )
        )(prop_keys, z)
        z2 = trs.get_retval()
        lw2 = lw + ws
        incr = logsumexp(lw2) - logsumexp(lw)
        anc = systematic_resample(k_res, lw2, self.n_x)
        need = ess(lw2) < self.inner_ess_threshold * self.n_x
        z_out = where_tree(need, take_rows(z2, anc), z2)
        lw_out = jnp.where(need, jnp.zeros_like(lw2), lw2)
        return z_out, lw_out, incr

    def _masked_loglik(self, key: PRNGKey, theta, observations, t_upto):
        """Fresh filter over y[0:t_upto] (inclusive), scanning the FULL
        padded sequence with inactive steps as identities — the static-
        shape form a data-dependent rejuvenation time requires under jit.
        Returns (loglik, z, lw_x) at time t_upto."""
        obs0 = jtu.tree_map(lambda v: v[0], observations)
        k_init, k_steps = jrand.split(key)
        z, lw, loglik = self._init_one(k_init, theta, obs0)

        T = jtu.tree_leaves(observations)[0].shape[0]
        rest = jtu.tree_map(lambda v: v[1:], observations)
        step_keys = jrand.split(k_steps, T - 1)

        def body(carry, inp):
            z, lw, loglik, i = carry
            k, obs_i = inp
            z2, lw2, incr = self._advance_one(k, theta, z, lw, obs_i, i)
            active = i <= t_upto
            z = where_tree(active, z2, z)
            lw = jnp.where(active, lw2, lw)
            loglik = loglik + jnp.where(active, incr, 0.0)
            return (z, lw, loglik, i + 1), None

        (z, lw, loglik, _), _ = jax.lax.scan(
            body, (z, lw, loglik, jnp.asarray(1)), (step_keys, rest)
        )
        return loglik, z, lw

    # -- driver ------------------------------------------------------------

    def run(
        self,
        key: PRNGKey,
        observations: Any,
        collect: Callable[[Any, Any], Any] | None = None,
    ) -> dict:
        """Run SMC² over the observation sequence.

        Returns a dict: `thetas` (parameter particles), `log_weights`
        (their final log weights), `loglik` (each particle's own
        running log p_hat(y_1:T | theta) estimate), `lml` (the
        model-evidence estimate log p_hat(y_1:T)), `n_rejuvenations`,
        `accept_rate` (mean PMMH acceptance over all moves), and — when
        `collect(thetas, log_weights)` is given — `collected`, its
        per-time-index stack with T rows (row 0 is the state after
        assimilating y_0, matching `BootstrapFilter.run`'s contract).
        """
        n_th = self.n_theta
        k_prior, k_init, k_scan = jrand.split(key, 3)

        scales = self.step_scales
        theta0_probe = self.prior_sample(jrand.key(0))
        if jtu.tree_structure(scales) != jtu.tree_structure(theta0_probe):
            scales = jtu.tree_map(lambda _: scales, theta0_probe)

        thetas = jax.vmap(self.prior_sample)(jrand.split(k_prior, n_th))
        obs0 = jtu.tree_map(lambda v: v[0], observations)
        z, lw_x, incr0 = jax.vmap(
            lambda k, th: self._init_one(k, th, obs0)
        )(jrand.split(k_init, n_th), thetas)
        loglik = incr0
        lw_th = incr0

        T = jtu.tree_leaves(observations)[0].shape[0]
        rest = jtu.tree_map(lambda v: v[1:], observations)
        step_keys = jrand.split(k_scan, T - 1)

        def pmmh_move(k, th, z_m, lw_m, ll_m, t_now):
            k_walk, k_filt, k_acc = jrand.split(k, 3)
            th_p = _walk(k_walk, th, scales)
            ll_p, z_p, lw_p = self._masked_loglik(
                k_filt, th_p, observations, t_now
            )
            log_a = self.log_prior(th_p) + ll_p - self.log_prior(th) - ll_m
            acc = jnp.log(jrand.uniform(k_acc)) < log_a
            th_out = where_tree(acc, th_p, th)
            z_out = where_tree(acc, z_p, z_m)
            lw_out = jnp.where(acc, lw_p, lw_m)
            ll_out = jnp.where(acc, ll_p, ll_m)
            return th_out, z_out, lw_out, ll_out, acc

        def time_step(carry, inp):
            thetas, z, lw_x, loglik, lw_th, lml, t, n_rej, acc_sum = carry
            k, obs_t = inp
            k_adv, k_rej = jrand.split(k)
            adv_keys = jrand.split(k_adv, n_th)
            z, lw_x, incr = jax.vmap(
                lambda kk, th, zz, ll: self._advance_one(
                    kk, th, zz, ll, obs_t, t
                )
            )(adv_keys, thetas, z, lw_x)
            loglik = loglik + incr
            lw_th = lw_th + incr

            def do_rejuv(args):
                thetas, z, lw_x, loglik, lw_th, lml, n_rej, acc_sum = args
                lml = lml + logsumexp(lw_th) - jnp.log(float(n_th))
                k_res, k_moves = jrand.split(k_rej)
                anc = systematic_resample(k_res, lw_th, n_th)
                thetas, z, lw_x, loglik = take_rows(
                    (thetas, z, lw_x, loglik), anc
                )
                lw_th = jnp.zeros_like(lw_th)
                for j in range(self.n_rejuv):
                    move_keys = jrand.split(jrand.fold_in(k_moves, j), n_th)
                    thetas, z, lw_x, loglik, accs = jax.vmap(
                        lambda kk, th, zz, ll, lg: pmmh_move(
                            kk, th, zz, ll, lg, t
                        )
                    )(move_keys, thetas, z, lw_x, loglik)
                    acc_sum = acc_sum + jnp.mean(
                        accs.astype(jnp.float32)
                    )
                return thetas, z, lw_x, loglik, lw_th, lml, n_rej + 1, acc_sum

            def keep(args):
                return args

            need = ess(lw_th) < self.theta_ess_threshold * n_th
            thetas, z, lw_x, loglik, lw_th, lml, n_rej, acc_sum = jax.lax.cond(
                need,
                do_rejuv,
                keep,
                (thetas, z, lw_x, loglik, lw_th, lml, n_rej, acc_sum),
            )
            out = collect(thetas, lw_th) if collect is not None else None
            return (
                thetas, z, lw_x, loglik, lw_th, lml, t + 1, n_rej, acc_sum
            ), out

        init_carry = (
            thetas, z, lw_x, loglik, lw_th,
            jnp.zeros(()), jnp.asarray(1),
            jnp.zeros((), jnp.int32), jnp.zeros(()),
        )
        (
            thetas, z, lw_x, loglik, lw_th, lml, _, n_rej, acc_sum
        ), outs = jax.lax.scan(time_step, init_carry, (step_keys, rest))

        lml = lml + logsumexp(lw_th) - jnp.log(float(n_th))
        if collect is not None:
            out0 = collect(
                jax.vmap(self.prior_sample)(jrand.split(k_prior, n_th)),
                incr0,
            )
            outs = jtu.tree_map(
                lambda a, rest: jnp.concatenate([a[None], rest], axis=0),
                out0,
                outs,
            )
        total_moves = n_rej.astype(jnp.float32) * float(self.n_rejuv)
        result = {
            "thetas": thetas,
            "log_weights": lw_th,
            "loglik": loglik,
            "lml": lml,
            "n_rejuvenations": n_rej,
            "accept_rate": jnp.where(
                total_moves > 0, acc_sum / jnp.maximum(total_moves, 1.0), 0.0
            ),
        }
        if collect is not None:
            result["collected"] = outs
        return result
