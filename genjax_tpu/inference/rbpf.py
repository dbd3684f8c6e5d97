"""Rao-Blackwellized particle filter for conditionally-linear SSMs.

Beyond the reference (no marginalized filters; SURVEY C26 lists SIR/CSMC
only). For models whose latent splits into a nonlinear regime process
`z` and a linear-Gaussian substate `x` GIVEN the z-path,

    z_t ~ f(z | z_{t-1})                     (any @gen kernel)
    x_t = A(z_t) x_{t-1} + N(0, Q(z_t))
    y_t = H(z_t) x_t     + N(0, R(z_t)),

the x-marginal is exactly Gaussian per z-path, so each particle carries
`(z, mu, P)` and its weight increment is the Kalman innovation
likelihood — sampling only the z-dimension (Doucet, de Freitas, Murphy
& Russell 2000). Rao-Blackwellization strictly reduces the weight
variance relative to a particle filter on the joint `(z, x)` state
(tested head-to-head in tests/inference/test_rbpf.py).

Accelerator shape: the per-particle Kalman step is `kalman_predict_update`
vmapped over the batch — dense (K, d, d) batched matmuls on the matrix units —
and resampling reuses the framework's adaptive systematic machinery on
the packed `(z, mu, P)` rows.
"""

from typing import Any, Callable

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
from jax.scipy.special import logsumexp

from genjax_tpu.core.gather import take_rows
from genjax_tpu.core.gfi import GenerativeFunction
from genjax_tpu.core.pytree import Pytree
from genjax_tpu.core.typing import FloatArray, PRNGKey
from genjax_tpu.inference.kalman import LinearGaussianSSM, kalman_predict_update
from genjax_tpu.inference.smc import RESAMPLERS, ess

__all__ = ["RaoBlackwellFilter"]


@Pytree.dataclass
class RaoBlackwellFilter(Pytree):
    """`z_init(*model_args)` / `z_step(z_prev, t, *model_args)` are @gen
    kernels over the nonlinear state (their retval is the new `z`; they
    trace no observation — the observation density comes from the Kalman
    step).
    `lgss_of_z(z, *model_args) -> LinearGaussianSSM` supplies the linear
    substate's matrices given the current regime (only `A`, `Q`, `H`,
    `R` are read per step; `mu0`, `P0` seed the t=0 update).
    """

    z_step: GenerativeFunction[Any]
    z_init: GenerativeFunction[Any]
    lgss_of_z: Callable[..., LinearGaussianSSM] = Pytree.static()
    n_particles: int = Pytree.static()
    resampling: str = Pytree.static(default="systematic")
    ess_threshold: float = Pytree.static(default=0.5)

    def run(
        self, key: PRNGKey, observations: FloatArray, model_args: tuple = ()
    ) -> tuple[FloatArray, Any]:
        """Filter `observations` (T, p); returns `(lml_estimate,
        (z_particles, mu_particles, P_particles))` — equally-weighted
        after a final resample, matching `BootstrapFilter.run`."""
        n = self.n_particles
        k_init, k_steps = jax.random.split(key)

        y0 = jtu.tree_map(lambda v: v[0], observations)
        init_keys = jax.random.split(k_init, n)
        z = jax.vmap(
            lambda k: self.z_init.simulate(k, model_args).get_retval()
        )(init_keys)

        def kstep(z_i, mu_i, P_i, y, predict):
            m = self.lgss_of_z(z_i, *model_args)
            return kalman_predict_update(
                m.A, m.Q, m.H, m.R, mu_i, P_i, y, predict=predict
            )

        m0 = jax.vmap(lambda z_i: self.lgss_of_z(z_i, *model_args))(z)
        mu, P, ll0 = jax.vmap(
            lambda z_i, mu_i, P_i: kstep(z_i, mu_i, P_i, y0, False)
        )(z, m0.mu0, m0.P0)
        lw = ll0

        def step(carry, inp):
            z, mu, P, lw, lml, t = carry
            key, y_t = inp
            k_prop, k_res = jax.random.split(key)

            def _resample(z, mu, P, lw, lml):
                lml = lml + logsumexp(lw) - jnp.log(float(n))
                if self.resampling == "systematic":
                    # same streaming-expansion fast path as
                    # BootstrapFilter: no ancestor vector, no row gather
                    from genjax_tpu.inference.smc import (
                        systematic_cum_counts,
                    )
                    from genjax_tpu.ops.expand import expand_rows

                    cum = systematic_cum_counts(k_res, lw, n)
                    state = expand_rows((z, mu, P), cum, n_rows=n)
                else:
                    anc = RESAMPLERS[self.resampling](k_res, lw, n)
                    state = take_rows((z, mu, P), anc)
                return (*state, jnp.zeros_like(lw), lml)

            def _keep(z, mu, P, lw, lml):
                return z, mu, P, lw, lml

            z, mu, P, lw, lml = jax.lax.cond(
                ess(lw) < self.ess_threshold * n,
                _resample,
                _keep,
                z, mu, P, lw, lml,
            )

            prop_keys = jax.random.split(k_prop, n)
            z = jax.vmap(
                lambda k, z_i: self.z_step.simulate(
                    k, (z_i, t, *model_args)
                ).get_retval()
            )(prop_keys, z)
            mu, P, ll = jax.vmap(
                lambda z_i, mu_i, P_i: kstep(z_i, mu_i, P_i, y_t, True)
            )(z, mu, P)
            lw = lw + ll
            return (z, mu, P, lw, lml, t + 1), None

        T = jtu.tree_leaves(observations)[0].shape[0]
        step_keys = jax.random.split(k_steps, T - 1)
        rest = jtu.tree_map(lambda v: v[1:], observations)
        (z, mu, P, lw, lml, _), _ = jax.lax.scan(
            step, (z, mu, P, lw, jnp.zeros(()), 1), (step_keys, rest)
        )
        lml = lml + logsumexp(lw) - jnp.log(float(n))
        anc = RESAMPLERS[self.resampling](
            jax.random.fold_in(k_steps, T), lw, n
        )
        z, mu, P = take_rows((z, mu, P), anc)
        return lml, (z, mu, P)
