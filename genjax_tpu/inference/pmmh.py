"""Particle marginal Metropolis-Hastings (PMMH).

Beyond the reference (genjax-community/genjax ships no parameter-learning
driver for state-space models; its SMC library is SIR/CSMC only,
`_src/inference/smc.py`). PMMH (Andrieu, Doucet & Holenstein 2010,
"Particle Markov chain Monte Carlo methods") targets the joint posterior
over model PARAMETERS of a state-space model by running MH whose
likelihood term is the bootstrap filter's unbiased marginal-likelihood
estimate — the pseudo-marginal construction keeps the chain's stationary
distribution exactly the true parameter posterior, for any particle
count.

Accelerator shape: each MH step re-runs `BootstrapFilter.run` at the proposed
parameters — a `lax.scan` over time around a K-wide `vmap` — so the
whole chain is a scan-of-scans, one compiled program. Multiple PMMH
chains vectorize with one more `vmap` (parameters and LML carries are
scalars/small pytrees; the filter state never leaves the step).
"""

from typing import Any, Callable

import jax
import jax.numpy as jnp
import jax.random as jrand
import jax.tree_util as jtu

from genjax_tpu.core.pytree import Pytree
from genjax_tpu.core.staging import where_tree
from genjax_tpu.core.typing import PRNGKey
from genjax_tpu.inference.particle_filter import BootstrapFilter

__all__ = ["PMMH"]


def _walk(key: PRNGKey, theta, scales):
    """Gaussian random-walk proposal, one fold_in per leaf (symmetric, so
    the proposal density cancels in the acceptance ratio)."""
    leaves_ct = len(jtu.tree_leaves(theta))
    seed_tree = jtu.tree_unflatten(
        jtu.tree_structure(theta), list(range(leaves_ct))
    )
    return jtu.tree_map(
        lambda v, seed, s: v
        + s * jrand.normal(jrand.fold_in(key, seed), jnp.shape(v)),
        theta,
        seed_tree,
        scales,
    )


@Pytree.dataclass
class PMMH(Pytree):
    """MH over state-space-model parameters with a particle-filter
    likelihood estimate (exact pseudo-marginal target).

    The wrapped filter's models must accept the parameters as one extra
    trailing argument: `init_model(theta)` and
    `step_model(z_prev, t, theta)` (`theta` may be any pytree).
    `log_prior(theta)` scores the parameter prior; `step_scales` is the
    random-walk proposal scale (scalar or a pytree matching `theta`).

    >>> import jax, jax.numpy as jnp
    >>> import genjax_tpu as gx
    >>> from genjax_tpu.inference.particle_filter import BootstrapFilter
    >>> from genjax_tpu.inference.pmmh import PMMH
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
    >>> pf = BootstrapFilter(step_model, init_model, 256, obs_addr="y")
    >>> alg = PMMH(pf, log_prior=lambda a: gx.normal.logpdf(a, 0.0, 1.0),
    ...            step_scales=jnp.asarray(0.2))
    >>> ys = jnp.array([0.3, 1.0, 0.5, -0.2, 0.8])
    >>> theta, (thetas, lmls, accepts) = alg.run(
    ...     jax.random.key(0), jnp.asarray(0.5), ys, n_steps=10)
    >>> thetas.shape, bool(jnp.isfinite(lmls).all())
    ((10,), True)
    """

    filter: BootstrapFilter
    log_prior: Callable[[Any], Any] = Pytree.static()
    step_scales: Any = Pytree.field(default=0.25)

    def run(
        self,
        key: PRNGKey,
        theta0: Any,
        observations: Any,
        n_steps: int,
        collect: Callable[[Any], Any] | None = None,
    ):
        """Run the PMMH chain from `theta0`. Returns
        `(final_theta, (collected, lmls, accepts))` where `collected` is
        `collect(theta)` per step (default: `theta`), `lmls` the carried
        marginal-likelihood estimates, and `accepts` the accept flags.

        Pseudo-marginal discipline: the LML estimate attached to the
        CURRENT parameters is carried, never re-estimated — re-running
        the filter for a held value would bias the chain (the estimate
        is part of the extended state).
        """
        scales = self.step_scales
        if jtu.tree_structure(scales) != jtu.tree_structure(theta0):
            # Scalar (or otherwise non-matching) scale: broadcast one
            # value to every parameter leaf.
            scales = jtu.tree_map(lambda _: scales, theta0)

        k_init, k_chain = jrand.split(key)
        lml0, _ = self.filter.run(k_init, observations, (theta0,))
        lp0 = self.log_prior(theta0)

        def step(carry, step_key):
            theta, lml, lp = carry
            k_prop, k_filt, k_acc = jrand.split(step_key, 3)
            theta_p = _walk(k_prop, theta, scales)
            lml_p, _ = self.filter.run(k_filt, observations, (theta_p,))
            lp_p = self.log_prior(theta_p)
            alpha = lml_p + lp_p - lml - lp
            accept = jnp.log(jrand.uniform(k_acc)) < alpha
            theta = where_tree(accept, theta_p, theta)
            lml = jnp.where(accept, lml_p, lml)
            lp = jnp.where(accept, lp_p, lp)
            out = collect(theta) if collect is not None else theta
            return (theta, lml, lp), (out, lml, accept)

        keys = jrand.split(k_chain, n_steps)
        (theta, _, _), outs = jax.lax.scan(step, (theta0, lml0, lp0), keys)
        return theta, outs
