"""Particle Gibbs with ancestor sampling (PGAS) for state-space models.

Beyond the reference (genjax-community/genjax ships CSMC only as a
density estimator inside `run_csmc`, `_src/inference/smc.py:317-351` —
no path-space kernel, no parameter learning). This module completes the
particle-MCMC family of Andrieu, Doucet & Holenstein (2010) next to
`inference.pmmh.PMMH`:

- `csmc_sweep`: a conditional bootstrap filter over the latent PATH —
  one particle is pinned to the retained trajectory, the rest propagate
  freely, and a full path is drawn from the lineage tree at the end.
  The sweep is a Markov kernel that leaves p(z_{1:T} | y_{1:T}, theta)
  invariant for ANY particle count. With `ancestor_sampling` (Lindsten,
  Jordan & Schön 2014), the retained particle's parent is re-drawn each
  step against the transition density, which breaks path degeneracy and
  makes mixing roughly T-independent.
- `ParticleGibbs`: alternates the CSMC path move with a random-walk MH
  move on the parameters scored by the EXACT joint density of the
  retained path (a `lax.scan` of `assess`) — a partially-collapsed Gibbs
  sampler on p(theta, z_{1:T} | y_{1:T}).

Accelerator shape: the sweep is a `lax.scan` over time around K-wide `vmap`s
(one fused density pass per particle per step); per-step states and
ancestor indices are scan outputs, and the path is reconstructed by a
reverse scan over the stored lineage — all dense, no Python loops.
Conditional resampling is multinomial (exact conditional validity with
index 0 pinned); PG runs at modest K (hundreds), where the O(K) gathers
are trivially cheap.
"""

from typing import Any, Callable

import jax
import jax.numpy as jnp
import jax.random as jrand
import jax.tree_util as jtu

from genjax_tpu.core.choice_map import ChoiceMap, Selection
from genjax_tpu.core.gather import take_rows
from genjax_tpu.core.pytree import Pytree
from genjax_tpu.core.staging import where_tree
from genjax_tpu.core.typing import PRNGKey
from genjax_tpu.inference.particle_filter import BootstrapFilter
from genjax_tpu.inference.pmmh import _walk

__all__ = ["ParticleGibbs", "csmc_sweep"]


def _tree_at0_set(batched, single):
    """Set index 0 of every leading-K leaf to the matching `single` leaf."""
    return jtu.tree_map(lambda b, s: b.at[0].set(s), batched, single)


def _retained_step(gen_fn, key, latent_addr, obs_addr, z_ret, obs, args):
    """Incremental weight of the pinned particle: the model's density of
    (z_ret, obs) given `args`, minus the latent's own score — i.e. the
    observation term g(obs | z_ret) the free particles also carry."""
    constraint = ChoiceMap.kw(**{latent_addr: z_ret, obs_addr: obs})
    tr, w_full = gen_fn.importance(key, constraint, args)
    return w_full - tr.project(key, Selection.at[latent_addr])


def csmc_sweep(
    key: PRNGKey,
    filter: BootstrapFilter,
    observations: Any,
    retained_path: Any,
    model_args: tuple = (),
    latent_addr: str = "z",
    ancestor_sampling: bool = True,
):
    """One conditional-SMC sweep; returns a fresh latent path
    `(T, ...)`-pytree drawn from the particle lineage tree.

    `retained_path` is the current path (leaves with leading time axis
    T matching `observations`). The filter's models follow the
    `BootstrapFilter` contract — `init_model(*model_args)` /
    `step_model(z_prev, t, *model_args)`, tracing the latent at
    `latent_addr` (returned as the retval) and the observation at
    `filter.obs_addr`.
    """
    n = filter.n_particles
    obs_addr = filter.obs_addr
    k_init, k_ret0, k_steps, k_pick = jrand.split(key, 4)

    obs0 = jtu.tree_map(lambda v: v[0], observations)
    ret0 = jtu.tree_map(lambda v: v[0], retained_path)

    init_keys = jrand.split(k_init, n)
    init_trs, init_ws = jax.vmap(
        lambda k: filter.init_model.importance(
            k, ChoiceMap.kw(**{obs_addr: obs0}), model_args
        )
    )(init_keys)
    z = init_trs.get_retval()
    w_ret0 = _retained_step(
        filter.init_model, k_ret0, latent_addr, obs_addr, ret0, obs0, model_args
    )
    z = _tree_at0_set(z, ret0)
    lw = init_ws.at[0].set(w_ret0)

    def step(carry, inp):
        z, lw, t = carry
        key, obs_t, ret_t = inp
        k_anc, k_as, k_prop, k_retw = jrand.split(key, 4)

        # Conditional multinomial resampling: free slots draw ancestors
        # from the weights; slot 0's ancestor is the retained lineage
        # (index 0), unless ancestor sampling re-draws it against the
        # transition-adjusted weights.
        anc = jrand.categorical(k_anc, lw, shape=(n,))
        if ancestor_sampling:
            # P(anc_0 = i) ~ w_i * f(ret_t | z_i): the model density of
            # (ret_t, obs_t) given parent z_i differs from f only by the
            # g(obs_t | ret_t) factor, which is constant in i and cancels
            # in the categorical.
            k_as1, k_as2 = jrand.split(k_as)
            as_keys = jrand.split(k_as1, n)
            _, as_scores = jax.vmap(
                lambda k, z_i: filter.step_model.importance(
                    k,
                    ChoiceMap.kw(**{latent_addr: ret_t, obs_addr: obs_t}),
                    (z_i, t, *model_args),
                )
            )(as_keys, z)
            anc0 = jrand.categorical(k_as2, lw + as_scores)
        else:
            anc0 = jnp.zeros((), anc.dtype)
        anc = anc.at[0].set(anc0)
        z_prev = take_rows(z, anc, n_rows=n)

        prop_keys = jrand.split(k_prop, n)
        trs, ws = jax.vmap(
            lambda k, z_i: filter.step_model.importance(
                k, ChoiceMap.kw(**{obs_addr: obs_t}), (z_i, t, *model_args)
            )
        )(prop_keys, z_prev)
        z_new = trs.get_retval()
        z_parent0 = jtu.tree_map(lambda v: v[0], z_prev)
        w_ret = _retained_step(
            filter.step_model,
            k_retw,
            latent_addr,
            obs_addr,
            ret_t,
            obs_t,
            (z_parent0, t, *model_args),
        )
        z_new = _tree_at0_set(z_new, ret_t)
        lw = ws.at[0].set(w_ret)
        return (z_new, lw, t + 1), (z_new, anc)

    T = jtu.tree_leaves(observations)[0].shape[0]
    step_keys = jrand.split(k_steps, T - 1)
    rest_obs = jtu.tree_map(lambda v: v[1:], observations)
    rest_ret = jtu.tree_map(lambda v: v[1:], retained_path)
    (z_fin, lw, _), (zs, ancs) = jax.lax.scan(
        step, (z, lw, 1), (step_keys, rest_obs, rest_ret)
    )
    # zs: (T-1, K, ...); ancs: (T-1, K). Stack the t=0 states in front.
    zs = jtu.tree_map(
        lambda z0, rest: jnp.concatenate([z0[None], rest], axis=0), z, zs
    )

    # Draw the output path: final index from the final weights, then
    # walk the lineage backwards (a reverse scan over stored ancestors).
    b_last = jrand.categorical(k_pick, lw)

    def back(b, inp):
        anc_t, z_t = inp
        # z_t are the states AT step t (entered via ancestors anc_t);
        # emit the chosen state, then step the index to its parent.
        chosen = jtu.tree_map(lambda v: v[b], z_t)
        return anc_t[b], chosen

    zs_tail = jtu.tree_map(lambda v: v[1:], zs)
    b0, path_tail = jax.lax.scan(
        back, b_last, (ancs, zs_tail), reverse=True
    )
    path0 = jtu.tree_map(lambda v: v[0][b0], zs)
    return jtu.tree_map(
        lambda p0, rest: jnp.concatenate([p0[None], rest], axis=0),
        path0,
        path_tail,
    )


def path_log_joint(
    filter: BootstrapFilter,
    path: Any,
    observations: Any,
    model_args: tuple = (),
    latent_addr: str = "z",
):
    """Exact log p(path, observations | model_args): one `assess` of the
    init model plus a scan of step-model `assess` calls."""
    obs_addr = filter.obs_addr
    obs0 = jtu.tree_map(lambda v: v[0], observations)
    p0 = jtu.tree_map(lambda v: v[0], path)
    s0, _ = filter.init_model.assess(
        ChoiceMap.kw(**{latent_addr: p0, obs_addr: obs0}), model_args
    )

    def step(carry, inp):
        z_prev, t, acc = carry
        obs_t, p_t = inp
        s, _ = filter.step_model.assess(
            ChoiceMap.kw(**{latent_addr: p_t, obs_addr: obs_t}),
            (z_prev, t, *model_args),
        )
        return (p_t, t + 1, acc + s), None

    rest_obs = jtu.tree_map(lambda v: v[1:], observations)
    rest_path = jtu.tree_map(lambda v: v[1:], path)
    (_, _, total), _ = jax.lax.scan(step, (p0, 1, s0), (rest_obs, rest_path))
    return total


@Pytree.dataclass
class ParticleGibbs(Pytree):
    """Particle Gibbs: alternate a CSMC path move (given the parameters)
    with a random-walk MH parameter move scored by the exact joint
    density of the retained path. Targets p(theta, z_{1:T} | y_{1:T})
    exactly for any particle count.

    The filter's models must accept the parameters as one extra trailing
    argument (the `BootstrapFilter.run(model_args=...)` convention shared
    with `PMMH`).

    >>> import jax, jax.numpy as jnp
    >>> import genjax_tpu as gx
    >>> from genjax_tpu.inference.particle_filter import BootstrapFilter
    >>> from genjax_tpu.inference.particle_gibbs import ParticleGibbs
    >>> @gx.gen
    ... def init_model(a):
    ...     z = gx.normal(0.0, 1.0) @ "z"
    ...     _ = gx.normal(z, 0.4) @ "y"
    ...     return z
    >>> @gx.gen
    ... def step_model(z_prev, t, a):
    ...     z = gx.normal(a * z_prev, 0.5) @ "z"
    ...     _ = gx.normal(z, 0.4) @ "y"
    ...     return z
    >>> pf = BootstrapFilter(step_model, init_model, 64, obs_addr="y")
    >>> pg = ParticleGibbs(pf, log_prior=lambda a: gx.normal.logpdf(a, 0.0, 1.0),
    ...                    step_scales=jnp.asarray(0.3))
    >>> ys = jnp.array([0.3, 1.0, 0.5, -0.2, 0.8])
    >>> theta, path, (thetas, accepts) = pg.run(
    ...     jax.random.key(0), jnp.asarray(0.5), ys, n_sweeps=5)
    >>> thetas.shape, path.shape
    ((5,), (5,))
    """

    filter: BootstrapFilter
    log_prior: Callable[[Any], Any] = Pytree.static()
    step_scales: Any = Pytree.field(default=0.25)
    latent_addr: str = Pytree.static(default="z")
    ancestor_sampling: bool = Pytree.static(default=True)
    theta_steps: int = Pytree.static(default=1)

    def run(
        self,
        key: PRNGKey,
        theta0: Any,
        observations: Any,
        n_sweeps: int,
        init_path: Any = None,
        collect: Callable[[Any, Any], Any] | None = None,
    ):
        """Run the PG chain. Returns `(theta, path, (collected, accepts))`
        with `collected = collect(theta, path)` per sweep (default:
        `theta`). `init_path` defaults to a prior rollout under
        `theta0` (any init is valid; the chain burns in)."""
        scales = self.step_scales
        if jtu.tree_structure(scales) != jtu.tree_structure(theta0):
            scales = jtu.tree_map(lambda _: scales, theta0)
        la = self.latent_addr

        k_init, k_chain = jrand.split(key)
        if init_path is None:
            init_path = self._prior_rollout(k_init, theta0, observations)

        def theta_move(k, theta, path):
            def one(carry, kk):
                theta, lj, lp = carry
                k1, k2 = jrand.split(kk)
                theta_p = _walk(k1, theta, scales)
                lj_p = path_log_joint(
                    self.filter, path, observations, (theta_p,), la
                )
                lp_p = self.log_prior(theta_p)
                accept = jnp.log(jrand.uniform(k2)) < lj_p + lp_p - lj - lp
                theta = where_tree(accept, theta_p, theta)
                lj = jnp.where(accept, lj_p, lj)
                lp = jnp.where(accept, lp_p, lp)
                return (theta, lj, lp), accept

            lj0 = path_log_joint(self.filter, path, observations, (theta,), la)
            (theta, _, _), accs = jax.lax.scan(
                one,
                (theta, lj0, self.log_prior(theta)),
                jrand.split(k, self.theta_steps),
            )
            return theta, jnp.mean(accs)

        def sweep(carry, sweep_key):
            theta, path = carry
            k_path, k_theta = jrand.split(sweep_key)
            path = csmc_sweep(
                k_path,
                self.filter,
                observations,
                path,
                (theta,),
                latent_addr=la,
                ancestor_sampling=self.ancestor_sampling,
            )
            theta, acc = theta_move(k_theta, theta, path)
            out = collect(theta, path) if collect is not None else theta
            return (theta, path), (out, acc)

        keys = jrand.split(k_chain, n_sweeps)
        (theta, path), outs = jax.lax.scan(sweep, (theta0, init_path), keys)
        return theta, path, outs

    def _prior_rollout(self, key: PRNGKey, theta, observations):
        """A latent path simulated from the prior under `theta`."""
        T = jtu.tree_leaves(observations)[0].shape[0]
        k0, ks = jrand.split(key)
        tr0 = self.filter.init_model.simulate(k0, (theta,))
        z0 = tr0.get_retval()

        def step(carry, inp):
            z, t = carry
            k = inp
            tr = self.filter.step_model.simulate(k, (z, t, theta))
            z = tr.get_retval()
            return (z, t + 1), z

        _, zs = jax.lax.scan(step, (z0, 1), jrand.split(ks, T - 1))
        return jtu.tree_map(
            lambda a, rest: jnp.concatenate([a[None], rest], axis=0), z0, zs
        )
