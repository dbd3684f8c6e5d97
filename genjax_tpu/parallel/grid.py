"""2-D mesh inference: independent SMC runs (chains) × particles.

The PPL analogue of multi-axis dp×tp sharding (SURVEY.md §2.2 P4): a
`(chains, particles)` device mesh carries a `(C, K)` grid of particles —
C independent SMC runs of K particles each. Per-chain reductions (LML,
ESS) are `pmax`/`psum` collectives along the particle axis ONLY; chains
never communicate (they exist for replicated LML estimates, posterior
variance diagnostics, and multi-temperature schemes).

Promoted into the library from `__graft_entry__.dryrun_multichip`;
tested against the dense single-device driver on
the 8-device virtual mesh (`tests/parallel/test_grid.py`).
"""

from functools import partial
from typing import Generic, TypeVar

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from genjax_tpu.core.choice_map import ChoiceMap
from genjax_tpu.core.pytree import Pytree
from genjax_tpu.core.typing import FloatArray, IntArray, PRNGKey
from genjax_tpu.inference.smc import ParticleCollection, systematic_cum_counts
from genjax_tpu.inference.sp import Target

R = TypeVar("R")


def grid_mesh(
    chain_devices: int | None = None,
    particle_devices: int | None = None,
    chain_axis: str = "chains",
    particle_axis: str = "particles",
) -> Mesh:
    """A 2-D `(chains, particles)` device mesh. Defaults to a 2 × (n/2)
    layout over all devices (1 × n when only one device is present)."""
    n = len(jax.devices())
    if chain_devices is None:
        chain_devices = 2 if n >= 2 else 1
    if particle_devices is None:
        particle_devices = n // chain_devices
    used = chain_devices * particle_devices
    return jax.make_mesh(
        (chain_devices, particle_devices),
        (chain_axis, particle_axis),
        devices=jax.devices()[:used],
        axis_types=(jax.sharding.AxisType.Auto,) * 2,
    )


@Pytree.dataclass
class GridSMC(Generic[R], Pytree):
    """C independent SMC runs of K particles on a `(chains, particles)`
    mesh. State is a `ParticleCollection` whose leaves carry leading
    `(C, K)` axes, both sharded. All reductions are per-chain
    (`out_specs` keep the chain axis; `psum`/`pmax` ride the particle
    axis of the mesh only)."""

    n_chains: int = Pytree.static()
    n_particles: int = Pytree.static()
    mesh: Mesh = Pytree.static()
    chain_axis: str = Pytree.static(default="chains")
    particle_axis: str = Pytree.static(default="particles")
    ess_threshold: float = Pytree.static(default=0.5)

    def _spec(self, *extra):
        return P(self.chain_axis, self.particle_axis, *extra)

    def _is_grid_leaf(self, v) -> bool:
        return (
            getattr(v, "ndim", 0) >= 2
            and v.shape[0] == self.n_chains
            and v.shape[1] == self.n_particles
        )

    def _grid_axes(self, tree):
        """Per-leaf vmap axes: 0 for leaves carrying the (C, K) grid,
        None for shared leaves (the `share_chain_args` layout)."""
        return jtu.tree_map(
            lambda v: 0 if self._is_grid_leaf(v) else None, tree
        )

    def _constrain(self, tree):
        sharding = NamedSharding(self.mesh, self._spec())
        replicated = NamedSharding(self.mesh, P())
        return jtu.tree_map(
            lambda v: jax.lax.with_sharding_constraint(
                v, sharding if self._is_grid_leaf(v) else replicated
            ),
            tree,
        )

    def _grid_keys(self, key: PRNGKey):
        keys = jax.random.split(key, self.n_chains * self.n_particles)
        keys = keys.reshape(self.n_chains, self.n_particles)
        return jax.lax.with_sharding_constraint(
            keys, NamedSharding(self.mesh, self._spec())
        )

    # -- lifecycle ---------------------------------------------------------

    def init(self, key: PRNGKey, target: Target[R]) -> ParticleCollection[R]:
        import dataclasses

        keys = self._grid_keys(key)
        trs, ws = jax.vmap(
            jax.vmap(target.importance, in_axes=(0, None)), in_axes=(0, None)
        )(keys, ChoiceMap.empty())
        # One shared copy of the target's arguments across the grid (see
        # mcmc.share_chain_args / ARCHITECTURE.md 4b). A shared leaf whose
        # own leading dimension collides with EITHER grid axis (chain
        # count or particle count) is ambiguous under the per-leaf-axes
        # heuristics at both vmap levels — keep its broadcast form.
        def pick(shared, batched):
            dim0 = jnp.shape(shared)[0] if getattr(shared, "ndim", 0) >= 1 else None
            if dim0 in (self.n_chains, self.n_particles):
                return batched
            return shared

        new_args = jtu.tree_map(pick, target.args, trs.get_args())
        trs = dataclasses.replace(trs, args=new_args)
        # Observed data is identical across the whole grid: one copy.
        from genjax_tpu.inference.smc import share_constrained_values

        trs = share_constrained_values(
            trs, target.constraint, (self.n_chains, self.n_particles)
        )
        return ParticleCollection(
            self._constrain(trs), self._constrain(ws), jnp.array(True)
        )

    def per_chain_lml(self, collection: ParticleCollection[R]) -> FloatArray:
        """(C,) log marginal likelihood estimates, one per chain."""

        @partial(
            shard_map,
            mesh=self.mesh,
            in_specs=self._spec(),
            out_specs=P(self.chain_axis),
        )
        def _lml(lw):
            m = jax.lax.pmax(
                jnp.max(lw, axis=1, keepdims=True), self.particle_axis
            )
            s = jax.lax.psum(
                jnp.sum(jnp.exp(lw - m), axis=1, keepdims=True),
                self.particle_axis,
            )
            return (m + jnp.log(s) - jnp.log(float(self.n_particles)))[:, 0]

        return _lml(collection.get_log_weights())

    def per_chain_ess(self, collection: ParticleCollection[R]) -> FloatArray:
        """(C,) effective sample sizes, one per chain."""

        @partial(
            shard_map,
            mesh=self.mesh,
            in_specs=self._spec(),
            out_specs=P(self.chain_axis),
        )
        def _ess(lw):
            m = jax.lax.pmax(
                jnp.max(lw, axis=1, keepdims=True), self.particle_axis
            )
            s1 = jax.lax.psum(
                jnp.sum(jnp.exp(lw - m), axis=1, keepdims=True),
                self.particle_axis,
            )
            s2 = jax.lax.psum(
                jnp.sum(jnp.exp(2.0 * (lw - m)), axis=1, keepdims=True),
                self.particle_axis,
            )
            return (s1 * s1 / s2)[:, 0]

        return _ess(collection.get_log_weights())

    # -- resampling ---------------------------------------------------------

    def _per_chain_ancestors(self, key: PRNGKey, log_weights) -> IntArray:
        """(C, K) global ancestor indices: independent systematic
        resampling per chain, distributed over the particle axis (the
        search-free scatter + `cummax` form of `inference/smc.py`,
        vectorized over the local chain rows)."""
        chain_keys = jax.random.split(key, self.n_chains)
        chain_keys = jax.lax.with_sharding_constraint(
            chain_keys, NamedSharding(self.mesh, P(self.chain_axis))
        )
        n = self.n_particles

        @partial(
            shard_map,
            mesh=self.mesh,
            in_specs=(P(self.chain_axis), self._spec()),
            out_specs=self._spec(),
        )
        def _anc(keys_local, lw_local):
            lw = jax.lax.all_gather(
                lw_local, self.particle_axis, axis=1, tiled=True
            )  # (C_local, K)
            per_shard = lw_local.shape[1]
            lo = jax.lax.axis_index(self.particle_axis) * per_shard

            def one_chain(chain_key, lw_row):
                n_cum = systematic_cum_counts(chain_key, lw_row, n)
                starts = jnp.concatenate(
                    [jnp.zeros((1,), jnp.int32), n_cum[:-1]]
                )
                occupied = n_cum > starts
                local_starts = jnp.maximum(starts - lo, 0)
                in_range = occupied & (starts < lo + per_shard)
                scatter_idx = jnp.where(in_range, local_starts, per_shard)
                anc0 = (
                    jnp.zeros((per_shard,), jnp.int32)
                    .at[scatter_idx]
                    .max(jnp.arange(n, dtype=jnp.int32), mode="drop")
                )
                return jax.lax.cummax(anc0)

            return jax.vmap(one_chain)(keys_local, lw)

        return _anc(chain_keys, log_weights)

    def resample(
        self, key: PRNGKey, collection: ParticleCollection[R]
    ) -> ParticleCollection[R]:
        from genjax_tpu.core.gather import take_rows

        anc = self._per_chain_ancestors(key, collection.get_log_weights())
        # Per-chain packed row-take along the particle axis (vmapped over
        # chains; see core/gather.py); XLA's SPMD partitioner inserts the
        # minimal cross-shard exchange. Shared leaves ride along unmapped
        # and untouched.
        particles = collection.get_particles()
        axes = self._grid_axes(particles)
        new_particles = jax.vmap(
            lambda p, a: take_rows(p, a, n_rows=self.n_particles),
            in_axes=(axes, 0),
            out_axes=axes,
        )(particles, anc)
        avg = self.per_chain_lml(collection)  # (C,)
        new_lw = jnp.broadcast_to(avg[:, None], (self.n_chains, self.n_particles))
        return ParticleCollection(
            self._constrain(new_particles),
            self._constrain(new_lw),
            collection.is_valid,
        )

    def maybe_resample(
        self, key: PRNGKey, collection: ParticleCollection[R]
    ) -> ParticleCollection[R]:
        """Resample each chain independently when ITS ESS drops below the
        threshold (chains degenerate at different times)."""
        do = self.per_chain_ess(collection) < self.ess_threshold * self.n_particles
        resampled = self.resample(key, collection)

        def _select(a, b):
            # Only leaves carrying the chain axis participate in the
            # per-chain select; scalar leaves (e.g. `is_valid`) must keep
            # their avals (a 0-d leaf reshaped against `do` would silently
            # become (C,) and break scan/cond carries).
            if a.ndim == 0 or a.shape[0] != self.n_chains:
                return b
            flags = do.reshape((self.n_chains,) + (1,) * (a.ndim - 1))
            return jnp.where(flags, a, b)

        return jtu.tree_map(_select, resampled, collection)

    # -- moves ---------------------------------------------------------------

    def extend(
        self,
        key: PRNGKey,
        collection: ParticleCollection[R],
        constraint: ChoiceMap,
        argdiffs: tuple | None = None,
    ) -> ParticleCollection[R]:
        from genjax_tpu.core.diff import Diff

        keys = self._grid_keys(key)
        sel = constraint.get_selection()

        def _extend(key, particle):
            ad = (
                Diff.no_change(particle.get_args()) if argdiffs is None else argdiffs
            )
            k_proj, k_upd = jax.random.split(key)
            discarded = particle.project(k_proj, sel)
            new_tr, w, _, _ = particle.get_gen_fn().update(
                k_upd, particle, constraint, ad
            )
            return new_tr, w + discarded

        particles = collection.get_particles()
        axes = self._grid_axes(particles)
        new_particles, ws = jax.vmap(
            jax.vmap(_extend, in_axes=(0, axes), out_axes=(axes, 0)),
            in_axes=(0, axes),
            out_axes=(axes, 0),
        )(keys, particles)
        return ParticleCollection(
            self._constrain(new_particles),
            self._constrain(collection.get_log_weights() + ws),
            collection.is_valid,
        )

    def rejuvenate(
        self, key: PRNGKey, collection: ParticleCollection[R], request
    ) -> ParticleCollection[R]:
        from genjax_tpu.inference.mcmc import mh

        keys = self._grid_keys(key)

        def _move(key, particle):
            new_tr, _ = mh(key, particle, request)
            return new_tr

        particles = collection.get_particles()
        axes = self._grid_axes(particles)
        new_particles = jax.vmap(
            jax.vmap(_move, in_axes=(0, axes), out_axes=axes),
            in_axes=(0, axes),
            out_axes=axes,
        )(keys, particles)
        return ParticleCollection(
            self._constrain(new_particles),
            collection.get_log_weights(),
            collection.is_valid,
        )
