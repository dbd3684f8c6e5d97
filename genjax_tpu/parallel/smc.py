"""Sharded SMC: the particle axis spans the device mesh.

Design (new relative to the single-device reference; see SURVEY.md §2.2):

* Particle state is a dense pytree whose leading axis is sharded over the
  mesh (`NamedSharding` over ICI).
* Weight reductions (LML, ESS, normalization) run inside `shard_map` as
  per-shard partial reductions + `psum` — one scalar collective each.
* Systematic resampling: log-weights are tiny relative to particle state,
  so shards `all_gather` the weight vector (K * 4 bytes over ICI) and
  compute their own slots' ancestors locally. The row exchange rides two
  neighbor `ppermute`s (`sharded_systematic_exchange`): systematic
  ancestors are monotone, so each output shard's sources form a
  contiguous window that stays within adjacent shards at healthy ESS; a
  psum-agreed fallback all-gathers rows only when far hops are actually
  needed. On a single shard the exchange reduces to the streaming
  expansion of `ops/expand.py` (no collectives, no gathers).
  `tests/parallel/test_hlo_collectives.py` pins all of this in compiled
  HLO.
"""

from functools import partial
from typing import Generic, TypeVar

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from genjax_tpu.core.choice_map import ChoiceMap
from genjax_tpu.core.pytree import Pytree
from genjax_tpu.core.typing import FloatArray, IntArray, PRNGKey
from genjax_tpu.inference.smc import ParticleCollection, systematic_cum_counts
from genjax_tpu.inference.sp import Target
from genjax_tpu.parallel.mesh import constrain_leading_axis

R = TypeVar("R")


def sharded_lml(log_weights: FloatArray, mesh: Mesh, axis: str = "particles"):
    """Log marginal likelihood estimate with a psum-based stable
    logsumexp: per-shard max + psum of shifted sums over ICI."""

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=P(axis),
        out_specs=P(),
    )
    def _lml(lw):
        local_max = jnp.max(lw)
        global_max = jax.lax.pmax(local_max, axis)
        local_sum = jnp.sum(jnp.exp(lw - global_max))
        total = jax.lax.psum(local_sum, axis)
        n = jax.lax.psum(jnp.asarray(lw.shape[0], jnp.float32), axis)
        return global_max + jnp.log(total) - jnp.log(n)

    return _lml(log_weights)


def sharded_ess(log_weights: FloatArray, mesh: Mesh, axis: str = "particles"):
    """Effective sample size over a sharded weight vector."""

    @partial(shard_map, mesh=mesh, in_specs=P(axis), out_specs=P())
    def _ess(lw):
        local_max = jnp.max(lw)
        m = jax.lax.pmax(local_max, axis)
        s1 = jax.lax.psum(jnp.sum(jnp.exp(lw - m)), axis)
        s2 = jax.lax.psum(jnp.sum(jnp.exp(2.0 * (lw - m))), axis)
        return s1 * s1 / s2

    return _ess(log_weights)


def sharded_systematic_ancestors(
    key: PRNGKey, log_weights: FloatArray, mesh: Mesh, axis: str = "particles"
) -> IntArray:
    """Distributed systematic resampling: each shard computes the global
    ancestor indices for its own output slots.

    Weights are all-gathered (K floats over ICI — negligible next to the
    particle state); the stride offset is shared (same key on all shards).
    Returns a sharded vector of global ancestor indices.
    """

    @partial(shard_map, mesh=mesh, in_specs=(P(), P(axis)), out_specs=P(axis))
    def _anc(key, lw_local):
        lw = jax.lax.all_gather(lw_local, axis, tiled=True)
        n = lw.shape[0]
        shard = jax.lax.axis_index(axis)
        per_shard = lw_local.shape[0]
        lo = shard * per_shard
        # Search-free closed form (see inference.smc.systematic_resample):
        # particle i's output block is [N_{i-1}, N_i). Each shard scatters
        # block starts that land in its slot range [lo, lo+per_shard)
        # (blocks straddling `lo` collapse onto local slot 0 via max) and
        # fills forward with a cumulative max.
        n_cum = systematic_cum_counts(key, lw, n)
        starts = jnp.concatenate([jnp.zeros((1,), jnp.int32), n_cum[:-1]])
        occupied = n_cum > starts
        local_starts = jnp.maximum(starts - lo, 0)
        in_range = occupied & (starts < lo + per_shard)
        scatter_idx = jnp.where(in_range, local_starts, per_shard)
        anc0 = (
            jnp.zeros((per_shard,), jnp.int32)
            .at[scatter_idx]
            .max(jnp.arange(n, dtype=jnp.int32), mode="drop")
        )
        # `lax.cummax`, not `associative_scan` (which unrolls into
        # ~log2(n) slice/concat kernels — see inference/smc.py).
        return jax.lax.cummax(anc0)

    return _anc(key, log_weights)


def sharded_systematic_exchange(
    key: PRNGKey,
    log_weights: FloatArray,
    packed_rows,
    mesh: Mesh,
    axis: str = "particles",
):
    """Distributed systematic resampling of a packed (K, F) row matrix.

    Only the K-float weight vector is all-gathered. The row exchange
    itself rides two neighbor `ppermute`s: systematic ancestors are
    monotone, so each output shard's sources live in a contiguous global
    window, and at healthy ESS that window stays within the two adjacent
    shards. When any shard needs rows from further away (detected with a
    psum so every shard agrees — collectives must execute uniformly), the
    program falls back to a full row all-gather for that call only.
    """
    n_shards = mesh.shape[axis]

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis)),
        out_specs=P(axis),
    )
    def _exchange(key, lw_local, rows_local):
        lw = jax.lax.all_gather(lw_local, axis, tiled=True)
        n = lw.shape[0]
        per = rows_local.shape[0]
        shard = jax.lax.axis_index(axis)
        lo = shard * per

        # Global cumulative block counts (replicated computation).
        cum = systematic_cum_counts(key, lw, n)
        starts = jnp.concatenate([jnp.zeros((1,), jnp.int32), cum[:-1]])
        occupied = cum > starts
        # My output slots' global ancestors (scatter block starts landing
        # in my slot range, fill forward).
        local_starts = jnp.maximum(starts - lo, 0)
        in_range = occupied & (starts < lo + per)
        scatter_idx = jnp.where(in_range, local_starts, per)
        anc0 = (
            jnp.zeros((per,), jnp.int32)
            .at[scatter_idx]
            .max(jnp.arange(n, dtype=jnp.int32), mode="drop")
        )
        anc_mine = jax.lax.cummax(anc0)

        hops = anc_mine // per - shard
        n_far = jax.lax.psum(jnp.sum(jnp.abs(hops) > 1), axis)

        def near(rows_local):
            fwd = [(i, (i + 1) % n_shards) for i in range(n_shards)]
            bwd = [(i, (i - 1) % n_shards) for i in range(n_shards)]
            from_left = jax.lax.ppermute(rows_local, axis, fwd)
            from_right = jax.lax.ppermute(rows_local, axis, bwd)
            window = jnp.concatenate([from_left, rows_local, from_right], 0)
            li = jnp.clip(anc_mine - (lo - per), 0, 3 * per - 1)
            return jnp.take(window, li, axis=0)

        def far(rows_local):
            everything = jax.lax.all_gather(rows_local, axis, tiled=True)
            return jnp.take(everything, anc_mine, axis=0)

        return jax.lax.cond(n_far > 0, far, near, rows_local)

    return _exchange(key, log_weights, packed_rows)


@Pytree.dataclass
class ShardedSMC(Generic[R], Pytree):
    """SMC driver whose particle axis is sharded over a device mesh.

    Composes with the single-device `SMCDriver` semantics: `init`,
    `extend`, `maybe_resample`, `rejuvenate`, with the particle axis laid
    out over ICI and reductions as collectives. Use under `jax.jit` —
    XLA's SPMD partitioner inserts the remaining data movement (e.g. the
    cross-shard particle gather in resampling).
    """

    n_particles: int = Pytree.static()
    mesh: Mesh = Pytree.static()
    axis: str = Pytree.static(default="particles")
    resampling: str = Pytree.static(default="systematic")
    ess_threshold: float = Pytree.static(default=0.5)

    def _constrain(self, tree):
        return constrain_leading_axis(
            tree, self.mesh, self.axis, n_rows=self.n_particles
        )

    def init(self, key: PRNGKey, target: Target[R]) -> ParticleCollection[R]:
        sub_keys = jax.random.split(key, self.n_particles)
        sub_keys = jax.lax.with_sharding_constraint(
            sub_keys, NamedSharding(self.mesh, P(self.axis))
        )
        trs, ws = jax.vmap(target.importance, in_axes=(0, None))(
            sub_keys, ChoiceMap.empty()
        )
        # Observed data is identical across particles: store it once
        # (the broadcast columns DCE away inside the same jit).
        from genjax_tpu.inference.smc import share_constrained_values

        trs = share_constrained_values(trs, target.constraint, self.n_particles)
        return ParticleCollection(
            self._constrain(trs), self._constrain(ws), jnp.array(True)
        )

    def lml(self, collection: ParticleCollection[R]) -> FloatArray:
        return sharded_lml(collection.get_log_weights(), self.mesh, self.axis)

    def ess(self, collection: ParticleCollection[R]) -> FloatArray:
        return sharded_ess(collection.get_log_weights(), self.mesh, self.axis)

    def extend(
        self,
        key: PRNGKey,
        collection: ParticleCollection[R],
        constraint: ChoiceMap,
        argdiffs: tuple | None = None,
    ) -> ParticleCollection[R]:
        from genjax_tpu.core.diff import Diff

        sub_keys = jax.random.split(key, self.n_particles)
        sel = constraint.get_selection()

        def _extend(key, particle):
            ad = (
                Diff.no_change(particle.get_args()) if argdiffs is None else argdiffs
            )
            discarded = particle.project(key, sel)
            new_tr, w, _, _ = particle.get_gen_fn().update(key, particle, constraint, ad)
            return new_tr, w + discarded

        from genjax_tpu.inference.mcmc import _chain_axes

        particles = collection.get_particles()
        axes = _chain_axes(particles, self.n_particles)
        new_particles, ws = jax.vmap(
            _extend, in_axes=(0, axes), out_axes=(axes, 0)
        )(sub_keys, particles)
        from genjax_tpu.inference.smc import share_constrained_values

        new_particles = share_constrained_values(
            new_particles, constraint, self.n_particles
        )
        return ParticleCollection(
            self._constrain(new_particles),
            self._constrain(collection.get_log_weights() + ws),
            collection.is_valid,
        )

    def resample(
        self, key: PRNGKey, collection: ParticleCollection[R]
    ) -> ParticleCollection[R]:
        if self.mesh.shape[self.axis] == 1:
            # Single shard on the particle axis: streaming expansion —
            # skips the ancestor scatter AND the per-index row gather
            # (ops/expand.py).
            from genjax_tpu.ops.expand import expand_rows

            cum = systematic_cum_counts(
                key, collection.get_log_weights(), self.n_particles
            )
            new_particles = expand_rows(
                collection.get_particles(), cum, n_rows=self.n_particles
            )
        else:
            from genjax_tpu.core.gather import map_packed_rows

            # Hop-bounded distributed exchange: only the weight vector is
            # all-gathered; rows ride neighbor ppermutes (with a gated
            # fallback) — verified by tests/parallel/test_hlo_collectives.
            new_particles = map_packed_rows(
                collection.get_particles(),
                lambda packed: sharded_systematic_exchange(
                    key,
                    collection.get_log_weights(),
                    packed,
                    self.mesh,
                    self.axis,
                ),
                self.n_particles,
            )
        avg_lw = self.lml(collection)
        n = self.n_particles
        return ParticleCollection(
            self._constrain(new_particles),
            self._constrain(jnp.full((n,), avg_lw)),
            collection.is_valid,
        )

    def maybe_resample(
        self, key: PRNGKey, collection: ParticleCollection[R]
    ) -> ParticleCollection[R]:
        do = self.ess(collection) < self.ess_threshold * self.n_particles
        resampled = self.resample(key, collection)
        # Identity-aware select: leaves resampling passed through (shared
        # model args under the `share_chain_args` layout) skip the where.
        from genjax_tpu.core.staging import where_tree

        return where_tree(do, resampled, collection)

    def rejuvenate(
        self, key: PRNGKey, collection: ParticleCollection[R], request
    ) -> ParticleCollection[R]:
        from genjax_tpu.inference.mcmc import mh

        sub_keys = jax.random.split(key, self.n_particles)
        sub_keys = jax.lax.with_sharding_constraint(
            sub_keys, NamedSharding(self.mesh, P(self.axis))
        )

        def _move(key, particle):
            new_tr, _ = mh(key, particle, request)
            return new_tr

        from genjax_tpu.inference.mcmc import _chain_axes

        particles = collection.get_particles()
        axes = _chain_axes(particles, self.n_particles)
        new_particles = jax.vmap(_move, in_axes=(0, axes), out_axes=axes)(
            sub_keys, particles
        )
        return ParticleCollection(
            self._constrain(new_particles),
            collection.get_log_weights(),
            collection.is_valid,
        )
