"""Sequential Monte Carlo: particle collections, SIR (`Importance` /
`ImportanceK`), target changes, and — beyond the reference — first-class
resampling (multinomial / systematic / stratified / residual), effective
sample size, and a step-wise SMC driver with rejuvenation.

Capability parity with reference `_src/inference/smc.py:77-465`
(`ParticleCollection`, `SMCAlgorithm` with `run_smc`/`run_csmc`,
`Importance`, `ImportanceK`, `ChangeTarget`). The reference ships *no*
resampling or SMC loop driver (SURVEY.md §2 C26) — tests do manual MH
loops — so `resample`, `ess`, and `SMCDriver` here are new capability.

Accelerator notes
-----------------
* A `ParticleCollection` is a dense pytree with a leading particle axis:
  exactly the layout that `vmap` produces and that `shard_map` shards
  over the device mesh (see `genjax_tpu.parallel` for the sharded
  version).
* Resampling is search-free: systematic ancestors come from a cumulative
  sum, a scatter and `lax.cummax`; the sorted-query resamplers merge
  against the CDF with one sort (see each resampler's docstring).
"""

from typing import Callable, Generic, TypeVar

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
from jax.scipy.special import logsumexp

from genjax_tpu.core.choice_map import ChoiceMap
from genjax_tpu.core.concepts import Score, Weight
from genjax_tpu.core.gfi import Trace
from genjax_tpu.core.pytree import Pytree
from genjax_tpu.core.typing import BoolArray, FloatArray, IntArray, PRNGKey
from genjax_tpu.inference.sp import Algorithm, SampleDistribution, Target

R = TypeVar("R")


def _stack_retained(arr1, arr2):
    """Concatenate a retained particle onto a vmapped batch along axis 0."""
    arr1 = jnp.asarray(arr1)
    arr2 = jnp.asarray(arr2)
    if arr1.ndim <= 1:
        arr1 = arr1.reshape(-1, 1)
    if arr2.ndim <= 1:
        arr2 = arr2.reshape(-1, 1)
    return jnp.squeeze(jnp.concatenate([arr1, arr2], axis=0))


######################
# Particle utilities #
######################


def ess(log_weights: FloatArray) -> FloatArray:
    """Effective sample size of a log-weight vector:
    `(sum w)^2 / sum w^2` computed stably in log space.

    >>> import jax.numpy as jnp
    >>> from genjax_tpu.inference.smc import ess
    >>> print(round(float(ess(jnp.zeros(8))), 1))  # equal weights
    8.0
    >>> degenerate = jnp.array([0.0, -1e9, -1e9, -1e9])
    >>> print(round(float(ess(degenerate)), 1))
    1.0
    """
    lw = log_weights - logsumexp(log_weights)
    return jnp.exp(-logsumexp(2.0 * lw))


def multinomial_resample(key: PRNGKey, log_weights: FloatArray, n: int) -> IntArray:
    """Multinomial ancestor sampling via sorted uniform spacings.

    `jax.random.categorical` over K logits with n draws materializes an
    (n, K) Gumbel matrix — quadratic and catastrophic at K=n=1M. The
    exponential-spacings construction produces n *sorted* uniforms in
    O(n), after which ancestors come from one merge against the CDF
    (ancestor multiset is exactly multinomial; order is exchangeable)."""
    k_space, k_perm = jax.random.split(key)
    w = jax.nn.softmax(log_weights)
    cdf = jnp.cumsum(w)
    e = jax.random.exponential(k_space, (n + 1,), dtype=w.dtype)
    cums = jnp.cumsum(e)
    us = cums[:n] / cums[n]
    sorted_anc = _sorted_queries_ancestors(cdf, us)
    # A uniform permutation of the order statistics restores the iid
    # sequence in distribution.
    return jax.random.permutation(k_perm, sorted_anc)


def _blocks_to_ancestors(block_ends: IntArray, n: int) -> IntArray:
    """Ancestor vector from cumulative block ends: particle i owns output
    slots [block_ends[i-1], block_ends[i]). Dense scatter + cumulative max
    — no search (see `systematic_resample`).

    The fill-forward is `lax.cummax` (one fused XLA scan op), NOT
    `lax.associative_scan` — the latter unrolls into ~log2(n) slice/concat
    kernel levels, which dominates the per-step cost of small-K particle
    filters."""
    k = block_ends.shape[0]
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32), block_ends[:-1]])
    occupied = block_ends > starts
    scatter_idx = jnp.where(occupied, starts, n)
    anc0 = (
        jnp.zeros((n,), jnp.int32)
        .at[scatter_idx]
        .max(jnp.arange(k, dtype=jnp.int32), mode="drop")
    )
    return jax.lax.cummax(anc0)


def _sorted_queries_ancestors(cdf: FloatArray, us: FloatArray) -> IntArray:
    """`searchsorted(cdf, us, side='right')` for SORTED queries via one
    merge sort instead of per-query binary-search gathers. The j-th
    query's merged position p
    satisfies p = #(cdf <= u_j) + j."""
    k = cdf.shape[0]
    n = us.shape[0]
    merged = jnp.concatenate([cdf, us])
    order = jnp.argsort(merged, stable=True)  # ties: cdf entries first
    inv = (
        jnp.zeros((k + n,), jnp.int32)
        .at[order]
        .set(jnp.arange(k + n, dtype=jnp.int32))
    )
    positions = inv[k:]
    return jnp.clip(positions - jnp.arange(n, dtype=jnp.int32), 0, k - 1)


def systematic_cum_counts(
    key: PRNGKey, log_weights: FloatArray, n: int
) -> IntArray:
    """The cumulative block counts `N_i` of systematic resampling (output
    slots [N_{i-1}, N_i) copy particle i), WITHOUT materializing the
    ancestor vector. Feeds `ops.expand.expand_rows`, which realizes the
    row copy as streaming passes and never pays the ancestor scatter.

    The counts are non-decreasing and end at `n`, so every output slot is
    filled. A float32 prefix sum does not guarantee either: XLA computes
    it blockwise, so `cdf` can dip by an ulp where a weight is tiny, and
    at large n its total can fall short of 1 by enough to drop the last
    slot. Without the `cummax` and the pinned last count, `expand_rows`
    and the ancestor gather would resample such weights differently (and
    the expansion would leave slots holding dead rows)."""
    w = jax.nn.softmax(log_weights)
    cdf = jnp.cumsum(w)
    u0 = jax.random.uniform(key, (), dtype=w.dtype)
    cum = jnp.clip(jnp.floor(n * cdf - u0).astype(jnp.int32) + 1, 0, n)
    return jax.lax.cummax(cum).at[-1].set(n)


def systematic_resample(key: PRNGKey, log_weights: FloatArray, n: int) -> IntArray:
    """Systematic (low-variance) resampling, search-free.

    Because the systematic query points `u_s = (u0 + s)/n` are evenly
    spaced, each particle's block of output slots has the closed form
    `[N_{i-1}, N_i)` with `N_i = floor(n * cdf_i - u0) + 1`. The ancestor
    vector is materialized by scattering each particle index at its block
    start and filling forward with a cumulative max — three dense O(K)
    passes (cumsum, scatter, associative scan), no binary search.

    (It replaces `searchsorted`, whose per-probe random gathers defeat
    the memory system at large K; it is exact up to the same f32
    boundary rounding.)
    """
    # N_i = #output slots with u_s <= cdf_i  (side='right' semantics)
    return _blocks_to_ancestors(systematic_cum_counts(key, log_weights, n), n)


def stratified_resample(key: PRNGKey, log_weights: FloatArray, n: int) -> IntArray:
    """Stratified resampling: one uniform per stratum. The queries are
    sorted by construction, so ancestors come from one merge sort instead
    of per-query binary search."""
    w = jax.nn.softmax(log_weights)
    cdf = jnp.cumsum(w)
    us = (jax.random.uniform(key, (n,), dtype=w.dtype) + jnp.arange(n, dtype=w.dtype)) / n
    return _sorted_queries_ancestors(cdf, us)


def residual_resample(key: PRNGKey, log_weights: FloatArray, n: int) -> IntArray:
    """Residual resampling: deterministic floor counts + multinomial
    remainder, realized densely (no dynamic shapes; the deterministic
    block expansion uses the scatter+cummax form)."""
    w = jax.nn.softmax(log_weights)
    scaled = n * w
    floors = jnp.floor(scaled).astype(jnp.int32)
    residual = scaled - floors
    n_det = jnp.sum(floors)
    det_anc = _blocks_to_ancestors(jnp.cumsum(floors), n)
    # Stochastic remainder: multinomial over the residual weights (sorted
    # spacings + merge, see multinomial_resample); slots < n_det use the
    # deterministic expansion.
    k_space, k_perm = jax.random.split(key)
    rem_w = residual / jnp.maximum(jnp.sum(residual), 1e-38)
    rem_cdf = jnp.cumsum(rem_w)
    e = jax.random.exponential(k_space, (n + 1,), dtype=w.dtype)
    cums = jnp.cumsum(e)
    us = cums[:n] / cums[n]
    rem_anc = jax.random.permutation(
        k_perm, _sorted_queries_ancestors(rem_cdf, us)
    )
    positions = jnp.arange(n)
    anc = jnp.where(positions < n_det, det_anc, rem_anc)
    return jnp.clip(anc, 0, log_weights.shape[0] - 1)


RESAMPLERS: dict[str, Callable[[PRNGKey, FloatArray, int], IntArray]] = {
    "multinomial": multinomial_resample,
    "systematic": systematic_resample,
    "stratified": stratified_resample,
    "residual": residual_resample,
}


def share_constrained_values(
    traces, constraint: ChoiceMap, n_rows: int | tuple
):
    """Replace per-particle copies of constrained-site VALUES with ONE
    shared copy (the observed data itself).

    `vmap(generate)` broadcasts every constrained address's value — the
    observations — into a `(K, ...)` column of the particle batch, even
    though all K rows are identical. At 1M particles that column rides
    every resample exchange, accept-select, and checkpoint for nothing.
    This is the constrained-value analogue of `mcmc.share_chain_args`
    (ARCHITECTURE.md 4b): the shared leaf has no leading particle axis,
    and every driver already maps such leaves with `in_axes=None` /
    passes them through `expand_rows`/`take_rows`/`where_tree`.

    Only plain (non-Mask) constraints reaching `DistributionTrace`
    leaves through `StaticTrace` nodes are shared; anything else — Mask
    gating, combinator subtraces, dynamic addresses — is left in its
    (correct, merely unoptimized) broadcast form. A constraint leaf
    whose OWN leading dimension equals a batch dimension is ambiguous
    under the leading-dim convention and is likewise left batched.

    `n_rows` is the batch shape: an int `K` for a flat particle batch,
    or a tuple (e.g. `(C, K)` for `GridSMC`'s chains x particles grid).
    """
    import dataclasses

    from genjax_tpu.core.mask import Mask
    from genjax_tpu.distributions.distribution import DistributionTrace
    from genjax_tpu.lang.static import StaticTrace

    batch_shape = (n_rows,) if isinstance(n_rows, int) else tuple(n_rows)

    def rewrite(tr, chm):
        if isinstance(tr, StaticTrace):
            subs = dict(tr.subtraces)
            changed = False
            for key in list(subs.keys()):
                child = chm.get_inner_map(key)
                new_sub = rewrite(subs[key], child)
                if new_sub is not subs[key]:
                    subs[key] = new_sub
                    changed = True
            return dataclasses.replace(tr, subtraces=subs) if changed else tr
        if isinstance(tr, DistributionTrace):
            v = chm.get_value()
            if v is None or isinstance(v, Mask):
                return tr
            shared = jtu.tree_map(jnp.asarray, v)
            stored = tr.value
            s_leaves, s_def = jtu.tree_flatten(shared)
            t_leaves, t_def = jtu.tree_flatten(stored)
            if s_def != t_def:
                return tr
            for s, t in zip(s_leaves, t_leaves):
                if jnp.shape(t) != batch_shape + jnp.shape(s):
                    return tr  # not the broadcast form (e.g. per-index)
                if jnp.ndim(s) >= 1 and jnp.shape(s)[0] in batch_shape:
                    return tr  # ambiguous leading dim: keep batched
            return dataclasses.replace(tr, value=shared)
        return tr

    return rewrite(traces, constraint)


@Pytree.dataclass
class ParticleCollection(Generic[R], Pytree):
    """A weighted collection of particles (traces with a leading particle
    axis) plus log importance weights."""

    particles: Trace[R]
    log_weights: FloatArray
    is_valid: BoolArray

    def get_particles(self) -> Trace[R]:
        return self.particles

    def get_particle(self, idx) -> Trace[R]:
        n = self.log_weights.shape[0]
        # Shared leaves (the `share_chain_args` layout: no leading
        # particle axis) belong to every particle as-is.
        return jtu.tree_map(
            lambda v: v[idx]
            if jnp.ndim(v) >= 1 and jnp.shape(v)[0] == n
            else v,
            self.particles,
        )

    def get_log_weights(self) -> FloatArray:
        return self.log_weights

    def get_log_marginal_likelihood_estimate(self) -> FloatArray:
        return logsumexp(self.log_weights) - jnp.log(self.log_weights.shape[0])

    def get_ess(self) -> FloatArray:
        return ess(self.log_weights)

    def __getitem__(self, idx):
        # Via get_particle: shared arg leaves (no leading particle axis)
        # belong to every particle and must not be data-indexed.
        return (self.get_particle(idx), self.log_weights[idx])

    def sample_particle(self, key: PRNGKey) -> Trace[R]:
        logits = self.log_weights - logsumexp(self.log_weights)
        idx = jax.random.categorical(key, logits)
        return self.get_particle(idx)

    def resample(
        self, key: PRNGKey, method: str = "systematic"
    ) -> "ParticleCollection[R]":
        """Resample the collection to equal weights, preserving the mean
        weight (so LML accumulation telescopes correctly)."""
        n = self.log_weights.shape[0]
        if method == "systematic":
            # Streaming expansion (ops/expand.py): no ancestor scatter, no
            # per-index row gather.
            from genjax_tpu.ops.expand import expand_rows

            cum = systematic_cum_counts(key, self.log_weights, n)
            new_particles = expand_rows(self.particles, cum, n_rows=n)
        else:
            from genjax_tpu.core.gather import take_rows

            anc = RESAMPLERS[method](key, self.log_weights, n)
            # One packed row-gather instead of a per-leaf scalar gather
            # (see core/gather.py).
            new_particles = take_rows(self.particles, anc, n_rows=n)
        # After resampling, each particle carries the average weight.
        avg_lw = logsumexp(self.log_weights) - jnp.log(n)
        return ParticleCollection(
            new_particles,
            jnp.full((n,), avg_lw),
            self.is_valid,
        )


#############
# Algorithm #
#############


class SMCAlgorithm(Generic[R], Algorithm[R]):
    """Abstract base for SMC algorithms (proper weighting over targets)."""

    def get_num_particles(self) -> int:
        raise NotImplementedError

    def get_final_target(self) -> Target[R]:
        raise NotImplementedError

    def run_smc(self, key: PRNGKey) -> ParticleCollection[R]:
        raise NotImplementedError

    def run_csmc(self, key: PRNGKey, retained: ChoiceMap) -> ParticleCollection[R]:
        raise NotImplementedError

    def log_marginal_likelihood_estimate(
        self, key: PRNGKey, target: Target[R] | None = None
    ):
        algorithm = ChangeTarget(self, target) if target else self
        key, sub_key = jax.random.split(key)
        return algorithm.run_smc(sub_key).get_log_marginal_likelihood_estimate()

    def random_weighted(self, key: PRNGKey, *args) -> tuple[Score, ChoiceMap]:
        target: Target[R] = args[0]
        algorithm = ChangeTarget(self, target)
        key, sub_key = jax.random.split(key)
        collection = algorithm.run_smc(key)
        particle = collection.sample_particle(sub_key)
        log_density_estimate = (
            particle.get_score() - collection.get_log_marginal_likelihood_estimate()
        )
        chm = target.filter_to_unconstrained(particle.get_choices())
        return log_density_estimate, chm

    def estimate_logpdf(self, key: PRNGKey, v: ChoiceMap, *args) -> Score:
        """Unbiased posterior-density estimate at `v` via conditional SMC:
        `log p-hat(v) = score(retained) - LML-hat`, using the *retained*
        particle (run_csmc places it at index K-1).

        (The reference samples a fresh particle here, `smc.py:186-200`,
        which is biased whenever other particles carry different scores;
        the retained-particle estimator satisfies `E[p-hat] = p(v | c)`
        by the standard CSMC harmonic identity.)
        """
        target: Target[R] = args[0]
        algorithm = ChangeTarget(self, target)
        key, sub_key = jax.random.split(key)
        collection = algorithm.run_csmc(key, v)
        particle = collection.get_particle(self.get_num_particles() - 1)
        return (
            particle.get_score() - collection.get_log_marginal_likelihood_estimate()
        )

    def estimate_normalizing_constant(
        self, key: PRNGKey, target: Target[R]
    ) -> FloatArray:
        algorithm = ChangeTarget(self, target)
        key, sub_key = jax.random.split(key)
        return algorithm.run_smc(sub_key).get_log_marginal_likelihood_estimate()

    def estimate_reciprocal_normalizing_constant(
        self, key: PRNGKey, target: Target[R], latent_choices: ChoiceMap, w: Weight
    ) -> FloatArray:
        algorithm = ChangeTarget(self, target)
        return algorithm.run_csmc_for_normalizing_constant(key, latent_choices, w)


@Pytree.dataclass
class Importance(Generic[R], SMCAlgorithm[R]):
    """One-particle importance sampling from `target`, optionally through a
    custom proposal `q` (a `SampleDistribution` over a subset of the
    unconstrained addresses)."""

    target: Target[R]
    q: SampleDistribution | None = Pytree.field(default=None)

    def get_num_particles(self):
        return 1

    def get_final_target(self):
        return self.target

    def run_smc(self, key: PRNGKey):
        k_prop, k_gen = jax.random.split(key)
        if self.q is not None:
            log_weight, choice = self.q.random_weighted(k_prop, self.target)
            tr, target_score = self.target.importance(k_gen, choice)
        else:
            log_weight = 0.0
            tr, target_score = self.target.importance(k_gen, ChoiceMap.empty())
        return ParticleCollection(
            jtu.tree_map(lambda v: jnp.expand_dims(v, axis=0), tr),
            jnp.array([target_score - log_weight]),
            jnp.array(True),
        )

    def run_csmc(self, key: PRNGKey, retained: ChoiceMap):
        k_prop, k_gen = jax.random.split(key)
        if self.q:
            q_score = self.q.estimate_logpdf(k_prop, retained, self.target)
        else:
            q_score = 0.0
        target_trace, target_score = self.target.importance(k_gen, retained)
        return ParticleCollection(
            jtu.tree_map(lambda v: jnp.expand_dims(v, axis=0), target_trace),
            jnp.array([target_score - q_score]),
            jnp.array(True),
        )


@Pytree.dataclass
class ImportanceK(Generic[R], SMCAlgorithm[R]):
    """K-particle sampling importance resampling (SIR) from `target`.

    >>> import jax, jax.numpy as jnp
    >>> import genjax_tpu as gx
    >>> from genjax_tpu.inference import Target
    >>> from genjax_tpu.inference.smc import ImportanceK
    >>> @gx.gen
    ... def model():
    ...     x = gx.normal(0.0, 1.0) @ "x"
    ...     _ = gx.normal(x, 1.0) @ "y"
    >>> target = Target(model, (), gx.ChoiceMap.kw(y=1.0))
    >>> alg = ImportanceK(target, k_particles=1000)
    >>> lml = alg.log_marginal_likelihood_estimate(jax.random.key(0), target)
    >>> exact = -0.25 - 0.5 * jnp.log(2 * jnp.pi * 2.0)  # log N(1; 0, sqrt 2)
    >>> bool(jnp.abs(lml - exact) < 0.1)
    True
    >>> _, latents = alg.random_weighted(jax.random.key(1), target)
    >>> "x" in latents
    True
    """

    target: Target[R]
    q: SampleDistribution | None = Pytree.field(default=None)
    k_particles: int = Pytree.static(default=2)

    def get_num_particles(self):
        return self.k_particles

    def get_final_target(self):
        return self.target

    def run_smc(self, key: PRNGKey):
        k_prop, k_gen = jax.random.split(key)
        prop_keys = jax.random.split(k_prop, self.k_particles)
        gen_keys = jax.random.split(k_gen, self.k_particles)
        if self.q is not None:
            log_weights, choices = jax.vmap(self.q.random_weighted, in_axes=(0, None))(
                prop_keys, self.target
            )
            trs, target_scores = jax.vmap(self.target.importance)(gen_keys, choices)
        else:
            log_weights = 0.0
            trs, target_scores = jax.vmap(self.target.importance, in_axes=(0, None))(
                gen_keys, ChoiceMap.empty()
            )
        # One shared copy of the target's arguments across particles
        # (vmap broadcasts them into every trace; for data-conditioned
        # targets that copy is most of the collection) — every driver,
        # resampler and reweighting path understands this layout.
        from genjax_tpu.inference.mcmc import share_chain_args

        trs = share_chain_args(trs, self.target.args)
        # ... and of the observed data (see share_constrained_values).
        trs = share_constrained_values(
            trs, self.target.constraint, self.k_particles
        )
        return ParticleCollection(
            trs, target_scores - log_weights, jnp.array(True)
        )

    def run_csmc(self, key: PRNGKey, retained: ChoiceMap):
        k_prop, k_ret, k_gen = jax.random.split(key, 3)
        prop_keys = jax.random.split(k_prop, self.k_particles - 1)
        if self.q:
            log_scores, choices = jax.vmap(self.q.random_weighted, in_axes=(0, None))(
                prop_keys, self.target
            )
            retained_score = self.q.estimate_logpdf(k_ret, retained, self.target)
            stacked_choices = jtu.tree_map(_stack_retained, choices, retained)
            stacked_scores = jtu.tree_map(_stack_retained, log_scores, retained_score)
            gen_keys = jax.random.split(k_gen, self.k_particles)
            target_traces, target_scores = jax.vmap(self.target.importance)(
                gen_keys, stacked_choices
            )
        else:
            other_traces, other_scores = jax.vmap(
                self.target.importance, in_axes=(0, None)
            )(prop_keys, ChoiceMap.empty())
            retained_trace, retained_score = self.target.importance(k_ret, retained)
            target_scores = _stack_retained(other_scores, retained_score)
            stacked_scores = 0.0
            target_traces = jtu.tree_map(_stack_retained, other_traces, retained_trace)
        return ParticleCollection(
            target_traces, target_scores - stacked_scores, jnp.array(True)
        )


@Pytree.dataclass
class ChangeTarget(Generic[R], SMCAlgorithm[R]):
    """Reweight an existing collection to a new target (shared latents)."""

    prev: SMCAlgorithm[R]
    target: Target[R]

    def get_num_particles(self):
        return self.prev.get_num_particles()

    def get_final_target(self):
        return self.target

    def _reweight_collection(
        self, key: PRNGKey, collection: ParticleCollection[R]
    ) -> ParticleCollection[R]:
        def _reweight(key, particle, weight):
            latents = self.prev.get_final_target().filter_to_unconstrained(
                particle.get_choices()
            )
            new_trace, new_weight = self.target.importance(key, latents)
            this_weight = new_weight - particle.get_score() + weight
            return (new_trace, this_weight)

        from genjax_tpu.inference.mcmc import _chain_axes

        n = self.get_num_particles()
        particles = collection.get_particles()
        axes = _chain_axes(particles, n)
        sub_keys = jax.random.split(key, n)
        new_particles, new_weights = jax.vmap(
            _reweight, in_axes=(0, axes, 0), out_axes=(axes, 0)
        )(sub_keys, particles, collection.get_log_weights())
        return ParticleCollection(new_particles, new_weights, jnp.array(True))

    def run_smc(self, key: PRNGKey) -> ParticleCollection[R]:
        k_prev, k_rw = jax.random.split(key)
        collection = self.prev.run_smc(k_prev)
        return self._reweight_collection(k_rw, collection)

    def run_csmc(self, key: PRNGKey, retained: ChoiceMap) -> ParticleCollection[R]:
        k_prev, k_rw = jax.random.split(key)
        collection = self.prev.run_csmc(k_prev, retained)
        return self._reweight_collection(k_rw, collection)

    def run_csmc_for_normalizing_constant(
        self, key: PRNGKey, latent_choices: ChoiceMap, w: Weight
    ) -> Weight:
        """Low-variance reciprocal normalizing constant estimation for
        variational objectives (reference `smc.py:432-465`)."""
        k_prev, k_rw = jax.random.split(key)
        collection = self.prev.run_csmc(k_prev, latent_choices)

        def _reweight(key, particle, weight):
            latents = self.prev.get_final_target().filter_to_unconstrained(
                particle.get_choices()
            )
            new_trace, new_score = self.target.importance(key, latents)
            this_weight = new_score - particle.get_score() + weight
            return this_weight

        from genjax_tpu.inference.mcmc import _chain_axes

        n = self.get_num_particles()
        particles = collection.get_particles()
        axes = _chain_axes(particles, n)
        sub_keys = jax.random.split(k_rw, n)
        new_weights = jax.vmap(_reweight, in_axes=(0, axes, 0))(
            sub_keys, particles, collection.get_log_weights()
        )
        # Average the reweighted collection against the retained sample's
        # contribution `w`.
        total = logsumexp(new_weights) - jnp.log(self.get_num_particles())
        return w - total


##################################################
# Step-wise SMC driver with resampling (new)     #
##################################################


@Pytree.dataclass
class SMCDriver(Generic[R], Pytree):
    """A step-wise SMC loop: initialize from a target, then advance through
    a sequence of targets with resampling (adaptive by ESS threshold) and
    optional rejuvenation moves.

    This is new capability relative to the reference (which ships SIR/CSMC
    only); it composes the same proper-weighting ingredients.

    >>> import jax
    >>> import genjax_tpu as gx
    >>> from genjax_tpu.inference import Target
    >>> from genjax_tpu.inference.smc import SMCDriver
    >>> @gx.gen
    ... def model():
    ...     x = gx.normal(0.0, 1.0) @ "x"
    ...     _ = gx.normal(x, 1.0) @ "y"
    >>> driver = SMCDriver(n_particles=256)
    >>> coll = driver.init(jax.random.key(0), Target(model, (), gx.ChoiceMap.kw(y=1.0)))
    >>> coll = driver.maybe_resample(jax.random.key(1), coll)
    >>> coll = driver.rejuvenate(
    ...     jax.random.key(2), coll, gx.Regenerate(gx.Selection.at["x"])
    ... )
    >>> bool(coll.get_ess() > 0)
    True
    """

    n_particles: int = Pytree.static()
    resampling: str = Pytree.static(default="systematic")
    ess_threshold: float = Pytree.static(default=0.5)

    def init(self, key: PRNGKey, target: Target[R]) -> ParticleCollection[R]:
        """Initialize the collection by importance sampling the target."""
        sub_keys = jax.random.split(key, self.n_particles)
        trs, ws = jax.vmap(target.importance, in_axes=(0, None))(
            sub_keys, ChoiceMap.empty()
        )
        trs = share_constrained_values(trs, target.constraint, self.n_particles)
        return ParticleCollection(trs, ws, jnp.array(True))

    def maybe_resample(
        self, key: PRNGKey, collection: ParticleCollection[R]
    ) -> ParticleCollection[R]:
        """Resample if ESS drops below `ess_threshold * n_particles`.

        Realized with `lax.cond` (a real runtime branch, single-device):
        the resampling scatter + gather pair dominates a large-K SMC step,
        so skipping it when the ESS is healthy is the main adaptive win.
        (The sharded drivers keep dense selects — collectives inside a
        cond are fragile under SPMD partitioning.)"""
        do = collection.get_ess() < self.ess_threshold * self.n_particles
        return jax.lax.cond(
            do,
            lambda c: c.resample(key, self.resampling),
            lambda c: c,
            collection,
        )

    def extend(
        self,
        key: PRNGKey,
        collection: ParticleCollection[R],
        constraint: ChoiceMap,
        argdiffs: tuple | None = None,
    ) -> ParticleCollection[R]:
        """Advance each particle by constraining new observations via the
        `update` edit; weights accumulate the incremental importance
        weights."""
        from genjax_tpu.core.diff import Diff

        sub_keys = jax.random.split(key, self.n_particles)
        # The SMCP3 weight for *observing* previously-latent addresses is
        # the observation density p(obs | rest): `update` returns the
        # replace ratio p(new)/p(old), so the discarded choices' old score
        # (recovered via `project` on the constraint's selection) is added
        # back — the L kernel regenerates them from the internal proposal.
        sel = constraint.get_selection()

        def _extend(key, particle):
            ad = (
                Diff.no_change(particle.get_args()) if argdiffs is None else argdiffs
            )
            k_proj, k_upd = jax.random.split(key)
            discarded_score = particle.project(k_proj, sel)
            new_tr, w, _, _ = particle.get_gen_fn().update(
                k_upd, particle, constraint, ad
            )
            return new_tr, w + discarded_score

        from genjax_tpu.inference.mcmc import _chain_axes

        particles = collection.get_particles()
        axes = _chain_axes(particles, self.n_particles)
        new_particles, ws = jax.vmap(
            _extend, in_axes=(0, axes), out_axes=(axes, 0)
        )(sub_keys, particles)
        new_particles = share_constrained_values(
            new_particles, constraint, self.n_particles
        )
        return ParticleCollection(
            new_particles, collection.get_log_weights() + ws, collection.is_valid
        )

    def rejuvenate(
        self,
        key: PRNGKey,
        collection: ParticleCollection[R],
        request,
    ) -> ParticleCollection[R]:
        """Apply an MH-style edit request to every particle with
        accept/reject (weight-preserving rejuvenation)."""
        from genjax_tpu.core.diff import Diff

        from genjax_tpu.inference.mcmc import mh

        sub_keys = jax.random.split(key, self.n_particles)

        def _move(key, particle):
            new_tr, _accepted = mh(key, particle, request)
            return new_tr

        from genjax_tpu.inference.mcmc import _chain_axes

        particles = collection.get_particles()
        axes = _chain_axes(particles, self.n_particles)
        new_particles = jax.vmap(_move, in_axes=(0, axes), out_axes=axes)(
            sub_keys, particles
        )
        return ParticleCollection(
            new_particles, collection.get_log_weights(), collection.is_valid
        )
