"""Joint-distribution validation of inference kernels: simulation-based
calibration (SBC) and the Geweke "getting it right" test.

New capability relative to the reference: SURVEY.md §5 records that the
reference's only validity machinery is semantic (Mask flags, checkify
value checks); it ships no machinery for testing whether a *sampler* is
actually drawing from the posterior it claims. These two classic
procedures do exactly that, and both are pure GFI compositions:

- **SBC** (Talts et al. 2018). Draw `(theta, y) ~ p` with
  `model.simulate`; run the kernel under test on `p(theta | y)` starting
  AT the prior draw (a perfect posterior sample, so no burn-in is
  needed); record the rank of `g(theta_prior)` among the chain draws
  `g(theta_1..L)`. If the kernel targets the right posterior, ranks are
  uniform on `{0..L}` for EVERY summary `g` — any deviation (U-shaped,
  humped, skewed histograms) is a bias signature.
- **Geweke** (2004). Compare forward-joint samples `(theta, y) ~ p`
  against a "successive-conditional" chain that alternates the kernel
  under test (targeting `p(theta | y)`) with an exact data refresh
  `y ~ p(y | theta)` (a `Regenerate` on the observed addresses, MH-
  corrected so it stays valid even when observations feed other
  addresses). Both processes have the same stationary joint iff the
  kernel is correct; moment z-scores localize the failure.

Accelerator shape: replicates/chains are one vmapped batch in the shared-args
layout (`mcmc.share_chain_args`), the draw loop is a single `lax.scan`,
ranks accumulate incrementally (no draws materialized), and ties are
broken by iid-uniform lexicographic comparison so discrete summaries
rank correctly.

Scope note: SBC validates *invariance* — any kernel that leaves the
posterior invariant yields uniform ranks here, including the identity
kernel (its all-tied ranks come out Binomial(L, u0) with u0 ~ U(0,1),
which is marginally uniform under the consistent tie augmentation).
Mixing/ergodicity is a separate question; check it with
`diagnostics.effective_sample_size` / `split_rhat` on the same chains.
"""

from typing import Any, Callable, TypeVar

import jax
import jax.numpy as jnp
import jax.random as jrand
import jax.tree_util as jtu

from genjax_tpu.core.choice_map import Selection
from genjax_tpu.core.concepts import EditRequest
from genjax_tpu.core.diff import Diff
from genjax_tpu.core.gfi import GenerativeFunction, Trace
from genjax_tpu.core.mask import Mask
from genjax_tpu.core.pytree import Pytree
from genjax_tpu.core.requests import Regenerate
from genjax_tpu.core.typing import FloatArray, PRNGKey
from genjax_tpu.inference.diagnostics import effective_sample_size
from genjax_tpu.inference.mcmc import _chain_axes, mh, share_chain_args

R = TypeVar("R")

__all__ = ["GewekeResult", "SBCResult", "geweke", "sbc"]


def _as_kernel(kernel) -> Callable[[PRNGKey, Trace[Any]], Trace[Any]]:
    """Accept either a `(key, trace) -> trace` callable or an
    `EditRequest` (wrapped in one MH accept/reject step)."""
    if isinstance(kernel, EditRequest):
        request = kernel

        def step(key: PRNGKey, trace: Trace[Any]) -> Trace[Any]:
            new_trace, _ = mh(key, trace, request)
            return new_trace

        return step
    return kernel


def _flat_summaries(selection: Selection, with_squares: bool):
    """Default summary function: the selected choices' numeric leaves,
    raveled into one vector (optionally concatenated with their squares
    so second moments are checked too)."""

    def g(trace: Trace[Any]) -> FloatArray:
        chm = trace.get_choices().filter(selection)
        # Unwrap Mask nodes explicitly: a runtime-valued (Mask-deferred)
        # selection would otherwise leak stale masked-out leaf contents
        # into the summaries and silently corrupt ranks/moments.
        values = []
        for node in jtu.tree_leaves(
            chm, is_leaf=lambda x: isinstance(x, Mask)
        ):
            if isinstance(node, Mask):
                flag = node.primal_flag()
                if isinstance(flag, jax.core.Tracer) or jnp.ndim(flag) > 0:
                    raise ValueError(
                        "validation: the selection produced a "
                        "runtime-valued Mask; only statically resolvable "
                        "selections are supported here. Pass an explicit "
                        "`summaries` function."
                    )
                if not bool(flag):
                    continue
                values.extend(jtu.tree_leaves(node.value))
            else:
                values.append(node)
        leaves = [
            jnp.ravel(jnp.asarray(v, jnp.result_type(float)))
            for v in values
            if jnp.asarray(v).dtype != jnp.bool_
        ]
        if not leaves:
            raise ValueError(
                "validation: the selection matched no numeric choices; "
                "pass an explicit `summaries` function."
            )
        flat = jnp.concatenate(leaves)
        if with_squares:
            flat = jnp.concatenate([flat, jnp.square(flat)])
        return flat

    return g


def _thinned(kernel, thin: int):
    def sweep(key: PRNGKey, trace: Trace[Any]) -> Trace[Any]:
        def inner(tr, k):
            return kernel(k, tr), None

        trace, _ = jax.lax.scan(inner, trace, jrand.split(key, thin))
        return trace

    return sweep


@Pytree.dataclass
class SBCResult(Pytree):
    """SBC rank statistics: `ranks[r, s]` is the rank (in `{0..n_draws}`)
    of replicate `r`'s prior summary `s` among its chain draws. Under a
    correct kernel every column is uniform; `uniformity()` reduces that
    to per-summary chi-square statistics and p-values."""

    ranks: Any = Pytree.field()
    n_draws: int = Pytree.static()

    def histogram(self, n_bins: int | None = None):
        """Binned rank counts, shape `(n_summaries, n_bins)`."""
        n_bins = self._n_bins(n_bins)
        edges = self.ranks * n_bins // (self.n_draws + 1)  # (R, S)
        one_hot = jax.nn.one_hot(edges, n_bins, dtype=jnp.float32)
        return jnp.sum(one_hot, axis=0)  # (S, n_bins)

    def uniformity(self, n_bins: int | None = None):
        """Per-summary chi-square uniformity test of the rank histogram.
        Returns `(statistic, p_value)`, each shape `(n_summaries,)`; a
        tiny p-value means the kernel's posterior is miscalibrated for
        that summary."""
        n_bins = self._n_bins(n_bins)
        counts = self.histogram(n_bins)  # (S, n_bins)
        # Integer binning maps an unequal number of rank values into
        # each bin whenever (n_draws + 1) % n_bins != 0; the expected
        # count per bin must follow those actual widths, or a chi-square
        # against a flat expectation rejects exactly-uniform ranks.
        rank_values = jnp.arange(self.n_draws + 1)
        rank_bins = rank_values * n_bins // (self.n_draws + 1)
        widths = jnp.sum(
            jax.nn.one_hot(rank_bins, n_bins, dtype=jnp.float32), axis=0
        )  # (n_bins,)
        total = jnp.sum(counts, axis=-1, keepdims=True)
        expected = total * widths / (self.n_draws + 1)
        stat = jnp.sum(jnp.square(counts - expected) / expected, axis=-1)
        df = (n_bins - 1) / 2.0
        p = 1.0 - jax.scipy.special.gammainc(df, stat / 2.0)
        return stat, p

    def _n_bins(self, n_bins: int | None) -> int:
        if n_bins is None:
            n_bins = min(self.n_draws + 1, 20)
        if not 2 <= n_bins <= self.n_draws + 1:
            raise ValueError(
                f"SBCResult: n_bins={n_bins} must lie in "
                f"[2, n_draws + 1 = {self.n_draws + 1}]."
            )
        return n_bins


def sbc(
    key: PRNGKey,
    model: GenerativeFunction[R],
    args: tuple,
    latents: Selection,
    kernel,
    *,
    n_replicates: int,
    n_draws: int,
    thin: int = 1,
    summaries: Callable[[Trace[R]], FloatArray] | None = None,
) -> SBCResult:
    """Simulation-based calibration of a posterior kernel.

    `kernel` is either an `EditRequest` (run through one MH step per
    draw) or a `(key, trace) -> trace` callable that must leave
    `p(latents | everything else)` invariant while touching only the
    `latents` addresses (the complement stays fixed, acting as the
    conditioning data). `thin` kernel applications separate consecutive
    recorded draws; SBC assumes near-independent draws, so set it to a
    few autocorrelation times.

    All `n_replicates` chains advance together as one vmapped batch in
    the shared-args layout; each replicate starts at its own prior draw
    (already stationary), so there is no warmup phase.

    >>> import jax, jax.numpy as jnp
    >>> import genjax_tpu as gx
    >>> from genjax_tpu.inference.validation import sbc
    >>> @gx.gen
    ... def model():
    ...     mu = gx.normal(0.0, 1.0) @ "mu"
    ...     _ = gx.normal(mu, 1.0) @ "y"
    >>> res = sbc(
    ...     jax.random.key(0), model, (), gx.Selection.at["mu"],
    ...     gx.Regenerate(gx.Selection.at["mu"]),
    ...     n_replicates=64, n_draws=9, thin=2,
    ... )
    >>> res.ranks.shape  # 64 replicates x (mu,) summaries
    (64, 1)
    >>> bool(jnp.all((res.ranks >= 0) & (res.ranks <= 9)))
    True
    """
    g = summaries if summaries is not None else _flat_summaries(latents, False)
    sweep = _thinned(_as_kernel(kernel), thin)
    k_sim, k_tie, k_run = jrand.split(key, 3)

    keys = jrand.split(k_sim, n_replicates)
    traces = jax.vmap(model.simulate, in_axes=(0, None))(keys, args)
    traces = share_chain_args(traces, args)
    axes = _chain_axes(traces, n_replicates)
    g0 = jax.vmap(g, in_axes=(axes,))(traces)  # (R, S)
    u0 = jrand.uniform(k_tie, jnp.shape(g0))

    def draw(carry, step_key):
        traces, ranks = carry
        k_kern, k_u = jrand.split(step_key)
        keys = jrand.split(k_kern, n_replicates)
        traces = jax.vmap(sweep, in_axes=(0, axes), out_axes=axes)(
            keys, traces
        )
        gd = jax.vmap(g, in_axes=(axes,))(traces)
        # Lexicographic (value, iid uniform) comparison: exact for
        # continuous summaries, correct randomized tie-breaking for
        # discrete ones.
        ud = jrand.uniform(k_u, jnp.shape(gd))
        less = (gd < g0) | ((gd == g0) & (ud < u0))
        return (traces, ranks + less.astype(jnp.int32)), None

    ranks0 = jnp.zeros(jnp.shape(g0), dtype=jnp.int32)
    (_, ranks), _ = jax.lax.scan(
        draw, (traces, ranks0), jrand.split(k_run, n_draws)
    )
    return SBCResult(ranks=ranks, n_draws=n_draws)


@Pytree.dataclass
class GewekeResult(Pytree):
    """Geweke test output: per-summary moment z-scores between the
    forward sampler and the successive-conditional chain (|z| beyond
    ~4-5 flags a kernel bug), plus the underlying means and the
    autocorrelation-adjusted chain ESS."""

    z_scores: FloatArray = Pytree.field()
    mean_forward: FloatArray = Pytree.field()
    mean_chain: FloatArray = Pytree.field()
    ess: FloatArray = Pytree.field()

    def max_abs_z(self) -> FloatArray:
        return jnp.max(jnp.abs(self.z_scores))


def geweke(
    key: PRNGKey,
    model: GenerativeFunction[R],
    args: tuple,
    latents: Selection,
    kernel,
    *,
    n_forward: int,
    n_steps: int,
    n_chains: int = 8,
    thin: int = 1,
    summaries: Callable[[Trace[R]], FloatArray] | None = None,
) -> GewekeResult:
    """Geweke joint-distribution ("getting it right") test.

    Compares `n_forward` iid forward draws of the summaries against
    `n_chains` successive-conditional chains of `n_steps` sweeps, each
    sweep = `thin` applications of `kernel` on `p(latents | rest)`
    followed by an MH-corrected `Regenerate(~latents)` data refresh
    (exactly `y ~ p(y | theta)` when observations are leaves). Default
    summaries are every numeric choice and its square, so first and
    second joint moments are checked.

    The chain-side standard error uses the multi-chain autocorrelation
    ESS (`diagnostics.effective_sample_size`), so z-scores stay honest
    for slowly-mixing kernels.

    >>> import jax
    >>> import genjax_tpu as gx
    >>> from genjax_tpu.inference.validation import geweke
    >>> @gx.gen
    ... def model():
    ...     mu = gx.normal(0.0, 1.0) @ "mu"
    ...     _ = gx.normal(mu, 1.0) @ "y"
    >>> res = geweke(
    ...     jax.random.key(0), model, (), gx.Selection.at["mu"],
    ...     gx.Regenerate(gx.Selection.at["mu"]),
    ...     n_forward=512, n_steps=64, n_chains=4,
    ... )
    >>> res.z_scores.shape  # (mu, y) and their squares
    (4,)
    """
    g = (
        summaries
        if summaries is not None
        else _flat_summaries(Selection.all(), True)
    )
    latent_sweep = _thinned(_as_kernel(kernel), thin)
    refresh = _as_kernel(Regenerate(~latents))
    k_fwd, k_init, k_run = jrand.split(key, 3)

    fwd_keys = jrand.split(k_fwd, n_forward)
    fwd_traces = jax.vmap(model.simulate, in_axes=(0, None))(fwd_keys, args)
    fwd_traces = share_chain_args(fwd_traces, args)
    fwd_axes = _chain_axes(fwd_traces, n_forward)
    gf = jax.vmap(g, in_axes=(fwd_axes,))(fwd_traces)  # (n_forward, S)

    init_keys = jrand.split(k_init, n_chains)
    traces = jax.vmap(model.simulate, in_axes=(0, None))(init_keys, args)
    traces = share_chain_args(traces, args)
    axes = _chain_axes(traces, n_chains)

    def sweep(traces, step_key):
        k_lat, k_obs = jrand.split(step_key)

        def one(k1, k2, tr):
            return refresh(k2, latent_sweep(k1, tr))

        traces = jax.vmap(one, in_axes=(0, 0, axes), out_axes=axes)(
            jrand.split(k_lat, n_chains), jrand.split(k_obs, n_chains), traces
        )
        return traces, jax.vmap(g, in_axes=(axes,))(traces)

    _, gs = jax.lax.scan(sweep, traces, jrand.split(k_run, n_steps))
    gs = jnp.swapaxes(gs, 0, 1)  # (n_chains, n_steps, S)

    mean_f = jnp.mean(gf, axis=0)
    var_f = jnp.var(gf, axis=0, ddof=1)
    mean_c = jnp.mean(gs, axis=(0, 1))
    var_c = jnp.var(gs.reshape(-1, gs.shape[-1]), axis=0, ddof=1)
    ess = effective_sample_size(gs)
    se = jnp.sqrt(var_f / n_forward + var_c / ess)
    z = (mean_f - mean_c) / se
    return GewekeResult(
        z_scores=z, mean_forward=mean_f, mean_chain=mean_c, ess=ess
    )
