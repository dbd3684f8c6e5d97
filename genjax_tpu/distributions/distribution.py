"""`Distribution` and `ExactDensity`: primitive generative functions.

Capability parity with reference
`_src/generative_functions/distributions/distribution.py:55-500`:
the stochastic-probability interface (`random_weighted`/`estimate_logpdf`)
with the full GFI on top (generate with value/Mask/empty constraint
branching, Update/Regenerate edit weight math, project), `ExactDensity`
(`sample` + `logpdf`), and the `exact_density` factory.
"""

import warnings
from typing import Callable, Generic, TypeVar

import jax
import jax.tree_util as jtu
import jax.numpy as jnp

from genjax_tpu.core import checked
from genjax_tpu.core.choice_map import ChoiceMap, Selection
from genjax_tpu.core.concepts import (
    Argdiffs,
    EditRequest,
    NotSupportedEditRequest,
    Retdiff,
    Score,
    Weight,
)
from genjax_tpu.core.diff import Diff
from genjax_tpu.core.gfi import GenerativeFunction, Trace, Update
from genjax_tpu.core.mask import Mask
from genjax_tpu.core.pytree import Pytree
from genjax_tpu.core.requests import Regenerate
from genjax_tpu.core.staging import FlagOp, to_shape_fn
from genjax_tpu.core.typing import PRNGKey

R = TypeVar("R")


def pack_site_args(args: tuple) -> tuple:
    """Wrap trace-time-literal argument leaves (python scalars) in `Const`.

    Literals like the `(0.0, 1.0)` of `normal(0.0, 1.0)` are static at
    trace time; storing them as `Const` keeps them in the treedef, so
    `vmap` does NOT broadcast them into per-particle array columns. At
    1M particles that removes whole K-float columns from every resample
    exchange, `where_tree` select, and checkpoint. Traced values (and
    concrete arrays) stay dynamic leaves untouched."""
    import jax.tree_util as jtu

    from genjax_tpu.core.pytree import Const

    def wrap(leaf):
        if isinstance(leaf, (bool, int, float)):
            return Const(leaf)
        return leaf

    return jtu.tree_map(wrap, args, is_leaf=lambda x: isinstance(x, Const))


def unpack_site_args(args: tuple) -> tuple:
    """Inverse of `pack_site_args`: unwrap `Const` leaves."""
    import jax.tree_util as jtu

    from genjax_tpu.core.pytree import Const

    return jtu.tree_map(
        lambda x: x.unwrap() if isinstance(x, Const) else x,
        args,
        is_leaf=lambda x: isinstance(x, Const),
    )


@Pytree.dataclass
class DistributionTrace(Generic[R], Trace[R]):
    gen_fn: GenerativeFunction[R]
    args: tuple
    value: R
    score: Score

    @staticmethod
    def make(gen_fn, args: tuple, value, score) -> "DistributionTrace":
        """Build a trace with literal args packed as statics (see
        `pack_site_args`)."""
        return DistributionTrace(gen_fn, pack_site_args(args), value, score)

    def get_args(self) -> tuple:
        return unpack_site_args(self.args)

    def get_retval(self) -> R:
        return self.value

    def get_gen_fn(self) -> GenerativeFunction[R]:
        return self.gen_fn

    def get_score(self) -> Score:
        return self.score

    def get_choices(self) -> ChoiceMap:
        return ChoiceMap.choice(self.value)


class Distribution(Generic[R], GenerativeFunction[R]):
    """Generative functions over a single (unaddressed) choice, specified by
    the stochastic probability interface."""

    # The retval IS the sampled value: an un-edited distribution site's
    # output cannot change, even when its arguments do (see
    # `lang/analysis.py` taint rules).
    retval_is_value = True

    def random_weighted(self, key: PRNGKey, *args) -> tuple[Score, R]:
        """Sample a value and return (score-estimate, value)."""
        raise NotImplementedError

    def estimate_logpdf(self, key: PRNGKey, v: R, *args) -> Score:
        """Return an unbiased density(-estimate) of `v` in log space."""
        raise NotImplementedError

    # -- GFI ----------------------------------------------------------------

    def simulate(self, key: PRNGKey, args: tuple) -> Trace[R]:
        if checked.is_checked():
            checked.check_key(key, f"{type(self).__name__}.simulate")
            checked.check_args(args, f"{type(self).__name__}.simulate")
        (w, v) = self.random_weighted(key, *args)
        return DistributionTrace.make(self, args, v, w)

    def generate(
        self, key: PRNGKey, constraint: ChoiceMap, args: tuple
    ) -> tuple[Trace[R], Weight]:
        if checked.is_checked():
            checked.check_key(key, f"{type(self).__name__}.generate")
            checked.check_choice_map(constraint, f"{type(self).__name__}.generate")
            checked.check_args(args, f"{type(self).__name__}.generate")
        held = constraint.get_value()
        if held is None:
            # Unconstrained: fresh draw, importance weight 1.
            return self.simulate(key, args), jnp.zeros(())
        if not isinstance(held, Mask):
            # Fully constrained: the draw IS the constraint; weight is its
            # density (score and weight coincide for a single choice).
            # Canonicalize to arrays: a python-float constraint must stay a
            # DYNAMIC value (downstream edits would otherwise freeze it —
            # and anything derived from it — into the static treedef via
            # `pack_site_args`).
            held = jtu.tree_map(jnp.asarray, held)
            density = self.estimate_logpdf(key, held, *args)
            return DistributionTrace.make(self, args, held, density), density
        # Runtime-gated constraint (a traced Mask flag, e.g. a per-index
        # constraint inside `Vmap`/`Scan`). Dense formulation: run BOTH the
        # fresh draw and the density evaluation, then select — this is what
        # a `cond` lowers to under vmap anyway, and it keeps the whole
        # branch as fused elementwise work on an accelerator.
        flag = held.primal_flag()
        k_sim, k_score = jax.random.split(key)
        fresh_score, fresh_v = self.random_weighted(k_sim, *args)
        pinned_density = self.estimate_logpdf(k_score, held.value, *args)
        value = Mask(held.value, flag).unmask(default=fresh_v)
        score = jnp.where(flag, pinned_density, fresh_score)
        weight = jnp.where(flag, pinned_density, jnp.zeros(()))
        return DistributionTrace.make(self, args, value, score), weight

    def project(
        self, key: PRNGKey, trace: Trace[R], selection: Selection
    ) -> Weight:
        return jnp.where(selection.check(), trace.get_score(), jnp.zeros(()))

    def assess(self, sample: ChoiceMap, args: tuple):
        raise NotImplementedError

    # -- edit ------------------------------------------------------------------

    def edit_update(
        self,
        key: PRNGKey,
        trace: Trace[R],
        constraint: ChoiceMap,
        argdiffs: Argdiffs,
    ) -> tuple[Trace[R], Weight, Retdiff, Update]:
        # Every update case reduces to "re-score some value under the new
        # args"; the cases differ only in WHICH value wins, what gets
        # discarded, and the retdiff annotation.
        new_args = Diff.tree_primal(argdiffs)
        old_choices = trace.get_choices()
        old_value = old_choices.get_value()
        proposed = constraint.get_value()

        if proposed is None:
            winner = old_value
            discard = ChoiceMap.empty()
            retdiff = Diff.no_change(winner)
        elif isinstance(proposed, Mask):
            # Runtime-gated constraint: select the winner densely, then do
            # ONE density evaluation (both arms of the reference's cond
            # compute the same density at different points — selecting the
            # point first halves the work and stays fused on an accelerator).
            gate = proposed.primal_flag()
            winner = proposed.unmask(default=old_value)
            discard = old_choices.mask(gate)
            retdiff = Diff.unknown_change(winner)
        else:
            winner = proposed
            discard = old_choices
            retdiff = Diff.unknown_change(winner)

        # Canonicalize: constraint values may arrive as python scalars in
        # eager execution; the stored value (and the retdiff built from
        # it) must stay dynamic or `pack_site_args` would freeze
        # downstream consumers of this value into the static treedef.
        winner = jtu.tree_map(jnp.asarray, winner)
        retdiff = jtu.tree_map(
            lambda d: Diff(jnp.asarray(d.primal), d.tangent),
            retdiff,
            is_leaf=lambda x: isinstance(x, Diff),
        )
        rescored = self.estimate_logpdf(key, winner, *new_args)
        weight = rescored - trace.get_score()
        # Keep literal args static through unchanged-arg edits (the
        # common rejuvenation case) so the packing survives edit chains.
        stored = (
            trace.args
            if isinstance(trace, DistributionTrace)
            and Diff.static_check_no_change(argdiffs)
            else pack_site_args(new_args)
        )
        new_trace = DistributionTrace(self, stored, winner, rescored)
        return new_trace, weight, retdiff, Update(discard)

    def edit_regenerate(
        self,
        key: PRNGKey,
        trace: Trace[R],
        selection: Selection,
        argdiffs: Argdiffs,
    ) -> tuple[Trace[R], Weight, Retdiff, EditRequest]:
        # `selection.check()` may be a traced flag (MaskedSel); don't force
        # it through Python bool (`in` would).
        selected = selection.check()
        new_args = Diff.tree_primal(argdiffs)
        prior_score = trace.get_score()
        held = trace.get_retval()

        if FlagOp.concrete_true(selected):
            # Statically selected: draw fresh under the new args. The
            # proposal and prior densities at the fresh draw cancel in the
            # SMCP3 weight, leaving only the retired score.
            fresh_score, fresh = self.random_weighted(key, *new_args)
            stored = (
                trace.args
                if isinstance(trace, DistributionTrace)
                and Diff.static_check_no_change(argdiffs)
                else pack_site_args(new_args)
            )
            return (
                DistributionTrace(self, stored, fresh, fresh_score),
                fresh_score - prior_score,
                Diff.unknown_change(fresh),
                Update(ChoiceMap.choice(held)),
            )

        if FlagOp.concrete_false(selected):
            # Statically unselected: the value survives; only an argument
            # change can move its score.
            if Diff.static_check_no_change(argdiffs):
                return (
                    trace,
                    jnp.zeros(()),
                    Diff.no_change(held),
                    Update(ChoiceMap.empty()),
                )
            rescored, _ = self.assess(trace.get_choices(), new_args)
            return (
                DistributionTrace(self, pack_site_args(new_args), held, rescored),
                rescored - prior_score,
                Diff.no_change(held),
                Update(ChoiceMap.empty()),
            )

        # Runtime-valued selection (e.g. a per-index selection sliced
        # inside `lax.scan`/`vmap`): compute both outcomes and select
        # densely — the accelerator-friendly realization (no host control flow;
        # XLA fuses the select into the density pass).
        def when_selected(k):
            s, v = self.random_weighted(k, *new_args)
            return v, s

        def when_kept(k):
            return held, self.estimate_logpdf(k, held, *new_args)

        value, score = FlagOp.cond(selected, when_selected, when_kept, key)
        stored = (
            trace.args
            if isinstance(trace, DistributionTrace)
            and Diff.static_check_no_change(argdiffs)
            else pack_site_args(new_args)
        )
        return (
            DistributionTrace(self, stored, value, score),
            score - prior_score,
            Diff.unknown_change(value),
            Update(ChoiceMap.choice(held).mask(selected)),
        )

    def edit(
        self,
        key: PRNGKey,
        trace: Trace[R],
        edit_request: EditRequest,
        argdiffs: Argdiffs,
    ) -> tuple[Trace[R], Weight, Retdiff, EditRequest]:
        match edit_request:
            case Update(chm):
                return self.edit_update(key, trace, chm, argdiffs)
            case Regenerate(selection):
                return self.edit_regenerate(key, trace, selection, argdiffs)
            case _:
                raise NotSupportedEditRequest(edit_request)


################
# ExactDensity #
################


class ExactDensity(Generic[R], Distribution[R]):
    """Distributions with exact `sample`/`logpdf` implementations."""

    def sample(self, key: PRNGKey, *args) -> R:
        raise NotImplementedError

    def logpdf(self, v: R, *args, **kwargs) -> Score:
        raise NotImplementedError

    def __abstract_call__(self, *args):
        key = jax.eval_shape(lambda: jax.random.key(0))
        return to_shape_fn(self.sample, jnp.zeros)(key, *args)

    def random_weighted(self, key: PRNGKey, *args) -> tuple[Score, R]:
        v = self.sample(key, *args)
        w = self.estimate_logpdf(key, v, *args)
        return (w, v)

    def estimate_logpdf(self, key: PRNGKey, v: R, *args) -> Weight:
        w = self.logpdf(v, *args)
        if jnp.shape(w):
            return jnp.sum(w)
        return w

    def assess(self, sample: ChoiceMap, args: tuple) -> tuple[Weight, R]:
        held = sample.get_value()
        if isinstance(held, Mask):
            # Unmask with the checkify-gated validity check (flags are only
            # inspected inside `do_checkify()`).
            held = held.unmask()
        density = self.estimate_logpdf(jax.random.key(0), held, *args)
        return density, held


def canonicalize_distribution_name(s: str) -> str:
    """snake_case the name and prefix the package, for rendered type names."""
    import re

    return "genjax_tpu." + re.sub(r"(?<=[a-z0-9])(?=[A-Z])", "_", s).lower()


def exact_density(
    sample: Callable[..., R],
    logpdf: Callable[..., Score],
    name: str | None = None,
) -> ExactDensity[R]:
    """Construct a singleton `ExactDensity` from `sample`/`logpdf` callables.

    >>> import jax, jax.numpy as jnp
    >>> from genjax_tpu.distributions.distribution import exact_density
    >>> rayleigh = exact_density(
    ...     lambda key, s: s * jnp.sqrt(-2.0 * jnp.log(jax.random.uniform(key))),
    ...     lambda v, s: jnp.log(v / s**2) - v**2 / (2 * s**2),
    ...     "rayleigh",
    ... )
    >>> tr = rayleigh.simulate(jax.random.key(0), (1.0,))
    >>> bool(tr.get_retval() > 0)
    True
    >>> score, _ = rayleigh.assess(tr.get_choices(), (1.0,))
    >>> bool(jnp.isclose(score, tr.get_score()))
    True
    """
    if name is None:
        warnings.warn(
            "exact_density: pass `name=` so traces and rendered types carry "
            "a useful label."
        )
        name = "anonymous"

    def splat(fn, head, rest: tuple, kw: dict):
        # Calls made with keyword syntax arrive as a packed
        # `(positional_tuple, kwargs_dict)` pair; unpack it transparently,
        # otherwise forward as-is.
        packed = not kw and len(rest) == 2 and isinstance(rest[1], dict)
        if packed:
            positional, keywords = rest
            return fn(head, *positional, **keywords)
        return fn(head, *rest, **kw)

    class _SyntheticDensity(ExactDensity):
        def sample(self, key, *args, **kwargs):
            return splat(sample, key, args, kwargs)

        def logpdf(self, v, *args, **kwargs):
            return splat(logpdf, v, args, kwargs)

        def handle_kwargs(self):
            return self

    label = canonicalize_distribution_name(name)
    _SyntheticDensity.__name__ = label
    _SyntheticDensity.__qualname__ = label
    return Pytree.dataclass(_SyntheticDensity)()
