"""The `@gen` static modeling language.

Capability parity with reference `_src/generative_functions/static.py`
(1062 LoC): `gen`, `trace`, `StaticGenerativeFunction`, `StaticTrace`,
`StaticRequest`, `AddressReuse`, `MissingAddress`; GFI methods
`simulate/assess/generate/project/edit` with `Update`, `Regenerate`, and
per-address `StaticRequest` edit requests.

Accelerator-first architecture
------------------------------
Every GFI method runs the model source *directly* under JAX tracing with a
method-specific handler installed (see `lang/interop.py`) — there is no
jaxpr staging or interpretation on these paths. The resulting XLA program
is exactly the program a hand-written JAX implementation of the method
would produce.

PRNG discipline matches the reference (`static.py:260-263`): the k-th
`trace` call in program order receives `jax.random.fold_in(key, k)`, which
is reproducible and vectorization-friendly.

Edit semantics: the reference propagates static change tangents (`Diff`)
through model code with an incremental jaxpr interpreter so unchanged
addresses skip density recomputation. Here the same capability comes from
a one-time site-graph dependency analysis (`lang/analysis.py`): addresses
outside the statically-affected set reuse their subtraces verbatim (and
vanish from the compiled edit), addresses whose arguments are provably
unchanged pass `NoChange` argdiffs into their callees (recursing the
plan through nested models), and everything else recomputes densely with
the identical weight algebra (`fwd_logpdf - old_score` per address).
Dynamic structure falls back to dense recompute, which is always correct.
"""

import functools
from dataclasses import dataclass
from typing import Any, Generic, TypeVar

import jax
import jax.numpy as jnp

from genjax_tpu.core import checked
from genjax_tpu.core.choice_map import ChoiceMap, Selection
from genjax_tpu.core.concepts import (
    Argdiffs,
    EditRequest,
    NotSupportedEditRequest,
    PrimitiveEditRequest,
    Retdiff,
    Score,
    Weight,
)
from genjax_tpu.core.diff import Diff
from genjax_tpu.core.gfi import GenerativeFunction, Trace, Update
from genjax_tpu.core.pytree import Closure, Pytree
from genjax_tpu.core.requests import EmptyRequest, Regenerate
from genjax_tpu.core.staging import to_shape_fn
from genjax_tpu.core.typing import PRNGKey
from genjax_tpu.lang.interop import TraceHandler, handler_context, trace

R = TypeVar("R")

_WRAPPER_ASSIGNMENTS = (
    "__module__",
    "__name__",
    "__qualname__",
    "__doc__",
    "__annotations__",
)

StaticAddress = str | tuple[str, ...]


##############
# Exceptions #
##############


class AddressReuse(Exception):
    """Attempt to re-write an address in a trace. Each address may only be
    traced once per program execution."""


class MissingAddress(Exception):
    """Attempt to assess a model without supplying values for all sampled
    addresses."""


#########
# Trace #
#########


@Pytree.dataclass
class StaticTrace(Generic[R], Trace[R]):
    """Trace of a `@gen` program: a dict of per-address subtraces (address
    keys are static treedef metadata)."""

    gen_fn: "StaticGenerativeFunction[R]"
    args: tuple
    retval: R
    subtraces: dict

    def get_args(self) -> tuple:
        return self.args

    def get_retval(self) -> R:
        return self.retval

    def get_gen_fn(self) -> GenerativeFunction[R]:
        return self.gen_fn

    def get_choices(self) -> ChoiceMap:
        return ChoiceMap.d({
            address: subtrace.get_choices()
            for address, subtrace in self.subtraces.items()
        })

    def get_score(self) -> Score:
        scores = [tr.get_score() for tr in self.subtraces.values()]
        if not scores:
            return jnp.zeros(())
        return functools.reduce(lambda a, b: a + b, scores)

    def get_inner_trace(self, address):
        return self.subtraces[address]


####################################
# Static (per-address) edit request #
####################################


@Pytree.dataclass(match_args=True)
class StaticRequest(PrimitiveEditRequest):
    """A dict of per-address edit sub-requests."""

    addressed: dict


############
# Handlers #
############


class StaticLangHandler(TraceHandler):
    """Base handler: records subtraces, rejects address reuse, hands out
    per-site PRNG keys via counter fold-in."""

    def __init__(self, key: PRNGKey | None):
        self.key = key
        self.key_counter = 1
        self.subtraces: dict = {}

    def fresh_key(self) -> PRNGKey:
        new_key = jax.random.fold_in(self.key, self.key_counter)
        self.key_counter += 1
        return new_key

    def record(self, addr, subtrace) -> None:
        if addr in self.subtraces:
            raise AddressReuse(addr)
        self.subtraces[addr] = subtrace


class SimulateHandler(StaticLangHandler):
    def handle_trace(self, addr, gen_fn, args):
        tr = gen_fn.simulate(self.fresh_key(), args)
        self.record(addr, tr)
        return tr.get_retval()


class AssessHandler(StaticLangHandler):
    def __init__(self, sample: ChoiceMap):
        super().__init__(None)
        self.sample = sample
        self.score = jnp.zeros(())

    def handle_trace(self, addr, gen_fn, args):
        submap = self.sample(addr)
        if submap.static_is_empty():
            raise MissingAddress(addr)
        score, v = gen_fn.assess(submap, args)
        self.score += score
        return v


class GenerateHandler(StaticLangHandler):
    def __init__(self, key: PRNGKey, constraint: ChoiceMap):
        super().__init__(key)
        self.constraint = constraint
        self.weight = jnp.zeros(())

    def handle_trace(self, addr, gen_fn, args):
        sub = self.constraint(addr)
        tr, w = gen_fn.generate(self.fresh_key(), sub, args)
        self.weight += w
        self.record(addr, tr)
        return tr.get_retval()


class UpdateHandler(StaticLangHandler):
    def __init__(
        self,
        key: PRNGKey,
        previous_trace: StaticTrace,
        constraint: ChoiceMap,
        plan: "_EditPlan",
    ):
        super().__init__(key)
        self.previous_trace = previous_trace
        self.constraint = constraint
        self.weight = jnp.zeros(())
        self.bwd_constraints: list[ChoiceMap] = []
        self.plan = plan

    def handle_trace(self, addr, gen_fn, args):
        subtrace = self.previous_trace.get_inner_trace(addr)
        if addr in self.plan.reuse:
            # Statically unaffected: keep the subtrace, zero weight. XLA
            # dead-code-eliminates this address's density work entirely.
            self.bwd_constraints.append(ChoiceMap.empty())
            self.record(addr, subtrace)
            return subtrace.get_retval()
        # Statically-proven-unchanged argument leaves propagate NoChange
        # into the callee, so nested @gen callees recurse the O(affected)
        # plan (and combinators keep their cheap same-structure paths).
        sub_constraint = self.constraint(addr)
        if self.plan.needs_dense(addr, gen_fn, subtrace):
            # The callee's own pytree leaves (closure captures built
            # inside the source) changed — argdiffs cannot express that,
            # and the callee's edit would see its captures as jaxpr
            # constants and believe nothing moved. Densely regenerate
            # under the NEW callee with the old values (constraint wins
            # where both speak); values are kept, densities recomputed.
            old_choices = subtrace.get_choices()
            tr, _ = gen_fn.generate(
                self.fresh_key(), sub_constraint | old_choices, args
            )
            self.weight += tr.get_score() - subtrace.get_score()
            self.bwd_constraints.append(
                old_choices.filter(sub_constraint.get_selection())
            )
            self.record(addr, tr)
            return tr.get_retval()
        argdiffs = self.plan.site_argdiffs(addr, args)
        request = Update(sub_constraint)
        # Dispatch through the FRESHLY-constructed callee (not
        # `subtrace.get_gen_fn()`), which under an analyzed plan is
        # leaf-identical to the stored one.
        tr, w, retdiff, bwd = gen_fn.edit(
            self.fresh_key(), subtrace, request, argdiffs
        )
        if isinstance(bwd, Update):
            self.bwd_constraints.append(bwd.constraint)
        else:
            # The callee could not express its minimal discard as an
            # Update (e.g. a combinator with an unrepresentable reverse).
            # Re-constraining the site's old choices wholesale is a
            # coarser but VALID reverse: scores are state functions, so
            # the round-trip weight antisymmetry still holds.
            self.bwd_constraints.append(subtrace.get_choices())
        self.weight += w
        self.record(addr, tr)
        return Diff.tree_primal(retdiff)


class RegenerateHandler(StaticLangHandler):
    def __init__(
        self,
        key: PRNGKey,
        previous_trace: StaticTrace,
        selection: Selection,
        plan: "_EditPlan",
    ):
        super().__init__(key)
        self.previous_trace = previous_trace
        self.selection = selection
        self.weight = jnp.zeros(())
        self.bwd_requests: list[EditRequest] = []
        self.plan = plan

    def handle_trace(self, addr, gen_fn, args):
        subtrace = self.previous_trace.get_inner_trace(addr)
        if addr in self.plan.reuse:
            self.bwd_requests.append(EmptyRequest())
            self.record(addr, subtrace)
            return subtrace.get_retval()
        subselection = self.selection(addr)
        if self.plan.needs_dense(addr, gen_fn, subtrace):
            # Changed closure captures (see UpdateHandler): densely
            # regenerate under the new callee — unselected values kept
            # and re-scored, selected ones freshly proposed.
            kept = subtrace.get_choices().filter(~subselection)
            tr, _ = gen_fn.generate(self.fresh_key(), kept, args)
            self.weight += tr.get_score() - subtrace.get_score()
            self.bwd_requests.append(Regenerate(subselection))
            self.record(addr, tr)
            return tr.get_retval()
        argdiffs = self.plan.site_argdiffs(addr, args)
        request = Regenerate(subselection)
        # Fresh-callee dispatch for the same closure-capture reason as
        # UpdateHandler.handle_trace.
        tr, w, retdiff, bwd = gen_fn.edit(
            self.fresh_key(), subtrace, request, argdiffs
        )
        self.bwd_requests.append(bwd)
        self.weight += w
        self.record(addr, tr)
        return Diff.tree_primal(retdiff)


class StaticRequestHandler(StaticLangHandler):
    def __init__(self, key: PRNGKey, previous_trace: StaticTrace, addressed: dict):
        super().__init__(key)
        self.previous_trace = previous_trace
        self.addressed = addressed
        self.weight = jnp.zeros(())
        self.bwd_requests: list[EditRequest] = []

    def handle_trace(self, addr, gen_fn, args):
        subtrace = self.previous_trace.get_inner_trace(addr)
        subrequest = self.addressed.get(addr, EmptyRequest())
        argdiffs = Diff.unknown_change(args)
        if not _callee_leaves_match(gen_fn, subtrace.get_gen_fn()):
            # The callee's own pytree leaves (closure captures built
            # inside the source) changed under an upstream sub-edit —
            # argdiffs cannot express that (a zero-arg `partial_apply`
            # callee would even see trivially-NoChange argdiffs), so the
            # site must densely recompute under the FRESH callee (see
            # UpdateHandler.handle_trace). Express the subrequest in the
            # dense formulation where possible.
            old_choices = subtrace.get_choices()
            if isinstance(subrequest, (EmptyRequest, Update)):
                sub_constraint = (
                    subrequest.constraint
                    if isinstance(subrequest, Update)
                    else ChoiceMap.empty()
                )
                tr, _ = gen_fn.generate(
                    self.fresh_key(), sub_constraint | old_choices, args
                )
                bwd = Update(old_choices.filter(sub_constraint.get_selection()))
            elif isinstance(subrequest, Regenerate):
                kept = old_choices.filter(~subrequest.selection)
                tr, _ = gen_fn.generate(self.fresh_key(), kept, args)
                bwd = Regenerate(subrequest.selection)
            else:
                raise NotSupportedEditRequest(
                    f"StaticRequest at {addr!r}: the callee's closure "
                    "captures changed under this edit, and "
                    f"{type(subrequest).__name__} cannot be composed with "
                    "a dense recompute. Split the edit: first Update the "
                    "upstream value, then apply the request."
                )
            self.weight += tr.get_score() - subtrace.get_score()
            self.bwd_requests.append(bwd)
            self.record(addr, tr)
            return tr.get_retval()
        if isinstance(subrequest, PrimitiveEditRequest):
            # Fresh-callee dispatch (leaf-identical to the stored one
            # here; see UpdateHandler.handle_trace).
            tr, w, retdiff, bwd = gen_fn.edit(
                self.fresh_key(), subtrace, subrequest, argdiffs
            )
        else:
            tr, w, retdiff, bwd = subrequest.edit(
                self.fresh_key(), subtrace, argdiffs
            )
        self.bwd_requests.append(bwd)
        self.weight += w
        self.record(addr, tr)
        return Diff.tree_primal(retdiff)


@dataclass(frozen=True)
class _EditPlan:
    """Statically-computed reuse/argdiff plan for one edit (see
    `lang/analysis.py`). `_FALLBACK` (all-empty, unanalyzed) is always
    correct: it recomputes everything with all-unknown argdiffs and
    falls back to runtime callee-leaf comparison."""

    reuse: frozenset = frozenset()           # subtraces kept verbatim
    args_unchanged: frozenset = frozenset()  # edited sites with NoChange args
    retval_static: bool = False              # model retval statically unchanged
    # addr -> pytree-of-bools over the site's args: per-LEAF change masks,
    # so e.g. a Switch receives NoChange on its index argument when only
    # its data arguments changed (keeping the cheap same-branch edit path).
    argdiff_masks: dict = None  # type: ignore[assignment]
    # Sites whose CALLEE pytree leaves (closure captures) are tainted by
    # this edit — argdiffs cannot express that, so these need a dense
    # per-site recompute under the freshly-built callee.
    callee_changed: frozenset = frozenset()
    analyzed: bool = False

    def site_argdiffs(self, addr, args):
        if addr in self.args_unchanged:
            return Diff.no_change(args)
        mask = (self.argdiff_masks or {}).get(addr)
        if mask is None:
            return Diff.unknown_change(args)
        try:
            return jax.tree_util.tree_map(
                lambda leaf, m: (
                    Diff.unknown_change(leaf) if m else Diff.no_change(leaf)
                ),
                args,
                mask,
            )
        except Exception:
            # Runtime structure drifted from the staged structure: the
            # per-leaf plan no longer applies; coarse is always correct.
            return Diff.unknown_change(args)

    def needs_dense(self, addr, gen_fn, subtrace) -> bool:
        """True when `addr`'s edit must densely recompute under the
        freshly-built callee because its closure captures (may have)
        changed. With analysis, this is the precise tainted set; without,
        a conservative runtime leaf comparison against the stored
        callee."""
        if self.analyzed:
            return addr in self.callee_changed
        return not _callee_leaves_match(gen_fn, subtrace.get_gen_fn())


_FALLBACK_PLAN = _EditPlan()


def _callee_leaves_match(new_gf, old_gf) -> bool:
    """Best-effort proof that two callee pytrees hold identical leaves:
    same treedef and leafwise object identity or concrete equality.
    Tracer leaves that are distinct objects cannot be proven equal, so
    they report False (dense recompute — always correct)."""
    import numpy as np

    from genjax_tpu.core.typing import static_check_is_concrete

    try:
        new_leaves, new_td = jax.tree_util.tree_flatten(new_gf)
        old_leaves, old_td = jax.tree_util.tree_flatten(old_gf)
    except Exception:
        return False
    if new_td != old_td or len(new_leaves) != len(old_leaves):
        return False
    for a, b in zip(new_leaves, old_leaves):
        if a is b:
            continue
        if (
            static_check_is_concrete(a)
            and static_check_is_concrete(b)
            and np.array_equal(a, b)
        ):
            continue
        return False
    return True


def _static_edit_plan(
    source,
    primals,
    trace: StaticTrace,
    constraint: ChoiceMap | None = None,
    selection: Selection | None = None,
    args_changed: bool = True,
) -> _EditPlan:
    """Compute the set of addresses whose subtraces can be reused verbatim
    for this edit, per-site argdiff precision, and whether the return
    value is statically unchanged (see `lang/analysis.py`). Falls back to
    no-reuse on any analysis failure — reuse is an optimization, never
    required for correctness."""
    from genjax_tpu.lang.analysis import (
        site_graph,
        static_selected_addresses,
        static_touched_addresses,
    )

    try:
        graph = site_graph(source, primals)
        if constraint is not None:
            touched = static_touched_addresses(constraint)
        else:
            touched = static_selected_addresses(selection, graph.order)
        if touched is None:
            return _FALLBACK_PLAN
        # Only trust the plan if the analysis saw exactly the addresses
        # the trace recorded (guards against dynamic structure).
        if set(graph.order) != set(trace.subtraces.keys()):
            return _FALLBACK_PLAN
        w_set = graph.weight_set(touched, args_changed)
        reuse = frozenset(graph.order) - w_set
        # Addresses edited only because the request targets them directly
        # — their *arguments* are provably unchanged, so nested callees
        # receive NoChange argdiffs and recurse the plan.
        args_unchanged = frozenset(
            addr
            for addr in w_set
            if not (graph.deps[addr] & touched)
            and not (args_changed and addr in graph.args_reach)
        )
        argdiff_masks = {}
        callee_changed = set()
        for addr in w_set - args_unchanged:
            mask, cc = graph.site_edit_info(addr, touched, args_changed)
            if cc:
                callee_changed.add(addr)
            elif mask is not None:
                argdiff_masks[addr] = mask
        return _EditPlan(
            reuse=reuse,
            args_unchanged=args_unchanged,
            retval_static=graph.retval_unchanged(touched, args_changed),
            argdiff_masks=argdiff_masks,
            callee_changed=frozenset(callee_changed),
            analyzed=True,
        )
    except Exception:
        return _FALLBACK_PLAN


def _canon_scalar(l):
    """Canonicalize a python scalar to a NUMPY 0-d array with JAX's
    default dtypes. numpy (not `jnp.asarray`): under `jit` tracing,
    `jnp.asarray` stages the constant into a tracer, which would defeat
    trace-time sampler specialization (`distributions/library.py::
    _trace_time_scalar`); a numpy array is a dynamic pytree leaf AND
    stays concrete inside traced code."""
    import numpy as np

    if isinstance(l, bool):
        return np.asarray(l)
    if isinstance(l, int):
        return np.asarray(l, dtype=np.int32)
    if isinstance(l, float):
        return np.asarray(l, dtype=np.float32)
    return l


def _canon_args(args: tuple) -> tuple:
    """Eager/traced structural parity (ARCHITECTURE.md 4c).

    Python-scalar leaves of the incoming args become (numpy) arrays
    before the source runs — matching the dynamic-leaf structure `jit`
    tracing gives them. With this, distribution call sites see python
    scalars ONLY for source literals, so the static-args packing
    (`pack_site_args`) keys off a property of the MODEL, never of the
    caller's execution mode: a trace built eagerly has the same pytree
    structure as one built under `jit`/`vmap`.
    """
    return jax.tree_util.tree_map(_canon_scalar, args)


def _canon_argdiffs(argdiffs: Argdiffs) -> Argdiffs:
    """`_canon_args` lifted over `Diff` leaves (edit entry points)."""
    return jax.tree_util.tree_map(
        lambda d: Diff(_canon_scalar(d.primal), d.tangent),
        argdiffs,
        is_leaf=lambda x: isinstance(x, Diff),
    )


#######################
# Generative function #
#######################


@Pytree.dataclass
class StaticGenerativeFunction(Generic[R], GenerativeFunction[R]):
    """A generative function whose source is a JAX-traceable Python program
    using `dist(args) @ "addr"` addressing syntax.

    Language restrictions (same as the reference, `static.py:730-750`):
    `jax.lax` control-flow primitives may only wrap *deterministic* code
    (use the `scan`/`switch`/`vmap` combinators for traced control flow);
    untraced randomness requires passing a key explicitly.
    """

    source: Closure

    def __get__(self, instance, _klass) -> "StaticGenerativeFunction[R]":
        return self.partial_apply(instance) if instance else self

    def __abstract_call__(self, *args) -> Any:
        return to_shape_fn(self.source, jnp.zeros)(*args)

    def __post_init__(self):
        wrapped = self.source.fn
        for k in _WRAPPER_ASSIGNMENTS:
            v = getattr(wrapped, k, None)
            if v is not None:
                object.__setattr__(self, k, v)
        object.__setattr__(self, "__wrapped__", wrapped)

    def handle_kwargs(self) -> "StaticGenerativeFunction[R]":
        @Pytree.partial()
        def kwarged_source(args, kwargs):
            return self.source(*args, **kwargs)

        return StaticGenerativeFunction(kwarged_source)

    # -- GFI -------------------------------------------------------------------

    def simulate(self, key: PRNGKey, args: tuple) -> StaticTrace[R]:
        if checked.is_checked():
            checked.check_key(key, "simulate")
            checked.check_args(args, "simulate")
        args = _canon_args(args)
        handler = SimulateHandler(key)
        with handler_context(handler):
            retval = self.source(*args)
        return StaticTrace(self, args, retval, handler.subtraces)

    def assess(self, sample: ChoiceMap, args: tuple) -> tuple[Score, R]:
        if checked.is_checked():
            checked.check_choice_map(sample, "assess", "sample")
            checked.check_args(args, "assess")
        args = _canon_args(args)
        handler = AssessHandler(sample)
        with handler_context(handler):
            retval = self.source(*args)
        return handler.score, retval

    def generate(
        self, key: PRNGKey, constraint: ChoiceMap, args: tuple
    ) -> tuple[StaticTrace[R], Weight]:
        if checked.is_checked():
            checked.check_key(key, "generate")
            checked.check_choice_map(constraint, "generate")
            checked.check_args(args, "generate")
        args = _canon_args(args)
        handler = GenerateHandler(key, constraint)
        with handler_context(handler):
            retval = self.source(*args)
        return StaticTrace(self, args, retval, handler.subtraces), handler.weight

    def project(self, key: PRNGKey, trace: Trace[Any], selection: Selection) -> Weight:
        assert isinstance(trace, StaticTrace)
        weight = jnp.zeros(())
        for count, addr in enumerate(trace.subtraces.keys()):
            subprojection = selection(addr)
            subtrace = trace.get_subtrace(addr)
            # Per-address key derivation (the same counter-`fold_in`
            # discipline as the simulate/generate handlers): projection of
            # density *estimates* may consume randomness per address.
            sub_key = jax.random.fold_in(key, count)
            weight += subtrace.project(sub_key, subprojection)
        return weight

    # -- edits -----------------------------------------------------------------

    def edit_update(
        self,
        key: PRNGKey,
        trace: StaticTrace[R],
        constraint: ChoiceMap,
        argdiffs: Argdiffs,
    ) -> tuple[StaticTrace[R], Weight, Retdiff, EditRequest]:
        if constraint.static_is_empty() and Diff.static_check_no_change(argdiffs):
            # Statically-empty edit: identity move, zero weight.
            return (
                trace,
                jnp.zeros(()),
                Diff.no_change(trace.get_retval()),
                Update(ChoiceMap.empty()),
            )
        primals = Diff.tree_primal(argdiffs)
        args_changed = not Diff.static_check_no_change(argdiffs)
        plan = _static_edit_plan(
            self.source, primals, trace, constraint=constraint, args_changed=args_changed
        )
        handler = UpdateHandler(key, trace, constraint, plan)
        with handler_context(handler):
            retval = self.source(*primals)
        new_trace = StaticTrace(self, primals, retval, handler.subtraces)
        bwd_chm = ChoiceMap.from_mapping(
            zip(handler.subtraces.keys(), handler.bwd_constraints)
        )
        retdiff = (
            Diff.no_change(retval)
            if plan.retval_static
            else Diff.unknown_change(retval)
        )
        return (new_trace, handler.weight, retdiff, Update(bwd_chm))

    def edit_regenerate(
        self,
        key: PRNGKey,
        trace: StaticTrace[R],
        selection: Selection,
        argdiffs: Argdiffs,
    ) -> tuple[StaticTrace[R], Weight, Retdiff, EditRequest]:
        from genjax_tpu.core.choice_map import NoneSel

        if isinstance(selection, NoneSel) and Diff.static_check_no_change(argdiffs):
            return (
                trace,
                jnp.zeros(()),
                Diff.no_change(trace.get_retval()),
                Regenerate(selection),
            )
        primals = Diff.tree_primal(argdiffs)
        args_changed = not Diff.static_check_no_change(argdiffs)
        plan = _static_edit_plan(
            self.source, primals, trace, selection=selection, args_changed=args_changed
        )
        handler = RegenerateHandler(key, trace, selection, plan)
        with handler_context(handler):
            retval = self.source(*primals)
        new_trace = StaticTrace(self, primals, retval, handler.subtraces)
        bwd_request = StaticRequest(
            dict(zip(handler.subtraces.keys(), handler.bwd_requests))
        )
        retdiff = (
            Diff.no_change(retval)
            if plan.retval_static
            else Diff.unknown_change(retval)
        )
        return (new_trace, handler.weight, retdiff, bwd_request)

    def edit_static_request(
        self,
        key: PRNGKey,
        trace: StaticTrace[R],
        addressed: dict,
        argdiffs: Argdiffs,
    ) -> tuple[StaticTrace[R], Weight, Retdiff, EditRequest]:
        primals = Diff.tree_primal(argdiffs)
        handler = StaticRequestHandler(key, trace, addressed)
        with handler_context(handler):
            retval = self.source(*primals)
        new_trace = StaticTrace(self, primals, retval, handler.subtraces)
        bwd_request = StaticRequest(
            dict(zip(handler.subtraces.keys(), handler.bwd_requests))
        )
        return (
            new_trace,
            handler.weight,
            Diff.unknown_change(retval),
            bwd_request,
        )

    def edit(
        self,
        key: PRNGKey,
        trace: Trace[R],
        edit_request: EditRequest,
        argdiffs: Argdiffs,
    ) -> tuple[StaticTrace[R], Weight, Retdiff, EditRequest]:
        if checked.is_checked():
            checked.check_key(key, "edit")
            checked.check_request(edit_request, "edit")
            checked.check_args(argdiffs, "edit (argdiffs)")
        assert isinstance(trace, StaticTrace)
        argdiffs = _canon_argdiffs(argdiffs)
        match edit_request:
            case Update(constraint):
                return self.edit_update(key, trace, constraint, argdiffs)
            case StaticRequest(addressed):
                return self.edit_static_request(key, trace, addressed, argdiffs)
            case Regenerate(selection):
                return self.edit_regenerate(key, trace, selection, argdiffs)
            case _:
                raise NotSupportedEditRequest(edit_request)

    # -- sugar ------------------------------------------------------------------

    def inline(self, *args):
        """Invoke the source inline in the caller's generative context
        (callee addresses appear directly in the caller's trace)."""
        return self.source(*args)

    @property
    def partial_args(self) -> tuple:
        return self.source.dyn_args

    def partial_apply(self, *args) -> "StaticGenerativeFunction[R]":
        all_args = self.source.dyn_args + args
        return gen(Closure(all_args, self.source.fn))


#############
# Decorator #
#############


def gen(f) -> StaticGenerativeFunction[Any]:
    """Decorator converting a JAX-traceable Python function using
    `dist(args) @ "addr"` syntax into a `StaticGenerativeFunction`."""
    if isinstance(f, Closure):
        return StaticGenerativeFunction(f)
    return gen(Closure((), f))


__all__ = [
    "AddressReuse",
    "MissingAddress",
    "StaticGenerativeFunction",
    "StaticRequest",
    "StaticTrace",
    "gen",
    "trace",
]
