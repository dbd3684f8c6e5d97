"""`Scan` combinator: sequential composition `(c, a) -> (c, b)` over
`jax.lax.scan`, plus the derived decorators (`accumulate`, `reduce`,
`iterate`, `iterate_final`, `masked_iterate`, `masked_iterate_final`).

Capability parity with reference
`_src/generative_functions/combinators/scan.py` (1150 LoC): simulate/
generate/assess/project, `Update`/`Regenerate` re-scan edits,
`IndexRequest` O(1) single-step edit with next-step revisit,
`VectorRequest`.

`lax.scan` is already the optimal accelerator lowering for sequential structure
(one compiled step body, no unrolling); the addresses traced by each step
nest under the integer step index and store as dense per-step arrays.
"""

from typing import Any, Generic, TypeVar

import jax
import jax.numpy as jnp
import jax.tree_util as jtu

from genjax_tpu.core.checkify import optional_check
from genjax_tpu.core.choice_map import Address, ChoiceMap, Selection
from genjax_tpu.core.concepts import (
    Argdiffs,
    EditRequest,
    IndexRequest,
    NotSupportedEditRequest,
    PrimitiveEditRequest,
    Score,
    Weight,
)
from genjax_tpu.core.diff import Diff
from genjax_tpu.core.gfi import GenerativeFunction, Trace, Update
from genjax_tpu.core.pytree import Pytree
from genjax_tpu.core.requests import Regenerate
from genjax_tpu.core.typing import IntArray, PRNGKey

Carry = TypeVar("Carry")
Y = TypeVar("Y")
R = TypeVar("R")


@Pytree.dataclass
class ScanTrace(Generic[Carry, Y], Trace[tuple[Carry, Y]]):
    scan_gen_fn: "Scan[Carry, Y]"
    inner: Trace[tuple[Carry, Y]]
    args: tuple
    retval: tuple[Carry, Y]
    score: Any
    chm: ChoiceMap
    scan_length: int = Pytree.static()

    @staticmethod
    def build(scan_gen_fn, inner, args, retval, score, scan_length):
        if scan_length == 0:
            chm = ChoiceMap.empty()
        else:
            chm = jax.vmap(lambda t: t.get_choices())(inner)
        return ScanTrace(scan_gen_fn, inner, args, retval, score, chm, scan_length)

    def get_args(self) -> tuple:
        return self.args

    def get_retval(self):
        return self.retval

    def get_choices(self) -> ChoiceMap:
        return self.chm

    def get_gen_fn(self):
        return self.scan_gen_fn

    def get_score(self):
        return self.score

    def get_inner_trace(self, address: Address):
        return self.inner.get_inner_trace(address)


@Pytree.dataclass(match_args=True)
class VectorRequest(PrimitiveEditRequest):
    """Vector of per-step edit sub-requests (the backward request shape
    produced by re-scan edits)."""

    request: EditRequest


@Pytree.dataclass
class Scan(Generic[Carry, Y], GenerativeFunction[tuple[Carry, Y]]):
    """Scan a kernel generative function of type `(c, a) -> (c, b)` into a
    generative function of type `(c, [a]) -> (c, [b])`. Step `t`'s traced
    choices nest under integer address `t`."""

    kernel_gen_fn: GenerativeFunction[tuple[Carry, Y]]
    length: int | None = Pytree.static()

    def __abstract_call__(self, *args) -> tuple[Carry, Y]:
        return jax.lax.scan(
            self.kernel_gen_fn.__abstract_call__, *args, length=self.length
        )

    @staticmethod
    def _static_scan_length(xs: Any, length: int | None) -> int:
        jax.lax.scan(lambda c, x: (c, None), None, xs, length=length)
        if length is not None:  # `n=0` is a valid explicit length
            return length
        return jtu.tree_leaves(xs)[0].shape[0]

    # -- GFI -------------------------------------------------------------------

    def simulate(self, key: PRNGKey, args: tuple) -> ScanTrace[Carry, Y]:
        carry, scanned_in = args

        def step(state, x):
            key, count, c = state
            sub_key = jax.random.fold_in(key, count)
            tr = self.kernel_gen_fn.simulate(sub_key, (c, x))
            c_out, y = tr.get_retval()
            return (key, count + 1, c_out), (tr, y, tr.get_score())

        (_, _, c_final), (tr, ys, scores) = jax.lax.scan(
            step, (key, jnp.asarray(0), carry), scanned_in, length=self.length
        )
        return ScanTrace.build(
            self,
            tr,
            args,
            (c_final, ys),
            jnp.sum(scores),
            self._static_scan_length(scanned_in, self.length),
        )

    def generate(
        self, key: PRNGKey, constraint: ChoiceMap, args: tuple
    ) -> tuple[ScanTrace[Carry, Y], Weight]:
        carry, scanned_in = args

        def step(state, x):
            key, idx, c = state
            sub_key = jax.random.fold_in(key, idx)
            submap = constraint.get_submap(idx)
            tr, w = self.kernel_gen_fn.generate(sub_key, submap, (c, x))
            c_out, y = tr.get_retval()
            return (key, idx + 1, c_out), (tr, y, tr.get_score(), w)

        (_, _, c_final), (tr, ys, scores, ws) = jax.lax.scan(
            step, (key, jnp.asarray(0), carry), scanned_in, length=self.length
        )
        return (
            ScanTrace.build(
                self,
                tr,
                args,
                (c_final, ys),
                jnp.sum(scores),
                self._static_scan_length(scanned_in, self.length),
            ),
            jnp.sum(ws),
        )

    def assess(self, sample: ChoiceMap, args: tuple) -> tuple[Score, Any]:
        carry, scanned_in = args

        def step(state, x):
            idx, c = state
            submap = sample.get_submap(idx)
            score, (c_out, y) = self.kernel_gen_fn.assess(submap, (c, x))
            return (idx + 1, c_out), (y, score)

        (_, c_final), (ys, scores) = jax.lax.scan(
            step, (0, carry), scanned_in, length=self.length
        )
        return jnp.sum(scores), (c_final, ys)

    def project(self, key: PRNGKey, trace, selection: Selection) -> Weight:
        from genjax_tpu.combinators.vmap import _check_indexable

        assert isinstance(trace, ScanTrace)
        _check_indexable(selection, "Scan.project")

        def step(state, subtrace):
            key, idx = state
            sub_key = jax.random.fold_in(key, idx)
            # Consume the integer step level of the address space, matching
            # `edit_regenerate` and the trace's `get_choices()` layout.
            w = subtrace.project(sub_key, selection(idx))
            return (key, idx + 1), w

        _, ws = jax.lax.scan(
            step, (key, jnp.asarray(0)), trace.inner, length=self.length
        )
        return jnp.sum(ws)

    # -- edit ------------------------------------------------------------------

    def _rescan_edit(
        self,
        key: PRNGKey,
        trace: "ScanTrace[Carry, Y]",
        make_request,
        argdiffs: Argdiffs,
    ):
        """Re-scan the whole sequence, editing each step; the carry chain
        propagates edited values forward (dense recompute — the accelerator-friendly
        realization of the reference's incremental re-scan)."""
        primals = Diff.tree_primal(argdiffs)
        carry, scanned_in = primals
        # The carry entering each step may have changed (edits upstream in
        # the sequence flow through it), so its tangent is always unknown;
        # the scanned-in slice, however, inherits the CALLER's static
        # tangents — a NoChange data axis keeps the step callee's
        # O(affected) plan alive.
        _, xs_ad = argdiffs
        x_tangents = Diff.tree_tangent(xs_ad)

        def _x_rediff(x):
            try:
                return Diff.tree_diff(x, x_tangents)
            except Exception:
                return Diff.unknown_change(x)

        def step(state, scanned):
            key, idx, c = state
            subtrace, x = scanned
            sub_key = jax.random.fold_in(key, idx)
            request = make_request(idx)
            new_sub, w, rd, bwd = request.edit(
                sub_key, subtrace, (Diff.unknown_change(c), _x_rediff(x))
            )
            c_out, y = Diff.tree_primal(rd)
            return (key, idx + 1, c_out), (new_sub, y, new_sub.get_score(), w, bwd)

        (_, _, c_final), (new_subs, ys, scores, ws, bwds) = jax.lax.scan(
            step,
            (key, jnp.asarray(0), carry),
            (trace.inner, scanned_in),
            length=self.length,
        )
        new_trace = ScanTrace.build(
            self, new_subs, primals, (c_final, ys), jnp.sum(scores), trace.scan_length
        )
        return new_trace, jnp.sum(ws), (c_final, ys), bwds

    def edit_update(self, key, trace, constraint: ChoiceMap, argdiffs):
        new_trace, w, retval, bwds = self._rescan_edit(
            key, trace, lambda idx: Update(constraint(idx)), argdiffs
        )
        # `bwds` is the scan-stacked pytree of per-step `Update` requests:
        # an `Update` whose constraint leaves carry a leading step axis.
        assert isinstance(bwds, Update)
        return (
            new_trace,
            w,
            Diff.unknown_change(retval),
            Update(bwds.constraint),
        )

    def edit_regenerate(self, key, trace, selection: Selection, argdiffs):
        from genjax_tpu.combinators.vmap import _check_indexable

        _check_indexable(selection, "Scan.edit_regenerate")
        new_trace, w, retval, bwds = self._rescan_edit(
            key, trace, lambda idx: Regenerate(selection(idx)), argdiffs
        )
        return (
            new_trace,
            w,
            Diff.unknown_change(retval),
            VectorRequest(bwds),
        )

    def edit_index(
        self,
        key: PRNGKey,
        trace: "ScanTrace[Carry, Y]",
        idx: IntArray,
        request: EditRequest,
        argdiffs: Argdiffs,
    ):
        """O(1) edit of step `idx`, then a single revisit of step `idx+1`
        to account for its changed carry-in.

        Soundness requires the kernel's carry-out at step `idx+1` to be
        unaffected by its carry-in (e.g. the carry is resampled per step
        under the constraint) — the same structural condition the
        reference asserts statically (`scan.py:325-416`). The condition is
        validated at runtime inside `do_checkify()` (the revisited step's
        carry-out is compared against the original carry chain); outside
        checkify it remains the user's responsibility — use the re-scan
        `Update` edit when unsure.
        """
        assert Diff.static_check_no_change(argdiffs)
        primals = Diff.tree_primal(argdiffs)
        (_, scanned_in) = primals
        (old_c_final, old_ys) = trace.get_retval()
        max_length = trace.scan_length

        trace_slice = jtu.tree_map(lambda v: v[idx], trace.inner)
        new_slice, w, rd, bwd = request.edit(
            key, trace_slice, Diff.no_change(trace_slice.get_args())
        )
        (carry_out, y_slice) = Diff.tree_primal(rd)

        # Revisit step idx+1 with the changed carry-in.
        nxt = jnp.minimum(idx + 1, max_length - 1)
        next_slice = jtu.tree_map(lambda v: v[nxt], trace.inner)
        next_x = jtu.tree_map(lambda v: v[nxt], scanned_in)
        next_new, next_w, next_rd, _ = Update(ChoiceMap.empty()).edit(
            key,
            next_slice,
            (Diff.unknown_change(carry_out), Diff.no_change(next_x)),
        )
        has_next = idx + 1 < max_length

        # Scatter the edited slices back into the dense per-step trace.
        new_inner = jtu.tree_map(
            lambda v, s: v.at[idx].set(s), trace.inner, new_slice
        )
        new_inner = jtu.tree_map(
            lambda v, s: v.at[nxt].set(jnp.where(has_next, s, v[nxt])),
            new_inner,
            next_new,
        )

        scores = jax.vmap(lambda t: t.get_score())(new_inner)
        idx_array = jnp.arange(max_length)
        (_next_c_out, next_y) = Diff.tree_primal(next_rd)

        def _carry_stability_check():
            # An O(1) edit is sound only if the revisited step's carry-out
            # is what it always was — otherwise the change propagates into
            # step idx+2 and beyond, which this edit does not touch. The
            # original carry-out at step `nxt` is step nxt+1's carry-in
            # (or the final carry when nxt is last).
            from jax.experimental import checkify

            after = jnp.minimum(nxt + 1, max_length - 1)
            after_slice = jtu.tree_map(lambda v: v[after], trace.inner)
            (after_carry_in, _) = after_slice.get_args()
            old_c_out = jtu.tree_map(
                lambda nxt_in, final: jnp.where(
                    nxt + 1 < max_length, nxt_in, final
                ),
                after_carry_in,
                old_c_final,
            )
            stable = jnp.asarray(True)
            for a, b in zip(
                jtu.tree_leaves(_next_c_out), jtu.tree_leaves(old_c_out)
            ):
                stable = stable & jnp.allclose(a, b, rtol=1e-5, atol=1e-6)
            checkify.check(
                stable | ~has_next,
                "Scan.edit_index: the revisited step's carry-out changed — "
                "this kernel's carry depends on its carry-in, so the O(1) "
                "IndexRequest edit silently corrupts steps beyond idx+1. "
                "Use the dense re-scan Update/Regenerate edit instead.\n",
            )

        optional_check(_carry_stability_check)

        def scatter_y(old, slice_val, at_idx, active=True):
            mask = ((idx_array == at_idx) & active).reshape(
                (-1,) + (1,) * (old.ndim - 1)
            )
            return jnp.where(mask, jnp.broadcast_to(slice_val, old.shape), old)

        new_ys = jtu.tree_map(
            lambda old, s: scatter_y(old, s, idx), old_ys, y_slice
        )
        new_ys = jtu.tree_map(
            lambda old, s: scatter_y(old, s, nxt, has_next), new_ys, next_y
        )
        # Final carry changes only when the edited/revisited step is last.
        new_c_final = jtu.tree_map(
            lambda a, b: jnp.where(idx == max_length - 1, a, b),
            carry_out,
            old_c_final,
        )

        new_trace = ScanTrace.build(
            self,
            new_inner,
            primals,
            (new_c_final, new_ys),
            jnp.sum(scores),
            max_length,
        )
        return (
            new_trace,
            w + next_w * has_next,
            Diff.unknown_change(new_trace.get_retval()),
            IndexRequest(idx, bwd),
        )

    def edit(
        self,
        key: PRNGKey,
        trace: Trace[tuple[Carry, Y]],
        edit_request: EditRequest,
        argdiffs: Argdiffs,
    ):
        assert isinstance(trace, ScanTrace)
        match edit_request:
            case Update(constraint):
                return self.edit_update(key, trace, constraint, argdiffs)
            case Regenerate(selection):
                return self.edit_regenerate(key, trace, selection, argdiffs)
            case IndexRequest(idx, request):
                return self.edit_index(key, trace, idx, request, argdiffs)
            case VectorRequest(request):
                return self._rescan_vector_edit(key, trace, request, argdiffs)
            case _:
                raise NotSupportedEditRequest(edit_request)

    def _rescan_vector_edit(self, key, trace, stacked_request, argdiffs):
        """Apply a vector (stacked) request: step `t` gets slice `t`."""
        new_trace, w, retval, bwds = self._rescan_edit(
            key,
            trace,
            lambda idx: jtu.tree_map(lambda v: v[idx], stacked_request),
            argdiffs,
        )
        return (new_trace, w, Diff.unknown_change(retval), VectorRequest(bwds))


def scan(*, n: int | None = None):
    """Decorator: wrap a `(c, a) -> (c, b)` gen fn into `(c, [a]) -> (c, [b])`."""

    def decorator(f: GenerativeFunction[tuple[Carry, Y]]) -> Scan[Carry, Y]:
        return Scan(f, n)

    return decorator


###########################
# Derived scan decorators #
###########################


def prepend_initial_acc(args, ret):
    """Prepend the initial accumulator to the scan outputs (used by
    `accumulate`)."""
    init_acc = args[0]
    accs = ret[1]
    return jtu.tree_map(
        lambda init, acc: jnp.concatenate([jnp.expand_dims(init, 0), acc]),
        init_acc,
        accs,
    )


def accumulate():
    """`(c, a) -> c` kernel becomes `(c, [a]) -> [c]` (all intermediate
    accumulations, `jax.lax.scan`-style cumulative outputs, with the
    initial value prepended)."""

    def decorator(f: GenerativeFunction[Carry]):
        from genjax_tpu.combinators.dimap import Dimap

        kernel = Dimap(
            f,
            lambda c, x: (c, x),
            lambda _args, _xformed, c: (c, c),
            "accumulate-kernel",
        )
        scanned = Scan(kernel, None)
        return Dimap(
            scanned,
            lambda *args: args,
            lambda args, _xformed, ret: prepend_initial_acc(args, ret),
            "accumulate",
        )

    return decorator


def reduce():
    """`(c, a) -> c` kernel becomes `(c, [a]) -> c` (final accumulation)."""

    def decorator(f: GenerativeFunction[Carry]):
        from genjax_tpu.combinators.dimap import Dimap

        kernel = Dimap(
            f,
            lambda c, x: (c, x),
            lambda _args, _xformed, c: (c, None),
            "reduce-kernel",
        )
        scanned = Scan(kernel, None)
        return Dimap(
            scanned,
            lambda *args: args,
            lambda _args, _xformed, ret: ret[0],
            "reduce",
        )

    return decorator


def iterate(*, n: int):
    """`a -> a` kernel becomes `a -> [a]` (all `n+1` iterates, initial
    value included)."""

    def decorator(f: GenerativeFunction[Any]):
        from genjax_tpu.combinators.dimap import Dimap

        kernel = Dimap(
            f,
            lambda c, _scanned: (c,),
            lambda _args, _xformed, c: (c, c),
            "iterate-kernel",
        )
        scanned = Scan(kernel, n)
        return Dimap(
            scanned,
            lambda a: (a, None),
            lambda args, _xformed, ret: prepend_initial_acc(args, ret),
            "iterate",
        )

    return decorator


def iterate_final(*, n: int):
    """`a -> a` kernel becomes `a -> a` (apply `n` times, final value)."""

    def decorator(f: GenerativeFunction[Any]):
        from genjax_tpu.combinators.dimap import Dimap

        kernel = Dimap(
            f,
            lambda c, _scanned: (c,),
            lambda _args, _xformed, c: (c, None),
            "iterate-final-kernel",
        )
        scanned = Scan(kernel, n)
        return Dimap(
            scanned,
            lambda a: (a, None),
            lambda _args, _xformed, ret: ret[0],
            "iterate_final",
        )

    return decorator


def masked_iterate():
    """`a -> a` kernel becomes `(a, [mask_flags]) -> [a]`: step `t` runs
    the kernel under `MaskCombinator` with flag `t` — masked-out steps
    still propagate the transformed value but contribute zero score
    (variable-length sequence support)."""

    def decorator(f: GenerativeFunction[Any]):
        from genjax_tpu.combinators.dimap import Dimap
        from genjax_tpu.combinators.mask import MaskCombinator

        masked = MaskCombinator(f)

        kernel = Dimap(
            masked,
            lambda c, flag: (flag, c),
            lambda args, _xformed, masked_ret: (
                masked_ret.value,
                masked_ret.value,
            ),
            "masked-iterate-kernel",
        )
        scanned = Scan(kernel, None)
        return Dimap(
            scanned,
            lambda *args: args,
            lambda args, _xformed, ret: prepend_initial_acc(args, ret),
            "masked_iterate",
        )

    return decorator


def masked_iterate_final():
    """`a -> a` kernel becomes `(a, [mask_flags]) -> a` (final value)."""

    def decorator(f: GenerativeFunction[Any]):
        from genjax_tpu.combinators.dimap import Dimap
        from genjax_tpu.combinators.mask import MaskCombinator

        masked = MaskCombinator(f)

        kernel = Dimap(
            masked,
            lambda c, flag: (flag, c),
            lambda _args, _xformed, masked_ret: (masked_ret.value, None),
            "masked-iterate-final-kernel",
        )
        scanned = Scan(kernel, None)
        return Dimap(
            scanned,
            lambda *args: args,
            lambda _args, _xformed, ret: ret[0],
            "masked_iterate_final",
        )

    return decorator
