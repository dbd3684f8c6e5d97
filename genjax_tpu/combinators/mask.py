"""`MaskCombinator`: dynamic existence for generative computations.

Capability parity with reference
`_src/generative_functions/combinators/mask.py:48-322`, including the
four-case (pre-check x post-check) transition weight lattice in `edit`.

Accelerator note: masking gates the score through `FlagOp.where` (a `select`) and
`select`s values — dense arithmetic instead of control flow, the
canonical accelerator pattern for existence uncertainty under vectorization.
`select`, NOT flag-multiplication: a masked-off subtree can legitimately
carry a `-inf` inner score (an out-of-support constraint transplanted
into it — distributions score those `-inf` by design, see
`distributions/library.py::_guard_support`), and `0 * -inf` is NaN where
the masked score must be exactly 0.
"""

from typing import Any, Generic, TypeVar


from genjax_tpu.core.choice_map import Address, ChoiceMap, Selection
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
from genjax_tpu.core.staging import FlagOp
from genjax_tpu.core.typing import Flag, PRNGKey

R = TypeVar("R")


@Pytree.dataclass
class MaskTrace(Generic[R], Trace[Any]):
    mask_combinator: "MaskCombinator[R]"
    inner: Trace[R]
    args: tuple
    chm: ChoiceMap
    score: Score
    ret: Mask
    check: Flag

    @staticmethod
    def build(gen_fn, inner: Trace[R], check) -> "MaskTrace[R]":
        args = (check, *inner.get_args())
        chm = inner.get_choices().mask(check)
        ret = Mask.build(inner.get_retval(), check)
        score = FlagOp.where(check, inner.get_score(), 0.0)
        return MaskTrace(gen_fn, inner, args, chm, score, ret, check)

    def get_args(self) -> tuple:
        return self.args

    def get_gen_fn(self):
        return self.mask_combinator

    def get_choices(self) -> ChoiceMap:
        return self.chm

    def get_retval(self):
        return self.ret

    def get_score(self):
        return self.score

    def get_inner_trace(self, address: Address):
        return self.inner.get_inner_trace(address)


@Pytree.dataclass
class MaskCombinator(Generic[R], GenerativeFunction[Any]):
    """Adds a Boolean first argument gating the wrapped generative
    function's score contribution; the return value is a `Mask`."""

    gen_fn: GenerativeFunction[R]

    def simulate(self, key: PRNGKey, args: tuple) -> MaskTrace[R]:
        check, inner_args = args[0], args[1:]
        tr = self.gen_fn.simulate(key, inner_args)
        return MaskTrace.build(self, tr, check)

    def generate(
        self, key: PRNGKey, constraint: ChoiceMap, args: tuple
    ) -> tuple[MaskTrace[R], Weight]:
        check, inner_args = args[0], args[1:]
        tr, w = self.gen_fn.generate(key, constraint, inner_args)
        return MaskTrace.build(self, tr, check), FlagOp.where(check, w, 0.0)

    def assess(self, sample: ChoiceMap, args: tuple) -> tuple[Score, Any]:
        check, inner_args = args[0], args[1:]
        score, retval = self.gen_fn.assess(sample, inner_args)
        return FlagOp.where(check, score, 0.0), Mask(retval, check)

    def project(self, key: PRNGKey, trace, selection: Selection) -> Weight:
        assert isinstance(trace, MaskTrace)
        inner_w = trace.inner.project(key, selection)
        return FlagOp.where(trace.check, inner_w, 0.0)

    def edit(
        self,
        key: PRNGKey,
        trace,
        edit_request: EditRequest,
        argdiffs: Argdiffs,
    ) -> tuple[MaskTrace[R], Weight, Retdiff, EditRequest]:
        from genjax_tpu.core.requests import Regenerate

        assert isinstance(trace, MaskTrace)
        if not isinstance(edit_request, (Update, Regenerate)):
            raise NotSupportedEditRequest(edit_request)
        check_diff, inner_argdiffs = argdiffs[0], argdiffs[1:]
        post_check = Diff.tree_primal(check_diff)
        pre_check = trace.check
        original = trace.inner

        new_inner, weight, retdiff, bwd = self.gen_fn.edit(
            key, original, edit_request, inner_argdiffs
        )

        # Transition lattice over (pre_check, post_check):
        #   T->T: inner incremental weight
        #   T->F: remove the old score
        #   F->T: add the new score
        #   F->F: zero
        t_to_t = FlagOp.and_(pre_check, post_check)
        t_to_f = FlagOp.and_(pre_check, FlagOp.not_(post_check))
        f_to_t = FlagOp.and_(FlagOp.not_(pre_check), post_check)
        final_trace_score = FlagOp.where(
            post_check, new_inner.get_score(), 0.0
        )
        # The four lattice cases are mutually exclusive, so a select
        # chain is exact — and unlike the flag-product sum it stays
        # NaN-free when any leg is +-inf (impossible-state weights).
        final_weight = FlagOp.where(
            t_to_t,
            weight,
            FlagOp.where(
                t_to_f,
                -original.get_score(),
                FlagOp.where(f_to_t, final_trace_score, 0.0),
            ),
        )

        if isinstance(bwd, Update):
            bwd = Update(bwd.constraint.mask(post_check))
        return (
            MaskTrace.build(self, new_inner, post_check),
            final_weight,
            Mask.build(Diff.tree_primal(retdiff), post_check),
            bwd,
        )


def mask(f: GenerativeFunction[R]) -> MaskCombinator[R]:
    """Wrap `f` with a dynamic-existence Boolean first argument."""
    return MaskCombinator(f)
