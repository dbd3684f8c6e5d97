"""`Switch` combinator: runtime branch selection over N generative
functions.

Capability parity with reference
`_src/generative_functions/combinators/switch.py:52-354`.

Accelerator note: `multi_switch` evaluates exactly one branch under `lax.switch`
into a zero-padded superstructure; `tree_choose` then selects
retval/score. This is the compiler-friendly realization of existence
uncertainty — no dynamic shapes, no host control flow.
"""

from typing import Any, Generic, TypeVar

import jax.numpy as jnp

from genjax_tpu.core.choice_map import Address, ChoiceMap, Selection
from genjax_tpu.core.concepts import (
    Argdiffs,
    EditRequest,
    NotSupportedEditRequest,
    Retdiff,
    Score,
    Weight,
)
from genjax_tpu.core.diff import Diff, NoChange
from genjax_tpu.core.gfi import GenerativeFunction, Trace, Update
from genjax_tpu.core.pytree import Pytree
from genjax_tpu.core.staging import multi_switch, tree_choose
from genjax_tpu.core.typing import IntArray, PRNGKey

R = TypeVar("R")


@Pytree.dataclass
class SwitchTrace(Generic[R], Trace[R]):
    gen_fn: "Switch[R]"
    args: tuple
    subtraces: list
    retval: R
    score: Any

    def get_idx(self) -> IntArray:
        return self.get_args()[0]

    def get_args(self) -> tuple:
        return self.args

    def get_choices(self) -> ChoiceMap:
        sub_chms = (tr.get_choices() for tr in self.subtraces)
        return ChoiceMap.switch(self.get_idx(), sub_chms)

    def get_gen_fn(self):
        return self.gen_fn

    def get_retval(self):
        return self.retval

    def get_score(self):
        return self.score

    def get_inner_trace(self, address: Address):
        return self.subtraces[self.get_idx()].get_inner_trace(address)


@Pytree.dataclass
class Switch(Generic[R], GenerativeFunction[R]):
    """Takes `n` branches; the resulting gen fn takes `(idx, args_0, ...,
    args_{n-1})` and executes branch `idx` (clamped into range) with its
    argument tuple. Branches may trace different addresses (existence
    uncertainty)."""

    branches: tuple

    def __abstract_call__(self, *args) -> R:
        idx, branch_args = args[0], args[1:]
        retvals = [
            f.__abstract_call__(*f_args)
            for f, f_args in zip(self.branches, branch_args)
        ]
        return tree_choose(idx, retvals)

    def _check_args(self, args):
        assert len(args) == len(self.branches)

    def simulate(self, key: PRNGKey, args: tuple) -> SwitchTrace[R]:
        idx, branch_args = args[0], args[1:]
        self._check_args(branch_args)
        fs = [f.simulate for f in self.branches]
        f_args = [(key, a) for a in branch_args]
        subtraces = multi_switch(idx, fs, f_args)
        retval, score = tree_choose(
            idx, [(tr.get_retval(), tr.get_score()) for tr in subtraces]
        )
        return SwitchTrace(self, args, subtraces, retval, score)

    def assess(self, sample: ChoiceMap, args: tuple) -> tuple[Score, R]:
        idx, branch_args = args[0], args[1:]
        self._check_args(branch_args)
        fs = [f.assess for f in self.branches]
        f_args = [(sample, a) for a in branch_args]
        return tree_choose(idx, multi_switch(idx, fs, f_args))

    def generate(
        self, key: PRNGKey, constraint: ChoiceMap, args: tuple
    ) -> tuple[SwitchTrace[R], Weight]:
        idx, branch_args = args[0], args[1:]
        self._check_args(branch_args)
        fs = [f.generate for f in self.branches]
        f_args = [(key, constraint, a) for a in branch_args]
        pairs = multi_switch(idx, fs, f_args)
        subtraces = [tr for tr, _ in pairs]
        retval, score, weight = tree_choose(
            idx, [(tr.get_retval(), tr.get_score(), w) for tr, w in pairs]
        )
        return SwitchTrace(self, args, subtraces, retval, score), weight

    def project(self, key: PRNGKey, trace: Trace[R], selection: Selection) -> Weight:
        assert isinstance(trace, SwitchTrace)
        idx = trace.get_idx()
        fs = [f.project for f in self.branches]
        f_args = [(key, tr, selection) for tr in trace.subtraces]
        return tree_choose(idx, multi_switch(idx, fs, f_args))

    def _edit_fresh_trace(self, gen_fn: GenerativeFunction[R]):
        """When the branch index changed, the new branch has no prior
        subtrace: simulate a fresh one and edit it in place."""

        def inner(key, edit_request, argdiffs):
            primals = Diff.tree_primal(argdiffs)
            new_trace = gen_fn.simulate(key, primals)
            tr, w, rd, bwd = gen_fn.edit(
                key, new_trace, edit_request, Diff.no_change(primals)
            )
            return tr, w, Diff.unknown_change(rd), bwd

        return inner

    def edit(
        self,
        key: PRNGKey,
        trace: Trace[R],
        edit_request: EditRequest,
        argdiffs: Argdiffs,
    ) -> tuple[SwitchTrace[R], Weight, Retdiff, EditRequest]:
        from genjax_tpu.core.requests import Regenerate

        if not isinstance(edit_request, (Update, Regenerate)):
            raise NotSupportedEditRequest(edit_request)
        assert isinstance(trace, SwitchTrace)
        idx_diff, branch_argdiffs = argdiffs[0], argdiffs[1:]
        self._check_args(branch_argdiffs)
        primals = Diff.tree_primal(argdiffs)
        new_idx = primals[0]

        if Diff.tree_tangent(idx_diff) is NoChange:
            fs = [f.edit for f in self.branches]
            f_args = [
                (key, tr, edit_request, ad)
                for tr, ad in zip(trace.subtraces, branch_argdiffs)
            ]
            rets = multi_switch(new_idx, fs, f_args)
            subtraces = [t[0] for t in rets]
            score, weight, retval = tree_choose(
                new_idx,
                [(tr.get_score(), w, Diff.tree_primal(rd)) for tr, w, rd, _ in rets],
            )
            # Same-branch edit: pick the executed branch's backward
            # request. `tree_choose` requires the branch requests to share
            # one tree structure; heterogeneous branches get an explicit
            # unsupported sentinel instead of branch 0's (wrong) request.
            import jax.tree_util as jtu

            from genjax_tpu.core.requests import UnsupportedBackwardRequest

            bwds = [t[3] for t in rets]
            structures = {jtu.tree_structure(b) for b in bwds}
            if len(structures) == 1:
                bwd_request = tree_choose(new_idx, bwds)
            elif all(isinstance(b, Update) for b in bwds):
                # Heterogeneous per-branch discards (e.g. a closure-
                # capture branch next to a combinator branch) merge
                # through the choice-map algebra's own Switch node: the
                # active branch's discard is live, the others masked
                # out — a REPRESENTABLE backward Update (found by the
                # offline structural sweep; previously an unsupported
                # sentinel that crashed the static language's
                # `assert isinstance(bwd, Update)`).
                bwd_request = Update(
                    ChoiceMap.switch(new_idx, [b.constraint for b in bwds])
                )
            else:
                bwd_request = UnsupportedBackwardRequest(
                    "Switch branches produced structurally different "
                    "backward requests; reverse this move by re-simulating "
                    "or constraining the old choices explicitly."
                )
            return (
                SwitchTrace(self, primals, subtraces, retval, score),
                weight,
                Diff.unknown_change(retval),
                bwd_request,
            )

        # Index tangent unknown: the runtime index may or may not equal the
        # stored one. Editing as if the branch always changed would
        # RE-SIMULATE the branch even when `new_idx == old_idx` — an Update
        # must keep unconstrained values (caught by the structural fuzzer:
        # mask(mix(...)) flag flips silently resampled the mixture's
        # component sample). Run both the same-branch edit (valid where
        # equal) and the fresh path (valid where moved) and select densely.
        import jax.tree_util as jtu

        from genjax_tpu.core.requests import UnsupportedBackwardRequest
        from genjax_tpu.core.staging import where_tree

        old_idx = trace.get_idx()
        moved = jnp.asarray(new_idx != old_idx)

        fs_same = [f.edit for f in self.branches]
        same_args = [
            (key, tr, edit_request, ad)
            for tr, ad in zip(trace.subtraces, branch_argdiffs)
        ]
        rets_same = multi_switch(new_idx, fs_same, same_args)
        fs_fresh = [self._edit_fresh_trace(f) for f in self.branches]
        fresh_args = [(key, edit_request, ad) for ad in branch_argdiffs]
        rets_fresh = multi_switch(new_idx, fs_fresh, fresh_args)

        subtraces = [
            where_tree(moved, f[0], s[0]) for s, f in zip(rets_same, rets_fresh)
        ]
        score, retval = tree_choose(
            new_idx, [(tr.get_score(), tr.get_retval()) for tr in subtraces]
        )
        w_same = tree_choose(new_idx, [t[1] for t in rets_same])
        # Where the branch moved, the weight is the full joint delta (same
        # convention as Mask's existence transitions and Regenerate); the
        # fresh inner edit's weight (edited - fresh) must be DISCARDED, not
        # added — keeping it double-counts every constrained site (caught
        # by tests/combinators/test_combinator_properties.py). Where the
        # index is runtime-equal, the same-branch incremental weight holds.
        weight = jnp.where(moved, score - trace.get_score(), w_same)

        # Backward: where moved, re-constrain the old branch's choices
        # wholesale; where equal, the same-branch discard. Both are
        # Updates, merged under a runtime two-way ChoiceMap switch.
        bwds_same = [t[3] for t in rets_same]
        structures = {jtu.tree_structure(b) for b in bwds_same}
        if len(structures) == 1 and all(isinstance(b, Update) for b in bwds_same):
            same_constraint = tree_choose(
                new_idx, [b.constraint for b in bwds_same]
            )
            bwd_request = Update(
                ChoiceMap.switch(
                    jnp.asarray(moved, dtype=jnp.int32),
                    [same_constraint, trace.get_choices()],
                )
            )
        else:
            # Heterogeneous branch discards (or a Regenerate forward):
            # re-constrain the old choices wholesale — a valid reverse for
            # both the moved and runtime-equal cases, just coarser than
            # the minimal discard.
            bwd_request = Update(trace.get_choices())
        return (
            SwitchTrace(self, primals, subtraces, retval, score),
            weight,
            Diff.unknown_change(retval),
            bwd_request,
        )


def switch(*gen_fns: GenerativeFunction[R]) -> Switch[R]:
    """Build a `Switch` over the given branches."""
    return Switch(tuple(gen_fns))
