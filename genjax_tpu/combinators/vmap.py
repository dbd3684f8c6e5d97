"""`Vmap` combinator: lift a generative function over a batch axis.

Capability parity with reference
`_src/generative_functions/combinators/vmap.py:55-420` (simulate/
generate/assess/project/edit, per-index constraint lookup, `IndexRequest`
single-slice edit).

This combinator is the workhorse of particle parallelism on an accelerator: the
per-particle program vectorizes into dense batched XLA ops, and the batch
axis is exactly the axis sharded over the device mesh by
`genjax_tpu.parallel`.
"""

from typing import Any, Generic, TypeVar

import jax
import jax.numpy as jnp
import jax.tree_util as jtu

from genjax_tpu.core.choice_map import Address, ChoiceMap, Selection
from genjax_tpu.core.concepts import (
    Argdiffs,
    EditRequest,
    IndexRequest,
    NotSupportedEditRequest,
    Retdiff,
    Score,
    Weight,
)
from genjax_tpu.core.diff import Diff
from genjax_tpu.core.gfi import GenerativeFunction, Trace, Update
from genjax_tpu.core.pytree import Pytree
from genjax_tpu.core.typing import InAxes, IntArray, PRNGKey

R = TypeVar("R")


def _check_indexable(selection: Selection, where: str) -> None:
    """Raise on selections that can never address into an indexed (lane /
    step) address space — a silent no-op there is a biased always-accept
    MH move waiting to happen."""
    from genjax_tpu.core.choice_map import (
        NoneSel,
        statically_unmatchable_at_index_level,
    )

    if not isinstance(selection, NoneSel) and statically_unmatchable_at_index_level(
        selection
    ):
        raise ValueError(
            f"{where}: selection {selection} cannot match the integer-"
            "indexed address space of this combinator's trace. Address "
            'lanes/steps explicitly — `Selection.at[..., "x"]` for every '
            'index or `Selection.at[i, "x"]` for one.'
        )


@Pytree.dataclass
class VmapTrace(Generic[R], Trace[R]):
    gen_fn: "Vmap[R]"
    inner: Trace[R]
    args: tuple
    score: Any
    chm: ChoiceMap
    dim_length: int = Pytree.static()

    @staticmethod
    def build(gen_fn: "Vmap[R]", tr: Trace[R], args: tuple, length: int) -> "VmapTrace[R]":
        score = jnp.sum(jax.vmap(lambda t: t.get_score())(tr))
        if length == 0:
            chm = ChoiceMap.empty()
        else:
            chm = jax.vmap(lambda t: t.get_choices())(tr)
        return VmapTrace(gen_fn, tr, args, score, chm, length)

    def get_args(self) -> tuple:
        return self.args

    def get_retval(self):
        return self.inner.get_retval()

    def get_gen_fn(self):
        return self.gen_fn

    def get_choices(self) -> ChoiceMap:
        return self.chm

    def get_score(self) -> Score:
        return self.score

    def get_inner_trace(self, address: Address):
        return self.inner.get_inner_trace(address)


@Pytree.dataclass
class Vmap(Generic[R], GenerativeFunction[R]):
    """Vectorize `gen_fn` over a leading batch axis configured by
    `in_axes` (a `jax.vmap`-style in-axes spec over the argument tuple)."""

    gen_fn: GenerativeFunction[R]
    in_axes: InAxes = Pytree.static()

    def __abstract_call__(self, *args) -> Any:
        return jax.vmap(self.gen_fn.__abstract_call__, in_axes=self.in_axes)(*args)

    @staticmethod
    def _static_broadcast_dim_length(in_axes: InAxes, args: tuple) -> int:
        # Validate against jax.vmap's own broadcasting rules:
        jax.vmap(lambda *_: None, in_axes=in_axes)(*args)
        if isinstance(in_axes, int):
            in_axes = (in_axes,) * len(args)
        elif isinstance(in_axes, list):
            in_axes = tuple(in_axes)

        def find_axis_size(axis, x):
            if axis is not None:
                leaf = jtu.tree_leaves(x)[0]
                return leaf.shape[axis]
            return None

        axis_sizes = jtu.tree_map(
            find_axis_size, in_axes, args, is_leaf=lambda x: x is None
        )
        return jtu.tree_leaves(axis_sizes)[0]

    # -- GFI -------------------------------------------------------------------

    def simulate(self, key: PRNGKey, args: tuple) -> VmapTrace[R]:
        n = self._static_broadcast_dim_length(self.in_axes, args)
        sub_keys = jax.random.split(key, n)
        tr = jax.vmap(self.gen_fn.simulate, (0, self.in_axes))(sub_keys, args)
        return VmapTrace.build(self, tr, args, n)

    def generate(
        self, key: PRNGKey, constraint: ChoiceMap, args: tuple
    ) -> tuple[VmapTrace[R], Weight]:
        n = self._static_broadcast_dim_length(self.in_axes, args)
        idxs = jnp.arange(n)
        sub_keys = jax.random.split(key, n)

        def _inner(key, idx, args):
            submap = constraint.get_submap(idx)
            return self.gen_fn.generate(key, submap, args)

        tr, ws = jax.vmap(_inner, in_axes=(0, 0, self.in_axes))(sub_keys, idxs, args)
        return VmapTrace.build(self, tr, args, n), jnp.sum(ws)

    def assess(self, sample: ChoiceMap, args: tuple) -> tuple[Score, R]:
        n = self._static_broadcast_dim_length(self.in_axes, args)
        idxs = jnp.arange(n)

        def _inner(idx, args):
            submap = sample.get_submap(idx)
            return self.gen_fn.assess(submap, args)

        scores, retvals = jax.vmap(_inner, in_axes=(0, self.in_axes))(idxs, args)
        return jnp.sum(scores), retvals

    def project(self, key: PRNGKey, trace: Trace[R], selection: Selection) -> Weight:
        assert isinstance(trace, VmapTrace)
        _check_indexable(selection, "Vmap.project")
        sub_keys = jax.random.split(key, trace.dim_length)
        idxs = jnp.arange(trace.dim_length)
        ws = jax.vmap(lambda k, i, t: t.project(k, selection(i)))(
            sub_keys, idxs, trace.inner
        )
        return jnp.sum(ws)

    # -- edit ------------------------------------------------------------------

    @staticmethod
    def _lane_rediff(argdiffs):
        """Re-wrap a lane's sliced primal args with the (static, lane-
        uniform) tangents of the incoming argdiffs, so a NoChange edit on
        a vmapped model stays NoChange per lane — the incremental plan
        recurses instead of recomputing every args-reading density."""
        tangents = Diff.tree_tangent(argdiffs)

        def rediff(args):
            try:
                return Diff.tree_diff(args, tangents)
            except Exception:
                return Diff.unknown_change(args)

        return rediff

    def edit_update(
        self,
        key: PRNGKey,
        trace: VmapTrace[R],
        constraint: ChoiceMap,
        argdiffs: Argdiffs,
    ) -> tuple[VmapTrace[R], Weight, Retdiff, EditRequest]:
        primals = Diff.tree_primal(argdiffs)
        n = trace.dim_length
        idxs = jnp.arange(n)
        sub_keys = jax.random.split(key, n)
        rediff = self._lane_rediff(argdiffs)

        def _edit(key, idx, subtrace, args):
            sub = constraint(idx)
            new_sub, w, rd, bwd = self.gen_fn.edit(
                key, subtrace, Update(sub), rediff(args)
            )
            assert isinstance(bwd, Update)
            return new_sub, w, Diff.tree_primal(rd), bwd.constraint

        new_subs, ws, retvals, bwd_chms = jax.vmap(
            _edit, in_axes=(0, 0, 0, self.in_axes)
        )(sub_keys, idxs, trace.inner, primals)
        map_tr = VmapTrace.build(self, new_subs, primals, n)
        return (
            map_tr,
            jnp.sum(ws),
            Diff.unknown_change(retvals),
            Update(bwd_chms),
        )

    def edit_regenerate(
        self,
        key: PRNGKey,
        trace: VmapTrace[R],
        selection: Selection,
        argdiffs: Argdiffs,
    ) -> tuple[VmapTrace[R], Weight, Retdiff, EditRequest]:
        from genjax_tpu.core.requests import Regenerate

        _check_indexable(selection, "Vmap.edit_regenerate")
        primals = Diff.tree_primal(argdiffs)
        n = trace.dim_length
        idxs = jnp.arange(n)
        sub_keys = jax.random.split(key, n)

        rediff = self._lane_rediff(argdiffs)

        def _edit(key, idx, subtrace, args):
            # Slice the selection per lane: a `VmapTrace`'s addresses nest
            # under the integer lane index (matching `get_choices()` and
            # `Scan`'s address space), so `S[i, "x"]` targets lane i only
            # and `S[..., "x"]` targets every lane.
            new_sub, w, rd, bwd = self.gen_fn.edit(
                key, subtrace, Regenerate(selection(idx)), rediff(args)
            )
            return new_sub, w, Diff.tree_primal(rd)

        new_subs, ws, retvals = jax.vmap(_edit, in_axes=(0, 0, 0, self.in_axes))(
            sub_keys, idxs, trace.inner, primals
        )
        map_tr = VmapTrace.build(self, new_subs, primals, n)
        return (
            map_tr,
            jnp.sum(ws),
            Diff.unknown_change(retvals),
            Regenerate(selection),
        )

    def edit_index(
        self,
        key: PRNGKey,
        trace: VmapTrace[R],
        idx: IntArray,
        request: EditRequest,
        argdiffs: Argdiffs,
    ) -> tuple[VmapTrace[R], Weight, Retdiff, EditRequest]:
        """O(1) slice-edit-scatter at a single batch index."""
        assert Diff.static_check_no_change(argdiffs)
        primals = Diff.tree_primal(argdiffs)
        n = trace.dim_length

        trace_slice = jtu.tree_map(lambda v: v[idx], trace.inner)

        def slice_axis(axis, x):
            if axis is None:
                return x
            return jtu.tree_map(lambda v: jnp.take(v, idx, axis=axis), x)

        in_axes = self.in_axes
        if isinstance(in_axes, int) or in_axes is None:
            in_axes = (in_axes,) * len(primals)
        primal_slice = tuple(
            slice_axis(ax, x)
            for ax, x in zip(in_axes, primals)
        )
        new_slice, w, rd, bwd = request.edit(
            key, trace_slice, Diff.no_change(primal_slice)
        )
        new_inner = jtu.tree_map(
            lambda v, v_: v.at[idx].set(v_), trace.inner, new_slice
        )
        map_tr = VmapTrace.build(self, new_inner, primals, n)
        retval = map_tr.get_retval()
        return (
            map_tr,
            w,
            Diff.unknown_change(retval),
            IndexRequest(idx, bwd),
        )

    def edit(
        self,
        key: PRNGKey,
        trace: Trace[R],
        edit_request: EditRequest,
        argdiffs: Argdiffs,
    ) -> tuple[VmapTrace[R], Weight, Retdiff, EditRequest]:
        from genjax_tpu.core.requests import Regenerate

        assert isinstance(trace, VmapTrace)
        match edit_request:
            case Update(constraint):
                return self.edit_update(key, trace, constraint, argdiffs)
            case Regenerate(selection):
                return self.edit_regenerate(key, trace, selection, argdiffs)
            case IndexRequest(idx, request):
                return self.edit_index(key, trace, idx, request, argdiffs)
            case _:
                raise NotSupportedEditRequest(edit_request)


def vmap(*, in_axes: InAxes = 0):
    """Decorator: `genjax_tpu.vmap(in_axes=...)(gen_fn)`."""

    def decorator(gen_fn: GenerativeFunction[R]) -> Vmap[R]:
        return Vmap(gen_fn, in_axes)

    return decorator
