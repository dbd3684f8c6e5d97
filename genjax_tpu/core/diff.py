"""Change-tracking (`Diff`) values for the `edit` interface.

Capability parity with reference
`_src/core/compiler/interpreters/incremental.py:57-310` (`ChangeTangent`,
`NoChange`, `UnknownChange`, `Diff` and its tree helpers).

Accelerator-first design note
-----------------------------
The reference propagates `Diff` values through model code with a custom
jaxpr interpreter, so that `edit` can statically skip recomputation at
unchanged addresses. On an accelerator, branch-avoidance of that kind buys little: the
efficient pattern is dense recomputation fused by XLA, with *static*
(trace-time) short-circuits where a change is provably absent. Accordingly,
`Diff` here is a trace-time annotation type used:

* at the GFI boundary (`Argdiffs` / `Retdiff` in `edit` signatures),
* for static short-circuits (`Diff.static_check_no_change`),

and the `edit` implementations recompute densities densely (exact same
weight math — `logpdf(v, new_args) - old_score` is identically zero when
arguments are unchanged).
"""

from typing import Any

import jax.tree_util as jtu

from genjax_tpu.core.pytree import Pytree


class ChangeTangent(Pytree):
    """Base class for change tangents attached to `Diff` values."""

    def __repr__(self):
        return type(self).__name__


@Pytree.dataclass
class _UnknownChange(ChangeTangent):
    pass


@Pytree.dataclass
class _NoChange(ChangeTangent):
    pass


UnknownChange = _UnknownChange()
NoChange = _NoChange()


@Pytree.dataclass(match_args=True)
class Diff(Pytree):
    """A value paired with a change tangent (`NoChange` or `UnknownChange`).

    >>> from genjax_tpu.core.diff import Diff
    >>> argdiffs = Diff.no_change((1.0, 2.0))
    >>> Diff.static_check_no_change(argdiffs)
    True
    >>> Diff.tree_primal(Diff.unknown_change((1.0, 2.0)))
    (1.0, 2.0)
    """

    primal: Any
    tangent: ChangeTangent = Pytree.static(default=UnknownChange)

    def get_primal(self) -> Any:
        return self.primal

    def get_tangent(self) -> ChangeTangent:
        return self.tangent

    # -- constructors -------------------------------------------------------

    @staticmethod
    def unknown_change(v) -> Any:
        """Wrap all leaves of `v` as changed."""
        return jtu.tree_map(
            lambda x: Diff(Diff.tree_primal(x), UnknownChange),
            v,
            is_leaf=lambda x: isinstance(x, Diff),
        )

    @staticmethod
    def no_change(v) -> Any:
        """Wrap all leaves of `v` as unchanged."""
        return jtu.tree_map(
            lambda x: Diff(Diff.tree_primal(x), NoChange),
            v,
            is_leaf=lambda x: isinstance(x, Diff),
        )

    @staticmethod
    def tree_diff(primal_tree, tangent_tree) -> Any:
        """Pair a primal tree with a tangent tree of `ChangeTangent`s."""
        return jtu.tree_map(
            lambda p, t: Diff(p, t),
            primal_tree,
            tangent_tree,
            is_leaf=lambda x: isinstance(x, Diff),
        )

    # -- accessors -----------------------------------------------------------

    @staticmethod
    def tree_primal(v) -> Any:
        def inner(x):
            if isinstance(x, Diff):
                return x.primal
            return x

        return jtu.tree_map(inner, v, is_leaf=lambda x: isinstance(x, Diff))

    @staticmethod
    def tree_tangent(v) -> Any:
        def inner(x):
            if isinstance(x, Diff):
                return x.tangent
            return UnknownChange

        return jtu.tree_map(inner, v, is_leaf=lambda x: isinstance(x, Diff))

    # -- static checks -------------------------------------------------------

    @staticmethod
    def static_check_tree_diff(v) -> bool:
        """True if all leaves of `v` are `Diff` instances."""
        return all(
            isinstance(leaf, Diff)
            for leaf in jtu.tree_leaves(v, is_leaf=lambda x: isinstance(x, Diff))
        )

    @staticmethod
    def static_check_no_change(v) -> bool:
        """True if every `Diff` leaf in `v` carries `NoChange`."""
        return all(
            leaf.tangent is NoChange
            for leaf in jtu.tree_leaves(v, is_leaf=lambda x: isinstance(x, Diff))
            if isinstance(leaf, Diff)
        )


def incremental(fn):
    """Coarse-grained change propagation: run `fn` on the primals of
    Diff-valued arguments and tag the outputs `NoChange` iff *all* inputs
    were `NoChange` (the reference's default propagation rule,
    `incremental.py:300-307`, applied at whole-function granularity —
    this build recomputes densely instead of interpreting jaxprs; see
    ARCHITECTURE.md).

    Signature matches the reference: `incremental(fn)(handler, primals,
    tangents)`; the handler slot is accepted for compatibility and
    ignored (no equation interception happens here).
    """

    def wrapped(_handler, primals, tangents):
        diffs = Diff.tree_diff(primals, tangents)
        out = fn(*primals)
        if Diff.static_check_no_change(diffs):
            return Diff.no_change(out)
        return Diff.unknown_change(out)

    return wrapped
