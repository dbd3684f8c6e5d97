"""Staging utilities: concrete/traced Boolean algebra, structure-preserving
selects, zero-FLOP shape evaluation.

Capability parity with reference `_src/core/compiler/staging.py:55-347`
(`FlagOp`, `tree_choose`, `multi_switch`, `to_shape_fn`, `empty_trace`),
re-implemented for this build:

* `FlagOp.cond` / `FlagOp.where` statically prune branches when the flag is
  a concrete Python bool — this keeps XLA programs small and avoids
  `lax.cond` on an accelerator (where both branches are usually computed anyway; a
  `select` on results is the efficient accelerator pattern).
* `multi_switch` lets `lax.switch` run branches with different output
  shapes/dtypes by zero-padding each branch's result into a shared
  superstructure.
"""

import typing
from collections.abc import Callable, Iterable, Sequence
from typing import Any, TypeVar

import jax
import jax.numpy as jnp
import jax.tree_util as jtu

from genjax_tpu.core.typing import ArrayLike, Flag, static_check_is_concrete

R = TypeVar("R")
F = TypeVar("F", bound=Callable[..., Any])


class FlagOp:
    """Boolean algebra over `Flag` values (Python bools or traced arrays),
    with concrete short-circuiting."""

    @staticmethod
    def is_scalar(f: Flag) -> bool:
        return isinstance(f, bool) or jnp.shape(f) == ()

    @staticmethod
    def and_(f: Flag, g: Flag) -> Flag:
        if isinstance(f, bool) and isinstance(g, bool):
            return f and g
        return jnp.logical_and(f, g)

    @staticmethod
    def or_(f: Flag, g: Flag) -> Flag:
        if isinstance(f, bool) and isinstance(g, bool):
            return f or g
        return jnp.logical_or(f, g)

    @staticmethod
    def xor_(f: Flag, g: Flag) -> Flag:
        if isinstance(f, bool) and isinstance(g, bool):
            return f ^ g
        return jnp.logical_xor(f, g)

    @staticmethod
    def not_(f: Flag) -> Flag:
        if f is True:
            return False
        if f is False:
            return True
        return jnp.logical_not(f)

    @staticmethod
    def concrete_true(f: Flag) -> bool:
        return f is True

    @staticmethod
    def concrete_false(f: Flag) -> bool:
        return f is False

    @staticmethod
    def where(f: Flag, tf: ArrayLike, ff: ArrayLike) -> ArrayLike:
        """`tf` if flag else `ff`, statically pruned for concrete flags."""
        if f is True:
            return tf
        if f is False:
            return ff
        return jax.lax.select(
            jnp.broadcast_to(f, jnp.shape(tf)) if jnp.shape(f) != jnp.shape(tf) else f,
            jnp.asarray(tf),
            jnp.asarray(ff),
        )

    @staticmethod
    def cond(f: Flag, tf: Callable[..., R], ff: Callable[..., R], *args: Any) -> R:
        """Invoke `tf(*args)` if flag else `ff(*args)`; statically pruned
        for concrete flags, `lax.cond` otherwise."""
        if f is True:
            return tf(*args)
        if f is False:
            return ff(*args)
        return jax.lax.cond(f, tf, ff, *args)


def staged_check(v) -> bool:
    return static_check_is_concrete(v) and bool(v)


def tree_choose(idx: ArrayLike, pytrees: Sequence[R]) -> R:
    """Select one pytree out of `pytrees` by index.

    Acts like `pytrees[idx]` when `idx` is a concrete int (zero FLOPs);
    otherwise lowers to a leaf-wise `jnp.choose(mode="wrap")`, the standard
    accelerator-friendly way to combine pre-computed branch outputs.

    >>> import jax.numpy as jnp
    >>> from genjax_tpu.core.staging import tree_choose
    >>> picked = tree_choose(jnp.asarray(1), [(1.0, 10.0), (2.0, 20.0)])
    >>> (float(picked[0]), float(picked[1]))
    (2.0, 20.0)
    """
    pytrees = list(pytrees)

    def inner(*vs: ArrayLike) -> ArrayLike:
        result = jnp.choose(idx, vs, mode="wrap")
        if isinstance(idx, int):
            return jnp.asarray(vs[idx % len(vs)], dtype=result.dtype)
        return result

    return jtu.tree_map(inner, *pytrees)


def where_tree(flag: ArrayLike, on_true: R, on_false: R) -> R:
    """Leaf-wise `jnp.where(flag, a, b)` over two same-structure pytrees,
    skipping leaves that are the SAME tracer on both sides.

    The identity shortcut is what makes dense accept/reject selects cheap
    on batched traces: leaves an edit passed through untouched (shared
    model args, unedited subtraces) generate no select and no copy.

    >>> import jax.numpy as jnp
    >>> from genjax_tpu.core.staging import where_tree
    >>> shared = jnp.arange(3.0)
    >>> out = where_tree(True, {"a": 1.0, "s": shared}, {"a": 2.0, "s": shared})
    >>> (float(out["a"]), out["s"] is shared)
    (1.0, True)
    """
    return jtu.tree_map(
        lambda a, b: a if a is b else jnp.where(flag, a, b),
        on_true,
        on_false,
    )


def to_shape_fn(
    callable: F,
    fill_fn: Callable[..., Any] | None = None,
) -> F:
    """Convert `callable` into a zero-FLOP version returning its output
    structure — as `ShapeDtypeStruct`s, or filled via `fill_fn(shape, dtype)`
    (reference `staging.py:301-331`)."""

    def wrapped(*args, **kwargs):
        shape = jax.eval_shape(callable, *args, **kwargs)
        if fill_fn is not None:
            f = fill_fn
            return jtu.tree_map(lambda x: f(x.shape, x.dtype), shape)
        return shape

    return typing.cast(F, wrapped)


def multi_switch(
    idx,
    branches: Iterable[Callable[..., Any]],
    arg_tuples: Iterable[tuple[Any, ...]],
):
    """`lax.switch` across branches with different return structures.

    Each branch's result is scattered into a list of zero-filled templates
    (one per branch, each with that branch's exact output structure), so the
    switch's carried value has a single fixed structure. The caller then
    extracts the entry it needs (typically via `tree_choose`).

    Reference semantics: `staging.py:221-264`. Out-of-range `idx` is clamped
    by `lax.switch`.
    """

    def _make_setter(static_idx: int, f: Callable[..., Any], args: tuple[Any, ...]):
        def set_result(shapes: list[Any]) -> list[Any]:
            shapes = list(shapes)
            shapes[static_idx] = f(*args)
            return shapes

        return set_result

    pairs = list(zip(branches, arg_tuples))
    shapes = [to_shape_fn(f, jnp.zeros)(*args) for f, args in pairs]
    fns = [_make_setter(i, f, args) for i, (f, args) in enumerate(pairs)]
    return jax.lax.switch(idx, fns, operand=shapes)


def stage(f: Callable[..., Any]):
    """Stage a Python callable to a `ClosedJaxpr` plus in/out tree metadata.

    Used by the ADEV transform (which needs eqn-level access to embed
    continuation-passing gradient strategies); the GFI hot paths in this
    framework do NOT go through jaxpr interpretation — they are direct JAX
    programs (see `genjax_tpu/lang/static.py`).
    """

    def wrapped(*args):
        closed_jaxpr, out_shape = jax.make_jaxpr(f, return_shape=True)(*args)
        flat_args, in_tree = jtu.tree_flatten(args)
        out_tree = jtu.tree_structure(out_shape)
        return closed_jaxpr, (flat_args, in_tree, lambda: out_tree)

    return wrapped


def get_shaped_aval(x):
    return jax.core.get_aval(x)


def empty_trace(gen_fn, args) -> Any:
    """Create a zero-filled trace skeleton for `gen_fn(args)` without
    spending FLOPs (reference `staging.py:332-347`)."""
    key = jax.eval_shape(lambda: jax.random.key(0))

    def run(k):
        return gen_fn.simulate(k, args)

    shape = jax.eval_shape(run, key)
    return jtu.tree_map(lambda x: jnp.zeros(x.shape, x.dtype), shape)
