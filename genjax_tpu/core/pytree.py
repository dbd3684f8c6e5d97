"""Pytree foundation for genjax_tpu.

This module provides the dataclass-based `Pytree` base type that every
structured value in the framework derives from: traces, choice maps,
selections, masks, generative functions, edit requests, particle
collections.

Accelerator-first design notes
------------------------------
The reference framework (genjax `_src/core/pytree.py:40-376`) builds on
penzai's ``pz.Struct``.  Here we register dataclasses directly with JAX's
pytree machinery via ``jax.tree_util.register_pytree_with_keys``, which:

* keeps every library type a *flat* pytree of arrays + static treedef
  metadata (what `jit`/`vmap`/`shard_map` want);
* makes static fields (declared with ``Pytree.static()``) part of the
  treedef, so they act as compile-time constants and trigger retracing
  when they change;
* has zero runtime dependencies beyond JAX itself.

Capability parity with the reference: `Pytree.dataclass`, `Pytree.static`,
`Pytree.field`, `Const`, `Closure`, `nth`, `PythonicPytree`
(reference `pytree.py:73-376`).
"""

import dataclasses
import types
from collections.abc import Callable
from typing import Any, Generic, TypeVar

import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np

R = TypeVar("R")
T = TypeVar("T")
C = TypeVar("C", bound=type)

_STATIC_MARK = "genjax_tpu_static"


def _is_static_field(f: dataclasses.Field) -> bool:
    return bool(f.metadata.get(_STATIC_MARK, False))


class _HashableWrapper:
    """Wraps unhashable static values (dicts, lists, arrays) so they can live
    in a treedef. Equality is structural."""

    __slots__ = ("val",)

    def __init__(self, val):
        self.val = val

    def __eq__(self, other):
        if not isinstance(other, _HashableWrapper):
            return NotImplemented
        return _static_eq(self.val, other.val)

    def __hash__(self):
        return hash(_static_freeze(self.val))

    def __repr__(self):
        return f"_HashableWrapper({self.val!r})"


class _FnWrapper:
    """Treedef-resident wrapper for static FUNCTION fields.

    Two function objects produced by re-executing the same source line
    (in-body `@gen`, `mix(...)`, `partial_apply`, dimap lambdas) compare
    EQUAL when their code, globals dict, defaults, and closure cell
    contents agree. Without this, every re-trace of a model that builds
    a callee inside its body would mint a fresh function identity in the
    treedef — and `edit` would return a trace whose treedef differs from
    its input's, breaking every accept/reject select, `lax.cond` branch
    pairing, and scan carry over traces (`where_tree` requires
    treedef-equal operands)."""

    __slots__ = ("fn",)

    def __init__(self, fn):
        self.fn = fn

    def __eq__(self, other):
        if not isinstance(other, _FnWrapper):
            return NotImplemented
        return _fn_eq(self.fn, other.fn)

    def __hash__(self):
        fn = self.fn
        if isinstance(fn, types.MethodType):
            fn = fn.__func__
        return hash(getattr(fn, "__code__", fn))

    def __repr__(self):
        return f"_FnWrapper({self.fn!r})"


def _fn_eq(a, b) -> bool:
    if a is b:
        return True
    if isinstance(a, types.MethodType) and isinstance(b, types.MethodType):
        return _fn_eq(a.__func__, b.__func__) and _static_eq(
            a.__self__, b.__self__
        )
    if not (
        isinstance(a, types.FunctionType) and isinstance(b, types.FunctionType)
    ):
        return a is b
    if a.__code__ is not b.__code__:
        return False
    if a.__globals__ is not b.__globals__:
        return False
    if not _static_eq(a.__defaults__, b.__defaults__):
        return False
    if not _static_eq(a.__kwdefaults__, b.__kwdefaults__):
        return False
    ca, cb = a.__closure__ or (), b.__closure__ or ()
    if len(ca) != len(cb):
        return False
    try:
        return all(
            _static_eq(x.cell_contents, y.cell_contents)
            for x, y in zip(ca, cb)
        )
    except ValueError:  # empty cell
        return False


def _static_freeze(v):
    if isinstance(v, (types.FunctionType, types.MethodType)):
        fn = v.__func__ if isinstance(v, types.MethodType) else v
        return ("__fn__", getattr(fn, "__code__", fn))
    if isinstance(v, dict):
        return ("__dict__", tuple(sorted(((k, _static_freeze(x)) for k, x in v.items()), key=lambda kv: repr(kv[0]))))
    if isinstance(v, (list, tuple)):
        return ("__seq__", tuple(_static_freeze(x) for x in v))
    if isinstance(v, (np.ndarray, jnp.ndarray)):
        return ("__arr__", v.shape, str(v.dtype))
    try:
        hash(v)
        return v
    except TypeError:
        return repr(v)


def _static_eq(a, b) -> bool:
    if a is b:
        return True
    if isinstance(a, (types.FunctionType, types.MethodType)) and isinstance(
        b, (types.FunctionType, types.MethodType)
    ):
        return _fn_eq(a, b)
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_static_eq(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_static_eq(x, y) for x, y in zip(a, b))
    if isinstance(a, Pytree) and isinstance(b, Pytree):
        # Structural comparison, recursing through the fn-aware treedef
        # equality (closure cells routinely hold generative functions).
        la, ta = jtu.tree_flatten(a)
        lb, tb = jtu.tree_flatten(b)
        return (
            ta == tb
            and len(la) == len(lb)
            and all(_static_eq(x, y) for x, y in zip(la, lb))
        )
    try:
        return bool(a == b)
    except Exception:
        return a is b


def _wrap_static(v):
    if isinstance(v, (types.FunctionType, types.MethodType)):
        return _FnWrapper(v)
    try:
        hash(v)
        return v
    except TypeError:
        return _HashableWrapper(v)


def _unwrap_static(v):
    if isinstance(v, _HashableWrapper):
        return v.val
    if isinstance(v, _FnWrapper):
        return v.fn
    return v


class Pytree:
    """Abstract base class that registers subclasses with JAX's pytree system.

    Subclasses are declared with the :func:`Pytree.dataclass` decorator::

        @Pytree.dataclass
        class MyThing(Pytree):
            dynamic_leaf: Any                       # traced, flattened
            config: int = Pytree.static()           # compile-time constant

    Static fields become part of the treedef; dynamic fields are pytree
    children and participate in `jit`/`vmap`/`grad`/`shard_map`.
    """

    @staticmethod
    def dataclass(cls: C | None = None, /, *, match_args: bool = True, init: bool = True, eq: bool = False) -> C:
        def wrap(kls):
            dkls = dataclasses.dataclass(
                kls, match_args=match_args, init=init, eq=False, repr=False, frozen=False
            )
            fields = dataclasses.fields(dkls)
            dyn_names = tuple(f.name for f in fields if not _is_static_field(f))
            static_names = tuple(f.name for f in fields if _is_static_field(f))

            def flatten_with_keys(obj):
                dyn = tuple(
                    (jtu.GetAttrKey(name), getattr(obj, name)) for name in dyn_names
                )
                static = tuple(_wrap_static(getattr(obj, name)) for name in static_names)
                return dyn, static

            def flatten(obj):
                dyn = tuple(getattr(obj, name) for name in dyn_names)
                static = tuple(_wrap_static(getattr(obj, name)) for name in static_names)
                return dyn, static

            def unflatten(static, dyn):
                obj = object.__new__(dkls)
                for name, val in zip(dyn_names, dyn):
                    object.__setattr__(obj, name, val)
                for name, val in zip(static_names, static):
                    object.__setattr__(obj, name, _unwrap_static(val))
                return obj

            jtu.register_pytree_with_keys(dkls, flatten_with_keys, unflatten, flatten)
            dkls.__pytree_dyn_fields__ = dyn_names
            dkls.__pytree_static_fields__ = static_names
            return dkls

        if cls is None:
            return wrap  # type: ignore[return-value]
        return wrap(cls)

    @staticmethod
    def static(**kwargs) -> Any:
        """Declare a static (treedef-resident, compile-time) dataclass field."""
        md = dict(kwargs.pop("metadata", {}) or {})
        md[_STATIC_MARK] = True
        return dataclasses.field(metadata=md, **kwargs)

    @staticmethod
    def field(**kwargs) -> Any:
        """Declare a dynamic (traced) dataclass field."""
        return dataclasses.field(**kwargs)

    # -- constructors for auxiliary types ---------------------------------

    @staticmethod
    def const(v: T) -> "Const[T]":
        """Wrap `v` as a static constant that can flow through traced code."""
        if isinstance(v, Const):
            return v
        return Const(v)

    @staticmethod
    def tree_const(v):
        """Wrap all leaves of `v` in `Const`."""
        return jtu.tree_map(
            lambda x: x if isinstance(x, Const) else Const(x),
            v,
            is_leaf=lambda x: isinstance(x, Const),
        )

    @staticmethod
    def tree_const_unwrap(v):
        """Unwrap all `Const` leaves of `v`."""
        return jtu.tree_map(
            lambda x: x.const if isinstance(x, Const) else x,
            v,
            is_leaf=lambda x: isinstance(x, Const),
        )

    @staticmethod
    def partial(*partial_args) -> Callable[[Callable[..., R]], "Closure[R]"]:
        """Decorator building a JAX-compatible `Closure` with the given
        dynamic arguments pre-applied."""

        def decorator(fn: Callable[..., R]) -> Closure[R]:
            return Closure(partial_args, fn)

        return decorator

    # -- generic niceties ---------------------------------------------------

    def __repr__(self) -> str:
        cls = type(self)
        parts = []
        for f in dataclasses.fields(cls):  # type: ignore[arg-type]
            v = getattr(self, f.name)
            parts.append(f"{f.name}={v!r}")
        return f"{cls.__name__}({', '.join(parts)})"

    def __eq__(self, other) -> bool:
        if type(self) is not type(other):
            return NotImplemented
        leaves1, treedef1 = jtu.tree_flatten(self)
        leaves2, treedef2 = jtu.tree_flatten(other)
        if treedef1 != treedef2:
            return False
        try:
            return all(bool(np.array_equal(a, b)) for a, b in zip(leaves1, leaves2))
        except Exception:
            return all(a is b for a, b in zip(leaves1, leaves2))

    def __hash__(self):
        leaves, treedef = jtu.tree_flatten(self)
        return hash((treedef, tuple(_static_freeze(leaf) for leaf in leaves)))

    # -- rendering ----------------------------------------------------------

    def treescope_color(self) -> str:
        return "#AA4A44"

    def render_html(self):
        try:
            import treescope

            with treescope.using_expansion_strategy(max_height=None):
                return treescope.render_to_html(self, compressed=True)
        except ImportError:  # pragma: no cover
            return repr(self)


@Pytree.dataclass
class Const(Generic[T], Pytree):
    """JAX-compatible wrapper for a static value.

    Allows passing a compile-time constant through traced code without it
    being lifted to a tracer (reference `pytree.py:234-295`).

    >>> import jax
    >>> from genjax_tpu.core.pytree import Const
    >>> @jax.jit
    ... def f(n):
    ...     return jax.numpy.zeros(n.unwrap())  # static shape through jit
    >>> f(Const(3)).shape
    (3,)
    """

    const: Any = Pytree.static()

    def __call__(self, *args, **kwargs):
        return self.const(*args, **kwargs)

    def unwrap(self) -> Any:
        return self.const

    @staticmethod
    def unwrap_value(v):
        """`Const.unwrap(v)`-style helper: unwrap if Const, else identity."""
        if isinstance(v, Const):
            return v.const
        return v


# Mirror reference API: `Const.unwrap` used as a static method on possibly-
# wrapped values in some call sites.
def const_unwrap(v):
    return Const.unwrap_value(v)


@Pytree.dataclass
class Closure(Generic[R], Pytree):
    """A JAX-compatible closure: dynamic (traced) partial arguments plus a
    static function (reference `pytree.py:300-335`)."""

    dyn_args: tuple
    fn: Callable[..., Any] = Pytree.static()

    def __call__(self, *args, **kwargs):
        return self.fn(*self.dyn_args, *args, **kwargs)


def nth(x: Any, idx) -> Any:
    """Index into every leaf of the pytree `x` (reference `pytree.py:337`)."""
    return jtu.tree_map(lambda v: v[idx], x)


class PythonicPytree(Pytree):
    """Pytree base mixin providing `__getitem__`/`__len__`/concatenation
    sugar (reference `pytree.py:342-376`)."""

    def __getitem__(self, idx):
        return nth(self, idx)

    def __len__(self) -> int:
        leaves = jtu.tree_leaves(self)
        if not leaves:
            return 0
        return len(leaves[0])

    def __add__(self, other):
        return jtu.tree_map(lambda a, b: jnp.concatenate([a, b]), self, other)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
