"""Type aliases and static checks (reference `_src/core/typing.py:37-135`).

We deliberately keep this light: shape/dtype checking frameworks (jaxtyping,
beartype) add Python-side overhead on every call; on the accelerator path we instead
rely on JAX's own shape checking at trace time.
"""

import sys
from collections.abc import (  # noqa: F401 (re-export)
    Callable,
    Generator,
    Iterable,
    Sequence,
)
from types import EllipsisType  # noqa: F401 (re-export)
from typing import (  # noqa: F401 (re-export)
    Annotated,
    Any,
    Final,
    Generic,
    Literal,
    ParamSpec,
    TypeAlias,
    TypeVar,
)

if sys.version_info >= (3, 11):
    from typing import Self  # noqa: F401 (re-export)
else:  # pragma: no cover
    Self = TypeVar("Self")

import jax.core
import jax.numpy as jnp
import numpy as np
from jax import Array

ArrayLike: TypeAlias = Array | np.ndarray | int | float | bool
PRNGKey: TypeAlias = Array
IntArray: TypeAlias = int | Array
FloatArray: TypeAlias = float | Array
BoolArray: TypeAlias = bool | Array

#: A `Flag` is a Boolean value which may be a concrete Python `bool` (known at
#: trace time, enabling statically pruned branches) or a traced `BoolArray`.
Flag: TypeAlias = bool | Array
ScalarFlag: TypeAlias = bool | Array

InAxes: TypeAlias = int | None | Sequence[Any]

R = TypeVar("R")


class _IsValidator:
    """Predicate wrapper usable as `Annotated` metadata — the native
    stand-in for `beartype.vale.Is` (reference `_src/core/typing.py:30`;
    beartype is not a dependency of this build). Supports `&`/`|`/`~`
    composition like the original."""

    def __init__(self, predicate: Callable[[Any], bool]):
        self.predicate = predicate

    def __call__(self, value: Any) -> bool:
        return bool(self.predicate(value))

    def __and__(self, other: "_IsValidator") -> "_IsValidator":
        return _IsValidator(lambda v: self(v) and other(v))

    def __or__(self, other: "_IsValidator") -> "_IsValidator":
        return _IsValidator(lambda v: self(v) or other(v))

    def __invert__(self) -> "_IsValidator":
        return _IsValidator(lambda v: not self(v))


class Is:
    """`Is[predicate]` builds an `Annotated` validator (reference
    `beartype.vale.Is` usage, `_src/core/typing.py:61-63`)."""

    def __class_getitem__(cls, predicate) -> _IsValidator:
        return _IsValidator(predicate)


#: Validator: the annotated value must be scalar-shaped (reference
#: `_src/core/typing.py:61`).
ScalarShaped = Is[lambda arr: jnp.asarray(arr).shape == ()]
ScalarInt: TypeAlias = Annotated[IntArray, ScalarShaped]


def nobeartype(fn: Callable) -> Callable:
    """Exempt `fn` from the always-on public-API validation wrappers
    (reference `nobeartype` = beartype at strategy O0,
    `_src/core/typing.py:73`). Sets the same marker `core.typecheck`
    uses to skip already-wrapped callables."""
    fn.__gx_typechecked__ = True
    return fn


def static_check_is_concrete(x) -> bool:
    """True if `x` is not a JAX tracer."""
    return not isinstance(x, jax.core.Tracer)


def static_check_is_array(x) -> bool:
    return isinstance(x, (Array, np.ndarray)) or isinstance(x, (int, float, bool))


def static_check_supports_grad(v) -> bool:
    """True if `v` is a floating-point value (differentiable leaf)."""
    arr = jnp.asarray(v)
    return jnp.issubdtype(arr.dtype, jnp.floating)


def static_check_shape_dtype_equivalence(vs: list) -> bool:
    """True if every array in `vs` shares one (shape, dtype) (reference
    `_src/core/typing.py:99-102`)."""
    return len({(v.shape, v.dtype) for v in vs}) == 1
