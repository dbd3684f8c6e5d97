"""`Mask`: a sum type for possibly-invalid values.

Capability parity with reference
`_src/core/generative/functional_types.py` (construction/validation,
`build`, `maybe_mask`, `flatten`, `unmask`, `primal_flag`, indexing, and the
`or`/`xor`/`invert` combinator algebra, including vectorized flags). The
implementation here is an independent derivation from that semantic spec.

Representation: a pytree `value` paired with a Boolean `flag` whose shape is
either scalar or a *leading-axes prefix* of every value leaf. This dense
layout is what vectorization produces naturally — `vmap`/`scan` prepend batch
dimensions to both halves — and it keeps all mask algebra as elementwise
selects on contiguous arrays, which XLA fuses for free on an accelerator. Combination
(`|`, `^`) is implemented as a single broadcast-select over the pair of
values (no branch dispatch, no gather): the left value wins wherever its flag
is set, and only the flag arithmetic differs between the two operators.
"""

from typing import Generic, TypeVar

import jax.numpy as jnp
import jax.tree_util as jtu
from jax import Array
from jax.experimental import checkify

from genjax_tpu.core.checkify import optional_check
from genjax_tpu.core.diff import Diff
from genjax_tpu.core.pytree import Pytree
from genjax_tpu.core.staging import FlagOp
from genjax_tpu.core.typing import Flag

R = TypeVar("R")


def _strip_diff(flag: Flag | Diff) -> Flag:
    """Primal Boolean of a flag that may carry a change tangent."""
    return flag.get_primal() if isinstance(flag, Diff) else flag


def _select_leaves(flag: Flag, on_true: R, on_false: R) -> R:
    """Pick `on_true` leaves where `flag` holds, else `on_false`.

    The flag indexes leading axes only, so each leaf sees the flag expanded
    with trailing singleton dims — one fused `where` per leaf, no reshuffling.
    """
    rank = jnp.ndim(flag)

    def pick(a, b):
        f = jnp.reshape(flag, jnp.shape(flag) + (1,) * (jnp.ndim(a) - rank))
        return jnp.where(f, a, b)

    return jtu.tree_map(pick, on_true, on_false)


@Pytree.dataclass(match_args=True, init=False)
class Mask(Generic[R], Pytree):
    """Wraps a value in a Boolean validity flag.

    A `Mask` with a `False` flag denotes data that must not participate in
    inference computations. A non-scalar flag denotes a vectorized mask: the
    flag's shape must be a prefix of every leaf's shape.

    >>> import jax.numpy as jnp
    >>> from genjax_tpu import Mask
    >>> m = Mask(3.0, jnp.asarray(True))
    >>> float(m.unmask())
    3.0
    >>> invalid = Mask(9.0, jnp.asarray(False))
    >>> float(invalid.unmask(default=-1.0))
    -1.0

    `|` keeps the left operand where it is valid:

    >>> merged = invalid | m
    >>> float(merged.unmask()), bool(merged.primal_flag())
    (3.0, True)
    """

    value: R
    flag: Flag | Diff

    def __init__(self, value: R, flag: Flag | Diff = True) -> None:
        assert not isinstance(value, Mask), (
            "Refusing to nest a Mask directly inside a Mask; "
            "compose flags with Mask.build instead."
        )
        Mask._check_flag_covers(value, flag)
        object.__setattr__(self, "value", value)
        object.__setattr__(self, "flag", flag)

    @staticmethod
    def _check_flag_covers(value: R, flag: Flag | Diff) -> None:
        """A non-scalar flag must address leading axes present on every leaf."""
        f_shape = jnp.shape(_strip_diff(flag))
        if not f_shape:
            return
        bad = [
            jnp.shape(leaf)
            for leaf in jtu.tree_leaves(value)
            if jnp.shape(leaf)[: len(f_shape)] != f_shape
        ]
        if bad:
            raise ValueError(
                f"Vectorized mask flag of shape {f_shape} does not cover the "
                f"leading axes of every value leaf (offending leaf shapes: "
                f"{bad})."
            )

    def _check_combinable(self, other: "Mask[R]") -> None:
        """`|`/`^` require identical tree structure and leaf shapes."""
        if jtu.tree_structure(self.value) != jtu.tree_structure(other.value):
            raise ValueError(
                "Mask combination requires operands with identical pytree "
                "structure."
            )
        mismatched = [
            (jnp.shape(a), jnp.shape(b))
            for a, b in zip(
                jtu.tree_leaves(self.value), jtu.tree_leaves(other.value)
            )
            if jnp.shape(a) != jnp.shape(b)
        ]
        if mismatched:
            raise ValueError(
                f"Mask combination requires matching leaf shapes; "
                f"found mismatches {mismatched}."
            )

    # -- constructors -------------------------------------------------------

    @staticmethod
    def build(v: "R | Mask[R]", f: Flag | Diff = True) -> "Mask[R]":
        """Build a Mask; if `v` is already a Mask, flags combine by AND."""
        if not isinstance(v, Mask):
            return Mask(v, f)
        inner = v.flag
        assert not isinstance(f, Diff) and not isinstance(inner, Diff)
        assert FlagOp.is_scalar(f) or jnp.shape(f) == jnp.shape(inner), (
            f"Cannot conjoin a flag of shape {jnp.shape(f)} onto a Mask whose "
            f"own flag has shape {jnp.shape(inner)}; shapes must agree "
            f"(or the new flag must be scalar)."
        )
        return Mask(v.value, FlagOp.and_(f, inner))

    @staticmethod
    def maybe_mask(v: "R | Mask[R]", f: Flag) -> "R | Mask[R] | None":
        """Like `build`, but returns the raw value (concrete True flag) or
        None (concrete False flag) where statically possible."""
        built = Mask.build(v, f)
        return built.flatten()

    # -- accessors -----------------------------------------------------------

    def __getitem__(self, path) -> "Mask[R]":
        if not isinstance(path, tuple):
            path = (path,)
        flag = self.primal_flag()
        if isinstance(flag, Array) and flag.ndim:
            # The flag only spans leading axes; consume the matching prefix
            # of the path and leave the rest to the value leaves.
            flag = flag[path[: flag.ndim]]
        # Scalar leaves have no axis for the path to consume: they are
        # shared across the indexed axis and pass through unchanged.
        sliced = jtu.tree_map(
            lambda leaf: leaf[path] if jnp.ndim(leaf) >= 1 else leaf,
            self.value,
        )
        if isinstance(self.flag, Diff):
            flag = Diff(flag, self.flag.tangent)
        return Mask.build(sliced, flag)

    def flatten(self) -> "R | Mask[R] | None":
        flag = self.primal_flag()
        if FlagOp.concrete_false(flag):
            return None
        if FlagOp.concrete_true(flag):
            return self.value
        return self

    def unmask(self, default: R | None = None) -> R:
        """Extract the value. Unsafe without `default` unless the flag is
        valid at runtime (checked only inside `do_checkify()`)."""
        if default is not None:
            return _select_leaves(self.primal_flag(), self.value, default)

        def _check():
            checkify.check(
                jnp.all(self.primal_flag()),
                "Mask.unmask() without a default, but the flag (or some "
                "entry of a vectorized flag) is False at runtime — the "
                "extracted value is not meaningful.\n",
            )

        optional_check(_check)
        return self.value

    def primal_flag(self) -> Flag:
        return _strip_diff(self.flag)

    # -- combinators ----------------------------------------------------------

    def __or__(self, other: "Mask[R]") -> "Mask[R]":
        """Left-biased union: keep `self` where valid, else `other`."""
        self._check_combinable(other)
        f1, f2 = self.primal_flag(), other.primal_flag()
        if FlagOp.concrete_true(f1):
            return self
        if FlagOp.concrete_false(f1):
            return other
        return Mask(_select_leaves(f1, self.value, other.value), FlagOp.or_(f1, f2))

    def __xor__(self, other: "Mask[R]") -> "Mask[R]":
        """Exclusive union: valid iff exactly one operand is; keeps that one."""
        self._check_combinable(other)
        f1, f2 = self.primal_flag(), other.primal_flag()
        if FlagOp.concrete_true(f1) and FlagOp.concrete_false(f2):
            return self
        if FlagOp.concrete_false(f1) and FlagOp.concrete_true(f2):
            return other
        if all(
            FlagOp.concrete_true(f) or FlagOp.concrete_false(f) for f in (f1, f2)
        ):
            # Statically both-valid or both-invalid: a definitely-dead mask.
            return Mask.build(self, False)
        # Where exactly one flag holds, the select below picks the valid
        # operand; where both or neither hold the result flag is False and
        # the value slot is don't-care.
        return Mask(
            _select_leaves(f1, self.value, other.value), FlagOp.xor_(f1, f2)
        )

    def __invert__(self) -> "Mask[R]":
        return Mask(self.value, jtu.tree_map(FlagOp.not_, self.flag))

    @staticmethod
    def or_n(mask: "Mask[R]", *masks: "Mask[R]") -> "Mask[R]":
        acc = mask
        for m in masks:
            acc = acc | m
        return acc

    @staticmethod
    def xor_n(mask: "Mask[R]", *masks: "Mask[R]") -> "Mask[R]":
        acc = mask
        for m in masks:
            acc = acc ^ m
        return acc
