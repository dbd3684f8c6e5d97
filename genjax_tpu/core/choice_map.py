"""Addressed sample storage: `ChoiceMap` and the `Selection` address algebra.

Capability parity with reference `_src/core/generative/choice_map.py`
(1786 LoC): the full Selection algebra (all/none/leaf/complement/static-
prefix/and/or/wildcard `...`/choicemap-derived), the ChoiceMap node types
(`Choice`, `Indexed`, `Static`, `Switch`, `Or`), builders (`C["x"].set(v)`),
constructors (`choice/entry/from_mapping/d/kw/switch`), combinators
(`filter`, `mask`, `extend`, `merge`, `|`, `&`, `+`), dynamic integer-array
addressing, and `invalid_subset` support detection.

Accelerator-first design notes
------------------------------
* All leaf storage is dense arrays; dynamic-address access lowers to
  gathers + `Mask` flags (never data-dependent control flow).
* Vectorized choice maps are ordinary `Static` tries whose leaves carry
  batch dimensions (produced by `vmap`-ing trace construction); per-index
  lookup is a leaf-wise gather.
* The trie structure itself is static metadata (dict keys live in the
  treedef), so address resolution costs nothing at runtime.
"""

from collections.abc import Iterable
from dataclasses import dataclass
from types import EllipsisType
from typing import Any, Generic, TypeVar

import jax.numpy as jnp
import jax.tree_util as jtu
from jax import Array

from genjax_tpu.core.mask import Mask
from genjax_tpu.core.pytree import Pytree
from genjax_tpu.core.staging import FlagOp
from genjax_tpu.core.typing import Flag, IntArray, static_check_is_concrete

T = TypeVar("T")
K_addr = TypeVar("K_addr")

# -- address vocabulary ------------------------------------------------------

StaticAddressComponent = str
DynamicAddressComponent = int | slice | Array
AddressComponent = DynamicAddressComponent | StaticAddressComponent
Address = tuple[AddressComponent, ...] | AddressComponent
StaticAddress = tuple[StaticAddressComponent, ...] | StaticAddressComponent
ExtendedStaticAddressComponent = EllipsisType | StaticAddressComponent
ExtendedStaticAddress = (
    tuple[ExtendedStaticAddressComponent, ...] | ExtendedStaticAddressComponent
)

_full_slice = slice(None)


def _tuplize(addr) -> tuple:
    """Wrap a lone address component into a 1-tuple path."""
    return addr if isinstance(addr, tuple) else (addr,)


def _is_scalar_component(comp) -> bool:
    return isinstance(comp, int) or (isinstance(comp, Array) and comp.ndim == 0)


def _is_full_slice(comp) -> bool:
    return isinstance(comp, slice) and comp == _full_slice


def _validate_addr(
    addr: tuple, allow_partial_slice: bool = False
) -> tuple:
    """Check the shape grammar of an address's dynamic components.

    Static string components are transparent. The dynamic components must
    match, in order: a run of scalars (ints / 0-d arrays); at most one
    "fan-out" component (a non-scalar index array — or a partial slice
    when `allow_partial_slice`); then only full slices. This is a
    single-pass state machine; anything else cannot be resolved against
    dense leaf storage in one gather (capability parity with reference
    `choice_map.py:699-749`, independently re-derived from the gather
    grammar).
    """
    in_scalar_prefix = True
    for comp in addr:
        if isinstance(comp, str) or comp is ...:
            # Strings are trie keys; `...` indexes every leaf identically.
            continue
        if in_scalar_prefix:
            if _is_scalar_component(comp):
                continue
            in_scalar_prefix = False
            # This component occupies the single fan-out slot if eligible.
            if isinstance(comp, Array):
                continue
            if allow_partial_slice and isinstance(comp, slice) and not _is_full_slice(comp):
                continue
            # Not fan-out-eligible: must already be a trailing full slice.
        if not _is_full_slice(comp):
            grammar = (
                "scalars, then at most one index array or partial slice, "
                "then full slices"
                if allow_partial_slice
                else "scalars, then full slices"
            )
            raise ValueError(
                f"Unresolvable dynamic address {addr!r}: expected {grammar}; "
                f"component {comp!r} breaks the grammar."
            )
    return addr


##############
# Selections #
##############


class _SelectionBuilder:
    @property
    def all(self) -> "Selection":
        return Selection.all()

    @property
    def none(self) -> "Selection":
        return Selection.none()

    @property
    def leaf(self) -> "Selection":
        return Selection.leaf()

    def __getitem__(self, addr: ExtendedStaticAddress) -> "Selection":
        # Subtree semantics (reference `choice_map.py:112-117`): S[p]
        # selects p and every address beneath it, so selecting a submodel
        # address covers the submodel's whole choice subtree. S[()] is
        # the this-node-only leaf selection.
        path = _tuplize(addr)
        if not path:
            return Selection.leaf()
        return Selection.all().extend(*path)


class Selection(Pytree):
    """An address-set algebra over choice map addresses.

    Supports union (`|`), intersection (`&`), complement (`~`), nesting
    (`extend`), and querying: `sel(addr)` returns the sub-selection, while
    `sel[addr]` / `addr in sel` return whether the address is selected.
    The wildcard `...` matches zero or one address components (so
    `S[..., "z"]` addresses both a vectorized trie's flat `"z"` leaves and
    the positional `(step, "z")` space of `Scan`/`Vmap` edits).

    >>> from genjax_tpu import SelectionBuilder as S
    >>> sel = S["x"] | S["sub", "y"]
    >>> "x" in sel
    True
    >>> ("sub", "y") in sel
    True
    >>> ("sub", "z") in sel
    False
    >>> "x" in ~sel
    False
    >>> ("q", "z") in S[..., "z"]  # wildcard matches the one level "q"
    True
    """

    # `Selection.at` builder is assigned after the class definition (kept out
    # of the class body so dataclass subclasses don't pick it up as a field).

    @staticmethod
    def all() -> "Selection":
        return AllSel()

    @staticmethod
    def none() -> "Selection":
        return NoneSel()

    @staticmethod
    def leaf() -> "Selection":
        return LeafSel()

    # -- combinators ---------------------------------------------------------

    def __or__(self, other: "Selection") -> "Selection":
        self._check_operand(other, "Selection.__or__")
        return OrSel.build(self, other)

    def __and__(self, other: "Selection") -> "Selection":
        self._check_operand(other, "Selection.__and__")
        return AndSel.build(self, other)

    @staticmethod
    def _check_operand(other, where: str) -> None:
        from genjax_tpu.core import checked

        if checked.is_checked():
            checked.check_selection(other, where)

    def __invert__(self) -> "Selection":
        return ComplementSel.build(self)

    def complement(self) -> "Selection":
        return ~self

    def filter(self, sample: "ChoiceMap") -> "ChoiceMap":
        from genjax_tpu.core import checked

        if checked.is_checked():
            checked.check_choice_map(sample, "Selection.filter", what="sample")
        return sample.filter(self)

    def extend(self, *addrs: ExtendedStaticAddressComponent) -> "Selection":
        nested = self
        for comp in reversed(addrs):
            nested = StaticSel.build(nested, comp)
        return nested

    # -- querying -------------------------------------------------------------

    def __call__(self, addr: StaticAddress) -> "Selection":
        sub = self
        for comp in _tuplize(addr):
            sub = sub.get_subselection(comp)
        return sub

    def __getitem__(self, addr: StaticAddress) -> bool:
        return self(addr).check()

    def __contains__(self, addr: StaticAddress) -> bool:
        return self[addr]

    def check(self) -> Flag:
        raise NotImplementedError

    def get_subselection(self, addr) -> "Selection":
        raise NotImplementedError


@Pytree.dataclass(match_args=True)
class AllSel(Selection):
    def check(self) -> Flag:
        return True

    def get_subselection(self, addr) -> Selection:
        return self


@Pytree.dataclass(match_args=True)
class NoneSel(Selection):
    def check(self) -> Flag:
        return False

    def get_subselection(self, addr) -> Selection:
        return self


@Pytree.dataclass
class LeafSel(Selection):
    def check(self) -> Flag:
        return True

    def get_subselection(self, addr) -> Selection:
        return Selection.none()


@Pytree.dataclass(match_args=True)
class ComplementSel(Selection):
    s: Selection

    @staticmethod
    def build(s: Selection) -> Selection:
        match s:
            case AllSel():
                return Selection.none()
            case NoneSel():
                return Selection.all()
            case ComplementSel():
                return s.s
            case _:
                return ComplementSel(s)

    def check(self) -> Flag:
        return FlagOp.not_(self.s.check())

    def get_subselection(self, addr) -> Selection:
        return ~self.s(addr)


@Pytree.dataclass(match_args=True)
class StaticSel(Selection):
    s: Selection = Pytree.field()
    addr: ExtendedStaticAddressComponent = Pytree.static()

    @staticmethod
    def build(s: Selection, addr: ExtendedStaticAddressComponent) -> Selection:
        match s:
            case NoneSel():
                return s
            case _:
                return StaticSel(s, addr)

    def check(self) -> Flag:
        if self.addr is ...:
            # `...` matches zero-or-one levels (see get_subselection), so a
            # wildcard selection is checked against its inner selection.
            return self.s.check()
        return False

    def get_subselection(self, addr) -> Selection:
        if self.addr is ...:
            # The wildcard matches ZERO or ONE address components. The
            # zero-level branch (`self.s(addr)`) reconciles the two views
            # of vectorized traces: `Scan`/`Vmap` edits address steps
            # positionally ((idx, "z") — the wildcard consumes idx), while
            # their choice tries store "z" with batched leaves and no index
            # level (filter/HMC-style access — the wildcard matches
            # nothing). `S[..., "z"]` therefore works uniformly in both.
            return OrSel.build(self.s, self.s(addr))
        if addr is ...:
            return self.s
        if not static_check_is_concrete(addr):
            # Traced address component (e.g. the step index inside
            # `lax.scan` when a combinator slices a per-index selection):
            # a string-keyed selection can never match an integer level;
            # an integer-keyed one matches under a traced flag.
            if isinstance(self.addr, str):
                return Selection.none()
            return MaskedSel.build(self.s, jnp.asarray(addr) == self.addr)
        if isinstance(addr, Array):
            # Concrete 0-d array: compare by value against integer keys.
            if isinstance(self.addr, str):
                return Selection.none()
            return (
                self.s if bool(jnp.asarray(addr) == self.addr) else Selection.none()
            )
        if addr == self.addr:
            return self.s
        return Selection.none()


@Pytree.dataclass(match_args=True)
class MaskedSel(Selection):
    """A selection gated by a (possibly traced) Boolean flag.

    Produced when an integer-keyed selection (`S[1, "x"]`) is queried with
    a traced index — e.g. when `Scan`/`Vmap` slice the selection per step
    inside `lax.scan`/`vmap`. Consumers observe a traced `check()` and
    lower to dense selects (`Distribution.edit_regenerate`,
    `Distribution.project`)."""

    s: Selection
    flag: Flag

    @staticmethod
    def build(s: Selection, flag: Flag) -> Selection:
        if FlagOp.concrete_true(flag):
            return s
        if FlagOp.concrete_false(flag):
            return Selection.none()
        if isinstance(s, NoneSel):
            return s
        return MaskedSel(s, flag)

    def check(self) -> Flag:
        return FlagOp.and_(self.flag, self.s.check())

    def get_subselection(self, addr) -> Selection:
        return MaskedSel.build(self.s(addr), self.flag)


@Pytree.dataclass(match_args=True)
class AndSel(Selection):
    s1: Selection
    s2: Selection

    @staticmethod
    def build(a: Selection, b: Selection) -> Selection:
        match (a, b):
            case (AllSel(), _):
                return b
            case (_, AllSel()):
                return a
            case (NoneSel(), _):
                return a
            case (_, NoneSel()):
                return b
            case (a, b) if a == b:
                return a
            case _:
                return AndSel(a, b)

    def check(self) -> Flag:
        return FlagOp.and_(self.s1.check(), self.s2.check())

    def get_subselection(self, addr) -> Selection:
        return self.s1(addr) & self.s2(addr)


@Pytree.dataclass(match_args=True)
class OrSel(Selection):
    s1: Selection
    s2: Selection

    @staticmethod
    def build(a: Selection, b: Selection) -> Selection:
        match (a, b):
            case (AllSel(), _):
                return a
            case (_, AllSel()):
                return b
            case (NoneSel(), _):
                return b
            case (_, NoneSel()):
                return a
            case (a, b) if a == b:
                return a
            case _:
                return OrSel(a, b)

    def check(self) -> Flag:
        return FlagOp.or_(self.s1.check(), self.s2.check())

    def get_subselection(self, addr) -> Selection:
        return self.s1(addr) | self.s2(addr)


@Pytree.dataclass(match_args=True)
class ChmSel(Selection):
    c: "ChoiceMap"

    @staticmethod
    def build(chm: "ChoiceMap") -> Selection:
        if chm.static_is_empty():
            return Selection.none()
        return ChmSel(chm)

    def check(self) -> Flag:
        v = self.c.get_value()
        if v is None:
            return False
        if isinstance(v, Mask):
            return v.primal_flag()
        return True

    def get_subselection(self, addr) -> Selection:
        return self.c.get_inner_map(addr).get_selection()


def statically_unmatchable_at_index_level(sel: Selection) -> bool:
    """True when `sel(i)` is statically `NoneSel` for EVERY integer index
    `i` — i.e. the selection cannot address into an indexed address space
    (a `Scan` step level or `Vmap` lane level). `Scan`/`Vmap` raise on such
    selections instead of silently regenerating/projecting nothing; use
    `Selection.at[..., "addr"]` (wildcard over the index) or
    `Selection.at[i, "addr"]` (a specific index) there."""
    match sel:
        case NoneSel():
            return True
        case AllSel() | LeafSel():
            return False
        case StaticSel(_, addr):
            # A string key can never match an integer index level.
            return isinstance(addr, str)
        case OrSel(s1, s2):
            return statically_unmatchable_at_index_level(
                s1
            ) and statically_unmatchable_at_index_level(s2)
        case AndSel(s1, s2):
            return statically_unmatchable_at_index_level(
                s1
            ) or statically_unmatchable_at_index_level(s2)
        case MaskedSel(s, _):
            return statically_unmatchable_at_index_level(s)
        case _:
            # ComplementSel / ChmSel / unknown: cannot decide statically.
            return False


SelectionBuilder = _SelectionBuilder()
Selection.at = SelectionBuilder


###############
# Choice maps #
###############


@dataclass(frozen=True)
class ChoiceMapNoValueAtAddress(Exception):
    subaddr: Any


class _ChoiceMapBuilder:
    """Address-path accumulator behind `C["x", "y"].set(v)`.

    Each `[...]` returns a new builder with the component(s) appended; the
    terminal methods materialize a choice map nested at the accumulated
    path. A builder reached from an existing map (`chm.at[...]`) merges the
    new entry over that map with new-entry priority.
    """

    def __init__(self, base: "ChoiceMap | None", path: tuple = ()):
        self.base = base
        self.path = path

    def __getitem__(self, addr: Address) -> "_ChoiceMapBuilder":
        comps = addr if isinstance(addr, tuple) else (addr,)
        return _ChoiceMapBuilder(self.base, self.path + comps)

    def set(self, v) -> "ChoiceMap":
        entry = ChoiceMap.entry(
            v, *_validate_addr(self.path, allow_partial_slice=False)
        )
        return entry if self.base is None else entry | self.base

    def update(self, f) -> "ChoiceMap":
        """Apply `f` to the existing entry at the path (the raw value if one
        is present, the submap otherwise, empty if the builder is rootless)
        and store the result."""
        if self.base is None:
            current = _empty
        else:
            sub = self.base(self.path)
            held = sub.get_value()
            current = sub if held is None else held
        return self.set(f(current))

    def n(self) -> "ChoiceMap":
        return _empty

    def v(self, v) -> "ChoiceMap":
        return self.set(ChoiceMap.choice(v))

    def from_mapping(self, pairs) -> "ChoiceMap":
        return self.set(ChoiceMap.from_mapping(pairs))

    def d(self, entries: dict) -> "ChoiceMap":
        return self.set(ChoiceMap.d(entries))

    def kw(self, **entries) -> "ChoiceMap":
        return self.set(ChoiceMap.kw(**entries))

    def switch(self, idx, branches) -> "ChoiceMap":
        return self.set(ChoiceMap.switch(idx, branches))


class ChoiceMap(Pytree):
    """A functional trie of addressed random choices.

    Addresses mix static string components (trie dict keys — free at
    runtime) and dynamic integer-array components (dense gathers + Mask).

    >>> import jax.numpy as jnp
    >>> from genjax_tpu import ChoiceMap, SelectionBuilder as S
    >>> chm = ChoiceMap.kw(x=1.0) | ChoiceMap.d({("sub", "y"): 2.0})
    >>> float(chm["x"])
    1.0
    >>> float(chm["sub", "y"])
    2.0
    >>> ("sub", "y") in chm
    True
    >>> kept = chm.filter(S["x"])
    >>> "x" in kept, ("sub", "y") in kept
    (True, False)

    The builder nests values at arbitrary addresses, and `|` merges with
    left priority:

    >>> C = ChoiceMap.builder
    >>> c = C["a", "b"].set(3.0) | C["a", "b"].set(4.0)
    >>> float(c["a", "b"])
    3.0

    Dynamic integer addresses store densely and answer membership with
    `Mask` flags:

    >>> c = C[jnp.array([2, 5]), "v"].set(jnp.array([10.0, 20.0]))
    >>> sub = c.get_submap(5, "v").get_value()
    >>> bool(sub.primal_flag()), float(sub.value)
    (True, 20.0)
    """

    # -- abstract interface ----------------------------------------------------

    def filter(self, selection: "Selection | Flag") -> "ChoiceMap":
        raise NotImplementedError

    def _check_filter_arg(self, selection) -> None:
        from genjax_tpu.core import checked

        if checked.is_checked() and not isinstance(
            selection, (Selection, bool)
        ) and not hasattr(selection, "dtype"):
            raise TypeError(
                "ChoiceMap.filter expects a Selection (Selection.at['x']) "
                f"or a Boolean flag; got {type(selection).__name__}."
            )

    def get_value(self) -> Any:
        raise NotImplementedError

    def get_inner_map(self, addr: AddressComponent) -> "ChoiceMap":
        raise NotImplementedError

    # -- derived interface -------------------------------------------------------

    def get_submap(self, *addresses: Address) -> "ChoiceMap":
        flat: list[AddressComponent] = []
        for a in addresses:
            flat.extend(a) if isinstance(a, tuple) else flat.append(a)
        chm = self
        for comp in _validate_addr(tuple(flat), allow_partial_slice=True):
            chm = chm.get_inner_map(comp)
        return chm

    def has_value(self) -> bool:
        return self.get_value() is not None

    # -- constructors ---------------------------------------------------------------
    # (`ChoiceMap.builder` is assigned after the class definition.)

    @staticmethod
    def empty() -> "ChoiceMap":
        return _empty

    @staticmethod
    def choice(v: Any) -> "ChoiceMap":
        return Choice.build(v)

    @staticmethod
    def value(v: Any) -> "ChoiceMap":
        return Choice.build(v)

    @staticmethod
    def entry(v, *addrs: AddressComponent) -> "ChoiceMap":
        """Nest `v` (a value, dict, or existing map) under an address path."""
        if isinstance(v, dict):
            v = ChoiceMap.d(v)
        chm = v if isinstance(v, ChoiceMap) else ChoiceMap.choice(v)
        return chm.extend(*addrs)

    @staticmethod
    def from_mapping(pairs: Iterable[tuple[Any, Any]]) -> "ChoiceMap":
        acc = ChoiceMap.empty()
        for addr, v in pairs:
            comps = addr if isinstance(addr, tuple) else (addr,)
            acc |= ChoiceMap.entry(v, *comps)
        return acc

    @staticmethod
    def d(entries: dict) -> "ChoiceMap":
        return ChoiceMap.from_mapping(entries.items())

    @staticmethod
    def kw(**kwargs) -> "ChoiceMap":
        return ChoiceMap.d(kwargs)

    @staticmethod
    def switch(idx: IntArray, chms: Iterable["ChoiceMap"]) -> "ChoiceMap":
        return Switch.build(idx, chms)

    # -- combinators ---------------------------------------------------------------

    def mask(self, flag: Flag) -> "ChoiceMap":
        self._check_filter_arg(flag)
        return self.filter(flag)

    def extend(self, *addrs: AddressComponent) -> "ChoiceMap":
        nested = self
        for comp in reversed(addrs):
            nested = (
                Static.build({comp: nested})
                if isinstance(comp, str)
                else Indexed.build(nested, comp)
            )
        return nested

    def merge(self, other: "ChoiceMap") -> "ChoiceMap":
        return self | other

    def get_selection(self) -> Selection:
        return ChmSel.build(self)

    def static_is_empty(self) -> bool:
        return False

    # -- dunders ------------------------------------------------------------------

    def __or__(self, other: "ChoiceMap") -> "ChoiceMap":
        from genjax_tpu.core import checked

        if checked.is_checked():
            checked.check_choice_map(other, "ChoiceMap.__or__", what="other")
        return Or.build(self, other)

    def __xor__(self, other: "ChoiceMap") -> "ChoiceMap":
        return self | other

    def __and__(self, other: "ChoiceMap") -> "ChoiceMap":
        return other.filter(self.get_selection())

    def __add__(self, other: "ChoiceMap") -> "ChoiceMap":
        return self | other

    def __call__(self, *addresses: Address) -> "ChoiceMap":
        return self.get_submap(*addresses)

    def __getitem__(self, addr: Address):
        submap = self.get_submap(addr)
        v = submap.get_value()
        if v is None:
            raise ChoiceMapNoValueAtAddress(addr)
        return v

    def __contains__(self, addr: Address) -> bool:
        return self.get_submap(addr).has_value()

    @property
    def at(self) -> _ChoiceMapBuilder:
        return _ChoiceMapBuilder(self)

    def invalid_subset(self, gen_fn, args) -> "ChoiceMap | None":
        """Return the sub-choicemap whose addresses are not reachable in
        `gen_fn(*args)`'s execution, or None if all addresses are valid."""
        reachable = _shape_selection(gen_fn.get_zero_trace(*args).get_choices())
        unreachable = self.filter(~reachable)
        return None if unreachable.static_is_empty() else unreachable


def _index_leaves(chm: ChoiceMap, idx) -> ChoiceMap:
    """Index every leaf array of a choice map along its leading axis,
    treating embedded `Mask`s as leaves so their flag/value pair is indexed
    coherently (the flag spans the same leading axis). Leaves with no
    leading axis (scalars) pass through unchanged — they are shared
    across the indexed axis (the shared-args layout, ARCHITECTURE.md 4b)."""

    def pick(leaf):
        if isinstance(leaf, Mask) or jnp.ndim(leaf) >= 1:
            return leaf[idx]
        return leaf

    return jtu.tree_map(pick, chm, is_leaf=lambda x: isinstance(x, Mask))


@Pytree.dataclass(match_args=True)
class Choice(Generic[T], ChoiceMap):
    """A choice map holding a single value at the root."""

    v: T

    @staticmethod
    def build(v: T) -> ChoiceMap:
        if getattr(v, "shape", None) == (0,):
            # Zero-length batches carry no choices.
            return ChoiceMap.empty()
        if not isinstance(v, Mask):
            return Choice(v)
        # Collapse statically-decided masks: a definitely-dead value is the
        # empty map, a definitely-live one sheds its wrapper.
        match v.flatten():
            case None:
                return ChoiceMap.empty()
            case Mask() as still_masked:
                return Choice(still_masked)
            case plain:
                return Choice(plain)

    def filter(self, selection: Selection | Flag) -> ChoiceMap:
        if not isinstance(selection, Selection):
            # Raw flag: mask the held value directly.
            return Choice.build(Mask.build(self.v, selection))
        keep = selection.check()
        if FlagOp.concrete_true(keep):
            return self
        if FlagOp.concrete_false(keep):
            return ChoiceMap.empty()
        # Runtime-valued check (MaskedSel / masked ChmSel): defer the
        # decision into a traced Mask flag.
        return Choice.build(Mask.build(self.v, keep))

    def get_value(self) -> T:
        return self.v

    def get_inner_map(self, addr: AddressComponent) -> ChoiceMap:
        if isinstance(addr, str):
            return ChoiceMap.empty()
        return _index_leaves(self, addr)


@Pytree.dataclass(match_args=True)
class Indexed(ChoiceMap):
    """A choice map nested under a dynamic (integer-array) address.

    `addr` is either a scalar (the submap lives at that single index) or a
    1-d array pairing each leading-axis row of the submap's leaves with an
    index. Lookup against an array address is a dense first-hit search —
    compare all stored indices, `argmax` the Boolean hits to locate the
    winning row, gather it, and mask by whether any hit occurred. No
    data-dependent control flow, so the whole lookup stays inside one fused
    XLA computation.
    """

    c: ChoiceMap
    addr: IntArray

    @staticmethod
    def build(chm: ChoiceMap, addr: DynamicAddressComponent) -> ChoiceMap:
        if isinstance(addr, slice):
            if addr != _full_slice:
                raise ValueError(
                    f"Only the full slice [:] may address an Indexed node; "
                    f"got {addr!r}."
                )
            return chm
        is_empty = chm.static_is_empty() or (
            isinstance(addr, Array) and addr.shape == (0,)
        )
        return ChoiceMap.empty() if is_empty else Indexed(chm, addr)

    def filter(self, selection: Selection | Flag) -> ChoiceMap:
        return self.c.filter(selection).extend(self.addr)

    def get_value(self) -> Any:
        return None

    def get_inner_map(self, addr: AddressComponent) -> ChoiceMap:
        if isinstance(addr, str):
            return ChoiceMap.empty()

        stored = self.addr
        if not (isinstance(stored, Array) and stored.ndim):
            # Scalar stored index: membership is a single flag over the
            # whole submap.
            return self.c.mask(stored == addr)

        if isinstance(addr, slice):
            raise ValueError(
                f"An array-addressed Indexed node supports scalar lookups "
                f"only; got slice {addr!r} against indices of shape "
                f"{stored.shape}."
            )
        query = jnp.asarray(addr, copy=False)
        assert query.ndim == 0, (
            f"Dynamic lookup requires a scalar index; got shape {query.shape}."
        )
        hits = stored == query
        row = jnp.argmax(hits)  # first hit; row 0 (don't-care) when none
        found = jnp.any(hits)
        return jtu.tree_map(
            lambda leaf: Mask.build(leaf[row], found),
            self.c,
            is_leaf=lambda x: isinstance(x, Mask),
        )


@Pytree.dataclass(match_args=True)
class Static(ChoiceMap):
    """A static trie node mapping string components to sub choice maps.

    Children are ChoiceMap nodes held in a plain dict; the keys live in the
    treedef (static metadata), so address resolution costs nothing at
    runtime — only leaf arrays are traced.
    """

    children: dict

    @staticmethod
    def build(children: dict) -> "Static":
        return Static(
            {k: sub for k, sub in children.items() if not sub.static_is_empty()}
        )

    @staticmethod
    def merge_with(merge, c1: "Static", c2: "Static") -> ChoiceMap:
        combined = dict(c1.children)
        for key, sub in c2.children.items():
            combined[key] = merge(combined[key], sub) if key in combined else sub
        return Static.build(combined)

    def filter(self, selection: Selection | Flag) -> ChoiceMap:
        if isinstance(selection, Selection):
            kept = {k: sub.filter(selection(k)) for k, sub in self.children.items()}
        else:
            kept = {k: sub.filter(selection) for k, sub in self.children.items()}
        return Static.build(kept)

    def get_value(self) -> Any:
        return None

    def get_inner_map(self, addr: AddressComponent) -> ChoiceMap:
        if isinstance(addr, str):
            return self.children.get(addr, _empty)
        return _index_leaves(self, addr)

    def static_is_empty(self) -> bool:
        return not self.children


@Pytree.dataclass(match_args=True)
class Switch(ChoiceMap):
    """Index-masked union of several choice maps: branch `i` is masked by
    `idx == i`."""

    idx: IntArray
    chms: list[ChoiceMap]

    @staticmethod
    def build(idx, chm_iter: Iterable[ChoiceMap]) -> ChoiceMap:
        branches = list(chm_iter)
        if isinstance(idx, int):
            # Statically-known branch: no masking machinery needed.
            return branches[idx]
        return Switch._rebuild(idx, [b.mask(idx == i) for i, b in enumerate(branches)])

    @staticmethod
    def _rebuild(idx, branches: list[ChoiceMap]) -> ChoiceMap:
        # Collapse the husk: a Switch whose every branch is statically
        # empty holds no choices, and leaving it in place makes filtered
        # constraints read as non-empty downstream (edit handlers would
        # treat `Switch(idx, [{}, {}])` as a real constraint — caught by
        # the structural fuzzer on mask(mix(...)) flag flips).
        if all(b.static_is_empty() for b in branches):
            return ChoiceMap.empty()
        return Switch(idx, branches)

    def filter(self, selection: Selection | Flag) -> ChoiceMap:
        return Switch._rebuild(self.idx, [b.filter(selection) for b in self.chms])

    def static_is_empty(self) -> bool:
        return all(b.static_is_empty() for b in self.chms)

    def get_value(self) -> Any:
        live = [
            Mask.build(v)
            for v in (b.get_value() for b in self.chms)
            if v is not None
        ]
        return Mask.or_n(*live) if live else None

    def get_inner_map(self, addr: AddressComponent) -> ChoiceMap:
        return Switch._rebuild(self.idx, [b.get_inner_map(addr) for b in self.chms])


@Pytree.dataclass(match_args=True)
class Or(ChoiceMap):
    """Left-prioritized union of two choice maps."""

    c1: ChoiceMap
    c2: ChoiceMap

    @staticmethod
    def build(c1: ChoiceMap, c2: ChoiceMap) -> ChoiceMap:
        if c1.static_is_empty():
            return c2
        if c2.static_is_empty():
            return c1
        match (c1, c2):
            case (Static(), Static()):
                # Tries merge key-by-key, recursing on collisions.
                return Static.merge_with(lambda a, b: a | b, c1, c2)
            case (Choice(a), Choice(b)):
                # Two leaves: resolve eagerly via the Mask union (left wins
                # where valid).
                return Choice.build(Mask.build(a) | Mask.build(b))
            case (Switch(idx, branches), _) if not isinstance(c2, Switch):
                # Push the union into each branch so the switch structure
                # survives (its per-branch masks already encode priority).
                return Switch.build(idx, [b | c2 for b in branches])
            case (_, Switch(idx, branches)) if not isinstance(c1, Switch):
                return Switch.build(idx, [c1 | b for b in branches])
            case _:
                # Heterogeneous overlap (leaf vs subtree, masked leaf vs
                # trie, switch vs switch): keep a lazy left-priority node;
                # get_value/get_inner_map distribute over it.
                return Or(c1, c2)

    def filter(self, selection: Selection | Flag) -> ChoiceMap:
        return self.c1.filter(selection) | self.c2.filter(selection)

    def get_value(self) -> Any:
        left, right = self.c1.get_value(), self.c2.get_value()
        if left is None or right is None:
            return left if right is None else right
        union = Mask.build(left) | Mask.build(right)
        # Shed the wrapper when validity is statically certain.
        return union.value if union.primal_flag() is True else union

    def get_inner_map(self, addr: AddressComponent) -> ChoiceMap:
        return self.c1.get_inner_map(addr) | self.c2.get_inner_map(addr)


def _shape_selection(chm: ChoiceMap) -> Selection:
    """The selection of every address reachable in `chm`'s structure
    (used by `invalid_subset`)."""
    match chm:
        case Static(children):
            acc = Selection.none()
            for addr, sub in children.items():
                acc |= _shape_selection(sub).extend(addr)
            return acc
        case Indexed(inner, _):
            return _shape_selection(inner).extend(...)
        case Choice():
            return LeafSel()
        case Or(c1, c2):
            return _shape_selection(c1) | _shape_selection(c2)
        case Switch(_, branches):
            acc = Selection.none()
            for sub in branches:
                acc |= _shape_selection(sub)
            return acc
        case _:
            raise ValueError(f"Unknown ChoiceMap node: {type(chm)}")


_empty = Static({})
ChoiceMapBuilder = _ChoiceMapBuilder(_empty)
ChoiceMap.builder = _ChoiceMapBuilder(None)
