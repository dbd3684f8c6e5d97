"""Static dependency analysis for incremental `edit`.

The reference propagates `NoChange`/`UnknownChange` tangents through model
code with an incremental jaxpr interpreter (reference
`_src/core/compiler/interpreters/incremental.py`), so edits skip density
recomputation at unaffected addresses. This module restores that
capability with an accelerator-friendlier mechanism:

1. Stage the model source once per (source, argument avals) with each
   `trace` site bound as an opaque `site_p` equation (zero-FLOP abstract
   call), producing a jaxpr whose dataflow exposes which sites feed which.
2. Walk the jaxpr once to build the *site graph*: for each address, the
   set of upstream addresses whose values reach its arguments, whether the
   model arguments reach it, and which addresses reach the return value.
3. At edit time, close the statically-known touched set over the graph:
   - value-changed sites = directly constrained / regenerated addresses;
   - weight-recompute sites = value-changed ∪ sites whose arguments read a
     value-changed site's output (or the model args, when argdiffs are
     unknown);
   - the retdiff is statically `NoChange` iff no value-changed site (nor a
     changed model argument) reaches the return value.

The edit handlers then reuse the old subtrace verbatim at every address
outside the weight-recompute set — XLA dead-code-eliminates all of that
address's density work from the compiled edit. This is the same
asymptotic win as the reference's interpreter (O(affected) instead of
O(model) compiled edits) computed once per jit specialization.
"""

from dataclasses import dataclass
import jax
import jax.tree_util as jtu

from genjax_tpu.core.primitives import InitialStylePrimitive, initial_style_bind
from genjax_tpu.core.pytree import Const
from genjax_tpu.core.typing import static_check_is_concrete
from genjax_tpu.lang.interop import TraceHandler, handler_context

site_p = InitialStylePrimitive("genjax_site")


class _StageHandler(TraceHandler):
    """Binds each trace site as an opaque `site_p` equation whose inputs
    are the site's arguments and whose outputs are its (abstract) return
    value."""

    def __init__(self):
        self.order: list = []

    def handle_trace(self, addr, gen_fn, args):
        if addr not in self.order:
            self.order.append(addr)

        def _site(_addr_const, gen_fn, args):
            return gen_fn.__abstract_call__(*args)

        return initial_style_bind(
            site_p,
            addr=_freeze_addr(addr),
            # Distributions promise retval == sampled value (kept unless
            # the site itself is edited); composite callees' retvals may
            # deterministically read their arguments, so change flows
            # through them (see the taint rules in `_analyze`).
            opaque_retval=bool(getattr(gen_fn, "retval_is_value", False)),
        )(_site)(Const(addr), gen_fn, args)


def _freeze_addr(addr):
    return addr if isinstance(addr, (str, tuple)) else str(addr)


@dataclass(frozen=True)
class SiteGraph:
    """Static dataflow summary of one model specialization."""

    order: tuple                      # addresses in program order
    deps: dict                        # addr -> frozenset of upstream addrs feeding its args
    args_reach: frozenset             # addrs whose args read the model arguments
    retval_deps: frozenset            # addrs whose values reach the return value
    retval_reads_args: bool           # model args reach the return value
    site_args: dict                   # addr -> (in_tree, ((taint, reads_args), ...) per leaf)

    def weight_set(self, value_changed: frozenset, args_changed: bool) -> frozenset:
        """Addresses whose density must be recomputed for this edit."""
        w = set(value_changed)
        for addr in self.order:
            if addr in w:
                continue
            if args_changed and addr in self.args_reach:
                w.add(addr)
            elif self.deps[addr] & value_changed:
                w.add(addr)
        return frozenset(w)

    def retval_unchanged(self, value_changed: frozenset, args_changed: bool) -> bool:
        if args_changed and self.retval_reads_args:
            return False
        return not (self.retval_deps & value_changed)

    def site_edit_info(self, addr, value_changed: frozenset, args_changed: bool):
        """`(argdiff_mask, callee_changed)` for an edited site.

        `argdiff_mask` is a per-leaf changed/unchanged pytree over the
        site's argument structure, or None when leaf-level precision is
        unavailable. `callee_changed` is True when the callee's OWN
        pytree leaves (closure captures) are tainted by this edit — a
        change argdiffs cannot express, so the site needs a dense
        recompute under the freshly-built callee. Analysis failures
        (missing info, structure drift) report (None, True): dense is
        always correct."""
        info = self.site_args.get(addr)
        if info is None:
            return None, True
        in_tree, leaf_info = info
        changed = [
            bool(taint & value_changed) or (args_changed and reads_args)
            for taint, reads_args in leaf_info
        ]
        try:
            _addr_part, genfn_part, args_part = jtu.tree_unflatten(in_tree, changed)
        except Exception:
            return None, True
        if any(bool(leaf) for leaf in jtu.tree_leaves(genfn_part)):
            return None, True
        return args_part, False

    def argdiff_mask(self, addr, value_changed: frozenset, args_changed: bool):
        """Per-leaf changed/unchanged mask over `addr`'s argument pytree,
        or None when leaf-level precision is unavailable."""
        mask, _ = self.site_edit_info(addr, value_changed, args_changed)
        return mask


def _analyze(source, args) -> SiteGraph:
    handler = _StageHandler()

    def staged(*args):
        with handler_context(handler):
            return source(*args)

    closed = jax.make_jaxpr(staged)(*args)
    jaxpr = closed.jaxpr

    # taint[id(var)] = frozenset of site addrs whose VALUE reaches var;
    # args_taint[id(var)] = True if the model arguments reach var.
    taint: dict[int, frozenset] = {}
    args_taint: dict[int, bool] = {}
    for var in jaxpr.invars:
        taint[id(var)] = frozenset()
        args_taint[id(var)] = True
    for var in jaxpr.constvars:
        taint[id(var)] = frozenset()
        args_taint[id(var)] = False

    from jax.extend.core import Literal

    def var_taint(v):
        if isinstance(v, Literal):
            return frozenset(), False
        return taint.get(id(v), frozenset()), args_taint.get(id(v), False)

    deps: dict = {}
    args_reach = set()
    site_args: dict = {}

    for eqn in jaxpr.eqns:
        in_taints = [var_taint(v) for v in eqn.invars]
        merged = frozenset().union(*(t for t, _ in in_taints)) if in_taints else frozenset()
        reads_args = any(a for _, a in in_taints)
        if eqn.primitive is site_p:
            addr = eqn.params["addr"]
            # First write wins (a site appears once); its args' taints are
            # its dependencies.
            if addr not in deps:
                deps[addr] = merged
                if reads_args:
                    args_reach.add(addr)
                num_consts = eqn.params["num_consts"]
                site_args[addr] = (
                    eqn.params["in_tree"],
                    tuple(in_taints[num_consts:]),
                )
            # An un-edited DISTRIBUTION site's output (its sampled value)
            # is retained even when its arguments change (Update /
            # Regenerate semantics), so no taint flows through it: its
            # output changes iff the site itself is edited. A COMPOSITE
            # site's retval may additionally be a deterministic function
            # of its arguments (`return x + b`), so argument taint and
            # the args flag DO flow through — otherwise a downstream site
            # reading that retval would be wrongly reused when the model
            # arguments change (stale-score bug, tests/lang/
            # test_incremental_edit.py::test_composite_retval_propagates).
            if eqn.params["opaque_retval"]:
                out_taint, out_args = frozenset([addr]), False
            else:
                out_taint, out_args = merged | frozenset([addr]), reads_args
            for var in eqn.outvars:
                taint[id(var)] = out_taint
                args_taint[id(var)] = out_args
        else:
            for var in eqn.outvars:
                taint[id(var)] = merged
                args_taint[id(var)] = reads_args

    ret_taint = frozenset()
    ret_args = False
    for var in jaxpr.outvars:
        t, a = var_taint(var)
        ret_taint |= t
        ret_args = ret_args or a

    return SiteGraph(
        order=tuple(deps.keys()),
        deps=deps,
        args_reach=frozenset(args_reach),
        retval_deps=ret_taint,
        retval_reads_args=ret_args,
        site_args=site_args,
    )


_CACHE: dict = {}

# A concrete closure argument can steer Python control flow during staging
# (e.g. `if bool(flag): x @ "a" else: y @ "b"`), so its VALUE is part of the
# specialization identity, not just its aval. Small concrete leaves keep
# their raw bytes in the key; larger ones are digested (sha1) so data
# arrays closed over by `partial_apply` stay cacheable.
_VALUE_INLINE_MAX_ELEMS = 128

# Eager loops over distinct concrete dyn_args would otherwise grow the
# cache (and pin fn objects) without bound; evict oldest-first past this.
_CACHE_MAX_ENTRIES = 512


def _aval_key(tree):
    shapes = jax.eval_shape(lambda *a: a, *jtu.tree_leaves(tree))
    return tuple((s.shape, str(s.dtype)) for s in shapes)


def _value_fingerprint(tree):
    """Hashable fingerprint of the concrete leaf values in `tree`. Traced
    leaves contribute no value (they cannot steer Python control flow),
    only their avals — which `_aval_key` already covers."""
    import hashlib

    import numpy as np

    parts = []
    for leaf in jtu.tree_leaves(tree):
        if not static_check_is_concrete(leaf):
            parts.append(None)
            continue
        arr = np.asarray(leaf)
        if arr.size > _VALUE_INLINE_MAX_ELEMS:
            digest = hashlib.sha1(arr.tobytes()).hexdigest()
            parts.append((arr.shape, str(arr.dtype), digest))
        else:
            parts.append((arr.shape, str(arr.dtype), arr.tobytes()))
    return tuple(parts)


def site_graph(source, args) -> SiteGraph:
    """Cached site-graph analysis keyed on the full specialization identity
    of `(source, args)`: the closure's function object (held strongly, so
    `id` reuse after GC cannot alias two functions), the closure's dynamic
    arguments (structure, avals, and concrete values — bound `self`s,
    `partial_apply`ed arguments, or nested closures change the site graph),
    and the call arguments' structure and avals."""
    key = (
        source.fn,
        jtu.tree_structure(source.dyn_args),
        _aval_key(source.dyn_args),
        _value_fingerprint(source.dyn_args),
        jtu.tree_structure(args),
        _aval_key(args),
    )
    hit = _CACHE.get(key)
    if hit is None:
        hit = _analyze(source, args)
        while len(_CACHE) >= _CACHE_MAX_ENTRIES:
            _CACHE.pop(next(iter(_CACHE)))
        _CACHE[key] = hit
    return hit


def static_touched_addresses(constraint) -> frozenset | None:
    """The set of top-level addresses a constraint choice map touches, if
    statically determinable (None = unknown → treat all as touched)."""
    from genjax_tpu.core.choice_map import Or, Static

    match constraint:
        case Static(mapping):
            return frozenset(mapping.keys())
        case Or(c1, c2):
            a = static_touched_addresses(c1)
            b = static_touched_addresses(c2)
            if a is None or b is None:
                return None
            return a | b
        case _:
            if constraint.static_is_empty():
                return frozenset()
            return None


def static_selected_addresses(selection, site_order) -> frozenset | None:
    """Which of `site_order`'s addresses a selection selects, if statically
    determinable (None = unknown)."""
    from genjax_tpu.core.choice_map import (
        AllSel,
        AndSel,
        ComplementSel,
        LeafSel,
        NoneSel,
        OrSel,
        StaticSel,
    )

    def is_static(sel) -> bool:
        match sel:
            case AllSel() | NoneSel() | LeafSel():
                return True
            case StaticSel(s, _):
                return is_static(s)
            case OrSel(s1, s2) | AndSel(s1, s2):
                return is_static(s1) and is_static(s2)
            case ComplementSel(s):
                return is_static(s)
            case _:
                return False

    if not is_static(selection):
        return None
    touched = set()
    for addr in site_order:
        sub = selection(addr)
        # An address is touched unless its subselection is statically none.
        if not isinstance(sub, NoneSel):
            touched.add(addr)
    return frozenset(touched)
