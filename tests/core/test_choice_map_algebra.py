"""Deep ChoiceMap/Selection algebra property tests (grow
coverage toward the reference's hypothesis suite —
Switch × Indexed × filter × merge interactions on randomly generated
nested tries and randomly generated selection expressions).
"""

import jax.numpy as jnp
from hypothesis import given, settings
from hypothesis import strategies as st

from genjax_tpu import ChoiceMap, Mask, Selection
from genjax_tpu import ChoiceMapBuilder as C
from genjax_tpu import SelectionBuilder as S

KEYS = list("abcd")

# -- random nested tries ------------------------------------------------------

_leaf_values = st.floats(
    min_value=-50, max_value=50, allow_nan=False, allow_infinity=False
)


def _nested_dicts(depth: int):
    if depth == 0:
        return _leaf_values
    return st.dictionaries(
        st.sampled_from(KEYS),
        st.one_of(_leaf_values, _nested_dicts(depth - 1)),
        min_size=1,
        max_size=3,
    )


tries = st.dictionaries(
    st.sampled_from(KEYS), st.one_of(_leaf_values, _nested_dicts(1)), min_size=1, max_size=3
)


def _paths(d, prefix=()):
    """All leaf address paths of a nested dict."""
    out = []
    for k, v in d.items():
        if isinstance(v, dict):
            out.extend(_paths(v, (*prefix, k)))
        else:
            out.append(((*prefix, k), v))
    return out


def _lookup(chm: ChoiceMap, path):
    sub = chm.get_submap(*path)
    v = sub.get_value()
    if isinstance(v, Mask):
        flag = v.primal_flag()
        if not bool(jnp.all(jnp.asarray(flag))):
            return None
        return v.value
    return v


# -- random selection expressions --------------------------------------------

_sel_leaves = st.one_of(
    st.just(Selection.all()),
    st.just(Selection.none()),
    st.lists(st.sampled_from(KEYS), min_size=1, max_size=2).map(
        lambda p: S[tuple(p)]
    ),
    st.sampled_from(KEYS).map(lambda k: S[..., k]),
)


def _sel_exprs(depth: int):
    if depth == 0:
        return _sel_leaves
    sub = _sel_exprs(depth - 1)
    return st.one_of(
        _sel_leaves,
        st.tuples(sub, sub).map(lambda ab: ab[0] | ab[1]),
        st.tuples(sub, sub).map(lambda ab: ab[0] & ab[1]),
        sub.map(lambda s: ~s),
    )


selections = _sel_exprs(2)


class TestFilterPartition:
    @settings(max_examples=60, deadline=None)
    @given(tries, selections)
    def test_filter_and_complement_partition(self, d, sel):
        """For every leaf path: exactly one of filter(sel) / filter(~sel)
        holds its value, and the union reconstructs the trie."""
        chm = ChoiceMap.d(d)
        kept = chm.filter(sel)
        dropped = chm.filter(~sel)
        for path, v in _paths(d):
            in_kept = _lookup(kept, path)
            in_dropped = _lookup(dropped, path)
            assert (in_kept is None) != (in_dropped is None), (path, sel)
            got = in_kept if in_kept is not None else in_dropped
            assert jnp.isclose(jnp.float32(got), jnp.float32(v))

    @settings(max_examples=40, deadline=None)
    @given(tries, selections)
    def test_filter_idempotent(self, d, sel):
        chm = ChoiceMap.d(d)
        once = chm.filter(sel)
        twice = once.filter(sel)
        for path, _ in _paths(d):
            a, b = _lookup(once, path), _lookup(twice, path)
            assert (a is None) == (b is None)
            if a is not None:
                assert jnp.isclose(jnp.float32(a), jnp.float32(b))

    @settings(max_examples=40, deadline=None)
    @given(tries, selections, selections)
    def test_demorgan_on_filters(self, d, s1, s2):
        """filter(~(s1 | s2)) keeps a leaf iff filter(~s1 & ~s2) does."""
        chm = ChoiceMap.d(d)
        lhs = chm.filter(~(s1 | s2))
        rhs = chm.filter(~s1 & ~s2)
        for path, _ in _paths(d):
            assert (_lookup(lhs, path) is None) == (_lookup(rhs, path) is None)

    @settings(max_examples=40, deadline=None)
    @given(tries, selections)
    def test_double_complement(self, d, sel):
        chm = ChoiceMap.d(d)
        lhs = chm.filter(sel)
        rhs = chm.filter(~~sel)
        for path, _ in _paths(d):
            assert (_lookup(lhs, path) is None) == (_lookup(rhs, path) is None)


class TestMergeAlgebra:
    @settings(max_examples=60, deadline=None)
    @given(tries, tries)
    def test_or_left_priority_everywhere(self, d1, d2):
        merged = ChoiceMap.d(d1) | ChoiceMap.d(d2)
        for path, v in _paths(d1):
            got = _lookup(merged, path)
            assert got is not None
            assert jnp.isclose(jnp.float32(got), jnp.float32(v)), path
        for path, v in _paths(d2):
            # d2's leaves survive unless shadowed by d1 at the same path
            # (or structurally shadowed by a d1 leaf along the prefix).
            got = _lookup(merged, path)
            if got is not None and _lookup(ChoiceMap.d(d1), path) is None:
                shadowed = any(
                    _lookup(ChoiceMap.d(d1), path[:k]) is not None
                    for k in range(1, len(path))
                )
                if not shadowed:
                    assert jnp.isclose(jnp.float32(got), jnp.float32(v)), path

    @settings(max_examples=40, deadline=None)
    @given(tries, selections)
    def test_filter_distributes_over_or(self, d, sel):
        """(c1 | c2).filter(sel) agrees with c1.filter(sel) | c2.filter(sel)
        for disjoint halves of one trie."""
        chm = ChoiceMap.d(d)
        paths = [p for p, _ in _paths(d)]
        half = {p for i, p in enumerate(paths) if i % 2 == 0}
        half_sel = Selection.none()
        for p in half:
            half_sel |= S[p]
        c1 = chm.filter(half_sel)
        c2 = chm.filter(~half_sel)
        lhs = (c1 | c2).filter(sel)
        rhs = c1.filter(sel) | c2.filter(sel)
        for path, _ in _paths(d):
            assert (_lookup(lhs, path) is None) == (_lookup(rhs, path) is None)


class TestSwitchInteractions:
    @settings(max_examples=40, deadline=None)
    @given(tries, tries, st.integers(min_value=0, max_value=1))
    def test_switch_selects_branch(self, d1, d2, idx):
        sw = ChoiceMap.switch(jnp.asarray(idx), [ChoiceMap.d(d1), ChoiceMap.d(d2)])
        active = _paths(d1) if idx == 0 else _paths(d2)
        for path, v in active:
            got = _lookup(sw, path)
            assert got is not None, path
            assert jnp.isclose(jnp.float32(got), jnp.float32(v))
        inactive = _paths(d2) if idx == 0 else _paths(d1)
        active_paths = {p for p, _ in active}
        for path, _ in inactive:
            if path not in active_paths:
                assert _lookup(sw, path) is None, path

    @settings(max_examples=30, deadline=None)
    @given(tries, tries, selections, st.integers(min_value=0, max_value=1))
    def test_filter_commutes_with_switch(self, d1, d2, sel, idx):
        """switch(i, [c1, c2]).filter(sel) == switch(i, [c1.filter,
        c2.filter]) observationally at every leaf path."""
        c1, c2 = ChoiceMap.d(d1), ChoiceMap.d(d2)
        i = jnp.asarray(idx)
        lhs = ChoiceMap.switch(i, [c1, c2]).filter(sel)
        rhs = ChoiceMap.switch(i, [c1.filter(sel), c2.filter(sel)])
        for path, _ in _paths(d1) + _paths(d2):
            a, b = _lookup(lhs, path), _lookup(rhs, path)
            assert (a is None) == (b is None), path
            if a is not None:
                assert jnp.isclose(jnp.float32(a), jnp.float32(b))

    @settings(max_examples=30, deadline=None)
    @given(tries, tries, tries, st.integers(min_value=0, max_value=1))
    def test_or_with_switch_left_priority(self, d1, d2, d3, idx):
        """(base | switch) keeps base's leaves everywhere."""
        base = ChoiceMap.d(d3)
        sw = ChoiceMap.switch(jnp.asarray(idx), [ChoiceMap.d(d1), ChoiceMap.d(d2)])
        merged = base | sw
        for path, v in _paths(d3):
            got = _lookup(merged, path)
            assert got is not None
            assert jnp.isclose(jnp.float32(got), jnp.float32(v))


class TestIndexedInteractions:
    @settings(max_examples=40, deadline=None)
    @given(
        st.lists(
            st.integers(min_value=0, max_value=7), min_size=1, max_size=4, unique=True
        ),
        st.lists(_leaf_values, min_size=4, max_size=4),
        st.integers(min_value=0, max_value=7),
    )
    def test_indexed_membership(self, idxs, vs, probe):
        """C[idx_array, 'x'] answers membership exactly under gathers."""
        idx_arr = jnp.asarray(idxs)
        v_arr = jnp.asarray(vs[: len(idxs)])
        chm = C[idx_arr, "x"].set(v_arr)
        got = chm.get_submap(probe, "x").get_value()
        if probe in idxs:
            want = vs[idxs.index(probe)]
            if isinstance(got, Mask):
                assert bool(got.primal_flag())
                got = got.value
            assert jnp.isclose(jnp.float32(got), jnp.float32(want))
        else:
            assert got is None or (
                isinstance(got, Mask) and not bool(got.primal_flag())
            )

    @settings(max_examples=30, deadline=None)
    @given(
        st.integers(min_value=0, max_value=3),
        st.integers(min_value=4, max_value=7),
        _leaf_values,
        _leaf_values,
    )
    def test_disjoint_indexed_merge(self, i1, i2, v1, v2):
        chm = C[i1, "x"].set(v1) | C[i2, "x"].set(v2)
        g1 = chm.get_submap(i1, "x").get_value()
        g2 = chm.get_submap(i2, "x").get_value()

        def unwrap(m):
            return m.value if isinstance(m, Mask) else m

        assert jnp.isclose(jnp.float32(unwrap(g1)), jnp.float32(v1))
        assert jnp.isclose(jnp.float32(unwrap(g2)), jnp.float32(v2))

    @settings(max_examples=30, deadline=None)
    @given(st.integers(min_value=0, max_value=5), _leaf_values, selections)
    def test_filter_through_indexed(self, idx, v, sel):
        """Filtering an Indexed node keeps/drops the same leaves as
        filtering its inner map (the index wrapper is transparent to
        string-keyed selections)."""
        inner = ChoiceMap.kw(x=v)
        chm = inner.extend(jnp.asarray(idx))
        filtered = chm.get_submap(idx).filter(sel)
        direct = inner.filter(sel)
        a = _lookup(filtered, ("x",))
        b = _lookup(direct, ("x",))
        assert (a is None) == (b is None)


class TestFlagMaskAlgebra:
    @settings(max_examples=40, deadline=None)
    @given(tries, st.booleans(), st.booleans())
    def test_mask_composition_is_conjunction(self, d, f1, f2):
        """chm.mask(f1).mask(f2) holds a value iff f1 & f2 (flags compose
        conjunctively through nested Masks)."""
        import jax.numpy as jnp

        chm = ChoiceMap.d(d)
        composed = chm.mask(jnp.asarray(f1)).mask(jnp.asarray(f2))
        direct = chm.mask(jnp.asarray(f1 and f2))
        for path, v in _paths(d):
            a, b = _lookup(composed, path), _lookup(direct, path)
            assert (a is None) == (b is None), (path, f1, f2)
            if a is not None:
                assert jnp.isclose(jnp.float32(a), jnp.float32(v))

    @settings(max_examples=30, deadline=None)
    @given(tries, st.booleans())
    def test_masked_or_left_priority_respects_flags(self, d, flag):
        """An invalidly-masked left operand yields to the right."""
        import jax.numpy as jnp

        chm = ChoiceMap.d(d)
        shadow = ChoiceMap.d({k: -999.0 for k in d})
        merged = shadow.mask(jnp.asarray(flag)) | chm
        for k, v in d.items():
            if isinstance(v, dict):
                continue
            got = _lookup(merged, (k,))
            want = -999.0 if flag else v
            assert got is not None
            assert jnp.isclose(jnp.float32(got), jnp.float32(want)), (k, flag)


class TestSelectionRoundTrips:
    @settings(max_examples=40, deadline=None)
    @given(tries)
    def test_get_selection_selects_exactly_own_leaves(self, d):
        chm = ChoiceMap.d(d)
        sel = chm.get_selection()
        for path, _ in _paths(d):
            assert path in sel, path
        # And filtering by it is the identity on values.
        kept = chm.filter(sel)
        for path, v in _paths(d):
            got = _lookup(kept, path)
            assert got is not None
            import jax.numpy as jnp

            assert jnp.isclose(jnp.float32(got), jnp.float32(v))

    @settings(max_examples=40, deadline=None)
    @given(st.lists(st.sampled_from(KEYS), min_size=1, max_size=3))
    def test_extend_then_query_round_trip(self, path):
        sel = S[tuple(path)]
        assert tuple(path) in sel
        # Strict prefixes are on the way but not themselves selected;
        # extensions ARE selected (subtree semantics, reference
        # choice_map.py:112-117 — selecting a submodel address covers its
        # whole choice subtree).
        for cut in range(1, len(path)):
            assert tuple(path[:cut]) not in sel
        assert (*path, "zz") in sel
        # S[()] is the this-node-only leaf selection.
        assert "zz" not in S[()]

    @settings(max_examples=30, deadline=None)
    @given(tries, selections, selections)
    def test_and_is_intersection_on_filters(self, d, s1, s2):
        chm = ChoiceMap.d(d)
        lhs = chm.filter(s1 & s2)
        via_both = chm.filter(s1).filter(s2)
        for path, _ in _paths(d):
            assert (_lookup(lhs, path) is None) == (
                _lookup(via_both, path) is None
            ), path


class TestSwitchIndexedInteraction:
    @settings(max_examples=30, deadline=None)
    @given(
        st.integers(min_value=0, max_value=1),
        st.integers(min_value=0, max_value=3),
        _leaf_values,
        _leaf_values,
    )
    def test_switch_of_indexed_constraints(self, which, idx, v1, v2):
        """A Switch whose branches hold Indexed nodes resolves membership
        through both the branch mask and the index gather."""
        import jax.numpy as jnp
        from genjax_tpu import Mask

        c1 = C[jnp.asarray(idx), "x"].set(jnp.asarray(v1))
        c2 = C[jnp.asarray(idx), "x"].set(jnp.asarray(v2))
        sw = ChoiceMap.switch(jnp.asarray(which), [c1, c2])
        got = sw.get_submap(idx, "x").get_value()
        want = v1 if which == 0 else v2
        if isinstance(got, Mask):
            assert bool(jnp.all(got.primal_flag()))
            got = got.value
        assert jnp.isclose(jnp.float32(got), jnp.float32(want))
        # A different index is invalid through every branch.
        miss = sw.get_submap(idx + 4, "x").get_value()
        assert miss is None or (
            isinstance(miss, Mask) and not bool(jnp.any(miss.primal_flag()))
        )


class TestInvalidSubset:
    def test_detects_unsupported_address(self):
        import jax

        import genjax_tpu as gx

        @gx.gen
        def m():
            x = gx.normal(0.0, 1.0) @ "x"
            return x

        good = ChoiceMap.kw(x=1.0)
        assert good.invalid_subset(m, ()) is None
        bad = ChoiceMap.kw(x=1.0, typo=2.0)
        extras = bad.invalid_subset(m, ())
        assert extras is not None
        assert "typo" in extras and "x" not in extras


class TestWildcardZeroOrOne:
    """`...` matches zero or one address components — the property that
    makes `S[..., "z"]` valid in both the positional (scan/vmap edit) and
    structural (vectorized-trie filter) address spaces."""

    def test_flat_trie_match(self):
        chm = ChoiceMap.kw(z=jnp.arange(3.0), y=jnp.ones(3))
        kept = chm.filter(S[..., "z"])
        assert _lookup(kept, ("z",)) is not None
        assert _lookup(kept, ("y",)) is None

    def test_one_level_match(self):
        chm = ChoiceMap.entry(ChoiceMap.kw(z=1.0), "sub")
        kept = chm.filter(S[..., "z"])
        assert _lookup(kept, ("sub", "z")) is not None

    @settings(max_examples=30, deadline=None)
    @given(tries, st.sampled_from(KEYS))
    def test_wildcard_superset_of_plain(self, d, k):
        """S[..., k] keeps every leaf S[k] keeps (zero-level branch) plus
        any one level deeper."""
        chm = ChoiceMap.d(d)
        plain = chm.filter(S[k])
        wild = chm.filter(S[..., k])
        for path, _ in _paths(d):
            if _lookup(plain, path) is not None:
                assert _lookup(wild, path) is not None


class TestSelectionSemantics:
    """Membership of random paths in random selection expressions follows
    Boolean set semantics exactly (reference test_choice_maps.py's
    selection-law block)."""

    _paths_strategy = st.lists(
        st.sampled_from(KEYS), min_size=1, max_size=3
    ).map(tuple)

    @settings(max_examples=80, deadline=None)
    @given(_paths_strategy, _sel_exprs(2), _sel_exprs(2))
    def test_or_and_not_membership(self, path, s1, s2):
        assert (path in (s1 | s2)) == ((path in s1) or (path in s2))
        assert (path in (s1 & s2)) == ((path in s1) and (path in s2))
        assert (path in ~s1) == (path not in s1)

    @settings(max_examples=40, deadline=None)
    @given(_paths_strategy, _sel_exprs(1))
    def test_de_morgan_membership(self, path, s):
        assert (path in ~(s | Selection.none())) == (path in ~s)
        assert (path in (s & Selection.all())) == (path in s)
        assert path not in (s & Selection.none())
        assert path in (s | Selection.all())

    @settings(max_examples=40, deadline=None)
    @given(_paths_strategy)
    def test_prefix_selection_covers_subtrees(self, path):
        """S[p] selects p and every extension of p (subtree semantics)."""
        sel = S[path]
        assert path in sel
        assert (*path, "deeper") in sel


class TestMergeLaws:
    @settings(max_examples=40, deadline=None)
    @given(tries, tries, tries)
    def test_or_associative_observationally(self, d1, d2, d3):
        a, b, c = ChoiceMap.d(d1), ChoiceMap.d(d2), ChoiceMap.d(d3)
        lhs = (a | b) | c
        rhs = a | (b | c)
        for d in (d1, d2, d3):
            for path, _ in _paths(d):
                l, r = _lookup(lhs, path), _lookup(rhs, path)
                assert (l is None) == (r is None), path
                if l is not None:
                    assert jnp.isclose(jnp.float32(l), jnp.float32(r))

    @settings(max_examples=40, deadline=None)
    @given(tries)
    def test_or_idempotent(self, d):
        chm = ChoiceMap.d(d)
        merged = chm | chm
        for path, v in _paths(d):
            got = _lookup(merged, path)
            assert got is not None
            assert jnp.isclose(jnp.float32(got), jnp.float32(v))

    @settings(max_examples=40, deadline=None)
    @given(tries, st.sampled_from(KEYS))
    def test_extend_round_trip(self, d, prefix):
        chm = ChoiceMap.d(d)
        extended = chm.extend(prefix)
        inner = extended(prefix)
        for path, v in _paths(d):
            got = _lookup(inner, path)
            assert got is not None, path
            assert jnp.isclose(jnp.float32(got), jnp.float32(v))
            also = _lookup(extended, (prefix, *path))
            assert also is not None
            assert jnp.isclose(jnp.float32(also), jnp.float32(v))


class TestGFICoupling:
    """Random tries drive generate/assess on a model with the same
    address structure: the algebra must agree with the GFI's view
    (the reference couples its hypothesis suite to importance calls)."""

    @settings(max_examples=25, deadline=None)
    @given(tries)
    def test_assess_score_is_sum_of_leaf_densities(self, d):
        import jax

        from genjax_tpu import gen, normal

        paths = [p for p, _ in _paths(d)]

        @gen
        def model():
            for p in paths:
                _ = normal(0.0, 10.0) @ p

        chm = ChoiceMap.d(d)
        score, _ = model.assess(chm, ())
        expected = sum(
            -0.5 * (v / 10.0) ** 2 - jnp.log(10.0) - 0.5 * jnp.log(2 * jnp.pi)
            for _, v in _paths(d)
        )
        assert jnp.allclose(score, expected, atol=1e-4)

    @settings(max_examples=25, deadline=None)
    @given(tries, _sel_exprs(1))
    def test_importance_weight_matches_filtered_constraint(self, d, sel):
        """generate with a filtered constraint: the weight is exactly the
        density of the leaves the filter kept."""
        import jax

        from genjax_tpu import gen, normal

        paths = [p for p, _ in _paths(d)]

        @gen
        def model():
            for p in paths:
                _ = normal(0.0, 10.0) @ p

        chm = ChoiceMap.d(d)
        kept = chm.filter(sel)
        _, w = model.importance(jax.random.key(0), kept, ())
        expected = sum(
            -0.5 * (v / 10.0) ** 2 - jnp.log(10.0) - 0.5 * jnp.log(2 * jnp.pi)
            for p, v in _paths(d)
            if _lookup(kept, p) is not None
        )
        assert jnp.allclose(w, jnp.float32(expected), atol=1e-4)
