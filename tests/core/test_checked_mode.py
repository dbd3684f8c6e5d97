"""Opt-in GFI input validation (`checked_mode`) — the native answer to
the reference's beartype-at-import error ergonomics: targeted messages for the classic call mistakes, zero cost when
off."""

import jax
import jax.numpy as jnp
import pytest

import genjax_tpu as gx
from genjax_tpu import ChoiceMap, checked_mode


@gx.gen
def _model(mu):
    x = gx.normal(mu, 1.0) @ "x"
    _ = gx.normal(x, 1.0) @ "y"
    return x


class TestCheckedMode:
    def test_raw_seed_instead_of_key(self):
        with checked_mode():
            with pytest.raises(TypeError, match="PRNG key"):
                _model.simulate(42, (0.0,))

    def test_args_not_a_tuple(self):
        with checked_mode():
            with pytest.raises(TypeError, match="TUPLE"):
                _model.simulate(jax.random.key(0), 0.0)

    def test_dict_instead_of_choice_map(self):
        with checked_mode():
            with pytest.raises(TypeError, match="ChoiceMap.d"):
                _model.generate(jax.random.key(0), {"y": 1.0}, (0.0,))
            with pytest.raises(TypeError, match="ChoiceMap"):
                _model.assess({"x": 0.0, "y": 1.0}, (0.0,))

    def test_non_request_edit(self):
        tr = _model.simulate(jax.random.key(0), (0.0,))
        with checked_mode():
            with pytest.raises(TypeError, match="EditRequest"):
                _model.edit(
                    jax.random.key(1),
                    tr,
                    ChoiceMap.kw(x=1.0),  # forgot to wrap in Update(...)
                    gx.Diff.no_change((0.0,)),
                )

    def test_distribution_entry_points(self):
        with checked_mode():
            with pytest.raises(TypeError, match="PRNG key"):
                gx.normal.simulate(0, (0.0, 1.0))
            with pytest.raises(TypeError, match="TUPLE"):
                gx.normal.simulate(jax.random.key(0), 0.0)

    def test_valid_calls_pass_and_mode_restores(self):
        with checked_mode():
            tr = _model.simulate(jax.random.key(0), (0.0,))
            score, _ = _model.assess(tr.get_choices(), (0.0,))
            assert jnp.isclose(score, tr.get_score())
        # Outside the block the (invalid) call fails differently — the
        # checks are off again.
        from genjax_tpu.core.checked import is_checked

        assert not is_checked()

    def test_checked_calls_work_under_jit(self):
        """The checks run at trace time; compiled execution is unaffected."""
        with checked_mode():
            f = jax.jit(lambda k: _model.simulate(k, (0.0,)).get_score())
            assert jnp.isfinite(f(jax.random.key(0)))


class TestConstructorValidation:
    """Round-3 extension: typed errors for malformed
    inputs to the most-used constructors/combinators, under the gate."""

    def test_target_args_must_be_tuple(self):
        from genjax_tpu.inference import Target

        with checked_mode():
            with pytest.raises(TypeError, match="TUPLE"):
                Target(_model, 0.0, ChoiceMap.kw(x=1.0))

    def test_target_constraint_must_be_choice_map(self):
        from genjax_tpu.inference import Target

        with checked_mode():
            with pytest.raises(TypeError, match="ChoiceMap"):
                Target(_model, (0.0,), {"x": 1.0})

    def test_mask_rejects_non_flag(self):
        chm = ChoiceMap.kw(x=1.0)
        with checked_mode():
            with pytest.raises(TypeError, match="flag"):
                chm.mask("x")

    def test_filter_rejects_non_selection(self):
        chm = ChoiceMap.kw(x=1.0)
        with checked_mode():
            with pytest.raises(TypeError, match="[Ss]election"):
                chm.filter("x")

    def test_merge_rejects_dict(self):
        chm = ChoiceMap.kw(x=1.0)
        with checked_mode():
            with pytest.raises(TypeError, match="ChoiceMap"):
                chm | {"y": 2.0}

    def test_selection_operand_types(self):
        from genjax_tpu import SelectionBuilder as S

        with checked_mode():
            with pytest.raises(TypeError, match="Selection"):
                S["x"] | "y"
            with pytest.raises(TypeError, match="Selection"):
                S["x"] & "y"

    def test_selection_filter_rejects_dict(self):
        from genjax_tpu import SelectionBuilder as S

        with checked_mode():
            with pytest.raises(TypeError, match="ChoiceMap"):
                S["x"].filter({"x": 1.0})

    def test_unchecked_stays_permissive(self):
        # Outside checked mode nothing new is validated (zero-cost default).
        chm = ChoiceMap.kw(x=1.0)
        kept = chm.filter(gx.Selection.at["x"])
        assert "x" in kept
