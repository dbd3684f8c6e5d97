"""Scan IndexRequest: O(1) single-step edit + next-step revisit."""

import jax
import jax.numpy as jnp

import genjax_tpu as g
from genjax_tpu import ChoiceMap, Diff, IndexRequest, Update


@g.gen
def resampled_step(carry, _x):
    # carry-out is the sampled value itself: carry-out at step t+1 is
    # fully determined by step t+1's own choice, so the single-step +
    # next-step-revisit edit is sound for this model family.
    z = g.normal(carry, 1.0) @ "z"
    return z, 2.0 * z


class TestScanEditIndex:
    def setup_method(self):
        self.model = resampled_step.scan(n=8)
        self.tr = self.model.simulate(jax.random.key(0), (0.5, None))

    def test_single_step_update(self):
        idx = jnp.array(3)
        req = IndexRequest(idx, Update(ChoiceMap.kw(z=9.0)))
        new_tr, w, _, bwd = req.edit(
            jax.random.key(1), self.tr, Diff.no_change((0.5, None))
        )
        old_z = self.tr.get_choices()["z"]
        new_z = new_tr.get_choices()["z"]
        assert jnp.allclose(new_z[3], 9.0)
        # all other steps' values retained
        mask = jnp.arange(8) != 3
        assert jnp.allclose(new_z[mask], old_z[mask])
        assert isinstance(bwd, IndexRequest)

    def test_weight_matches_score_delta(self):
        idx = jnp.array(3)
        req = IndexRequest(idx, Update(ChoiceMap.kw(z=1.5)))
        new_tr, w, _, _ = req.edit(
            jax.random.key(1), self.tr, Diff.no_change((0.5, None))
        )
        assert jnp.allclose(w, new_tr.get_score() - self.tr.get_score(), atol=1e-4)

    def test_scores_recomputed_for_next_step(self):
        """Step idx+1's density must be re-evaluated against the new
        carry-in (= the new z at idx)."""
        idx = jnp.array(2)
        req = IndexRequest(idx, Update(ChoiceMap.kw(z=5.0)))
        new_tr, w, _, _ = req.edit(
            jax.random.key(1), self.tr, Diff.no_change((0.5, None))
        )
        z = new_tr.get_choices()["z"]
        # manually recompute the full joint
        prevs = jnp.concatenate([jnp.array([0.5]), z[:-1]])
        expected_score = jnp.sum(
            -0.5 * (z - prevs) ** 2 - 0.5 * jnp.log(2 * jnp.pi)
        )
        assert jnp.allclose(new_tr.get_score(), expected_score, atol=1e-4)

    def test_edit_last_step(self):
        idx = jnp.array(7)
        req = IndexRequest(idx, Update(ChoiceMap.kw(z=4.0)))
        new_tr, w, _, _ = req.edit(
            jax.random.key(1), self.tr, Diff.no_change((0.5, None))
        )
        assert jnp.allclose(new_tr.get_choices()["z"][7], 4.0)
        # final carry tracks the edited last step
        carry_out, ys = new_tr.get_retval()
        assert jnp.allclose(carry_out, 4.0)
        assert jnp.allclose(w, new_tr.get_score() - self.tr.get_score(), atol=1e-4)

    def test_retval_ys_updated(self):
        idx = jnp.array(4)
        req = IndexRequest(idx, Update(ChoiceMap.kw(z=3.0)))
        new_tr, _, _, _ = req.edit(
            jax.random.key(1), self.tr, Diff.no_change((0.5, None))
        )
        _, ys = new_tr.get_retval()
        assert jnp.allclose(ys[4], 6.0)  # 2 * z


@g.gen
def accumulating_step(carry, _x):
    # carry-out = carry-in + z: the carry chain propagates any edit
    # downstream, so the O(1) IndexRequest edit is UNSOUND here.
    z = g.normal(0.0, 1.0) @ "z"
    return carry + z, z


class TestCarryStabilityGuard:
    """Round-3 soundness guard: a carry-unstable
    kernel must be caught under do_checkify instead of silently
    corrupting steps beyond idx+1."""

    def test_unstable_kernel_caught(self):
        import pytest

        from genjax_tpu.checkify import do_checkify

        model = accumulating_step.scan(n=6)
        tr = model.simulate(jax.random.key(0), (0.0, None))
        req = IndexRequest(jnp.array(2), Update(ChoiceMap.kw(z=5.0)))
        with do_checkify():
            with pytest.raises(Exception, match="carry"):
                req.edit(jax.random.key(1), tr, Diff.no_change((0.0, None)))

    def test_stable_kernel_passes_checkify(self):
        from genjax_tpu.checkify import do_checkify

        model = resampled_step.scan(n=6)
        tr = model.simulate(jax.random.key(0), (0.5, None))
        req = IndexRequest(jnp.array(2), Update(ChoiceMap.kw(z=5.0)))
        with do_checkify():
            new_tr, _, _, _ = req.edit(
                jax.random.key(1), tr, Diff.no_change((0.5, None))
            )
        assert jnp.allclose(new_tr.get_choices()["z"][2], 5.0)

    def test_edit_at_final_step_always_sound(self):
        from genjax_tpu.checkify import do_checkify

        model = accumulating_step.scan(n=6)
        tr = model.simulate(jax.random.key(0), (0.0, None))
        # Editing the LAST step has no downstream carry consumer; the
        # guard must not fire.
        req = IndexRequest(jnp.array(5), Update(ChoiceMap.kw(z=5.0)))
        with do_checkify():
            new_tr, _, _, _ = req.edit(
                jax.random.key(1), tr, Diff.no_change((0.0, None))
            )
        assert jnp.allclose(new_tr.get_choices()["z"][5], 5.0)
