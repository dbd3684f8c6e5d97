"""Aux subsystem tests: time travel, checkify gate, checkpointing,
profiling annotations, facade imports."""

import jax
import jax.numpy as jnp
import pytest

import genjax_tpu as g


class TestTimeTravel:
    def test_record_and_navigate(self):
        from genjax_tpu.time_travel import rec, tag, time_machine

        def program(x):
            a = rec(x + 1.0, "a")
            b = rec(a * 2.0, "b")
            c = tag(b - 0.5, "c")
            return c

        dbg = time_machine(program)(1.0)
        assert dbg.n_frames == 3
        assert dbg.retval == 3.5
        assert dbg.current() == 2.0
        dbg.fwd()
        assert dbg.current() == 4.0
        dbg.bwd()
        assert dbg.current() == 2.0
        dbg.jump("c")
        assert dbg.current() == 3.5

    def test_remix(self):
        from genjax_tpu.time_travel import rec, time_machine

        def program(x):
            a = rec(x + 1.0, "a")
            return rec(a * 2.0, "b")

        dbg = time_machine(program)(1.0)
        remixed = dbg.jump("a").remix(10.0)
        assert remixed.retval == 20.0

    def test_rec_outside_is_identity(self):
        from genjax_tpu.time_travel import rec

        assert rec(5.0, "x") == 5.0

    def test_works_under_jit(self):
        from genjax_tpu.time_travel import rec, time_machine

        @jax.jit
        def run(x):
            return time_machine(lambda v: rec(v * 2, "a") + 1)(x).retval

        assert run(2.0) == 5.0


class TestCheckify:
    def test_gate_off_by_default(self):
        from genjax_tpu.checkify import do_checkify, should_check

        assert not should_check()
        with do_checkify():
            assert should_check()
        assert not should_check()

    def test_optional_check_runs_only_inside(self):
        from genjax_tpu.checkify import do_checkify, optional_check

        ran = []
        optional_check(lambda: ran.append(1))
        assert not ran
        with do_checkify():
            optional_check(lambda: ran.append(1))
        assert ran == [1]


class TestCheckpoint:
    def test_roundtrip_particle_collection(self, tmp_path):
        from genjax_tpu.inference.smc import ImportanceK
        from genjax_tpu.inference.sp import Target
        from genjax_tpu.utils.checkpoint import restore_checkpoint, save_checkpoint

        @g.gen
        def model():
            x = g.normal(0.0, 1.0) @ "x"
            _ = g.normal(x, 1.0) @ "y"

        target = Target(model, (), g.ChoiceMap.kw(y=1.0))
        col = ImportanceK(target, k_particles=64).run_smc(jax.random.key(0))
        state = {
            "log_weights": col.get_log_weights(),
            "choices_x": col.get_particles().get_choices()["x"],
        }
        path = str(tmp_path / "ckpt")
        save_checkpoint(path, state)
        restored = restore_checkpoint(path, jax.tree_util.tree_map(jnp.zeros_like, state))
        assert jnp.allclose(restored["log_weights"], state["log_weights"])
        assert jnp.allclose(restored["choices_x"], state["choices_x"])


class TestProfiler:
    def test_annotate(self):
        from genjax_tpu.utils.profiling import annotate

        @annotate("my_step")
        def f(x):
            return x * 2

        assert jax.jit(f)(2.0) == 4.0


class TestFacades:
    def test_incremental_module(self):
        from genjax_tpu.incremental import Diff, NoChange, UnknownChange

        d = Diff(1.0, NoChange)
        assert d.get_primal() == 1.0

    def test_typing_module(self):
        from genjax_tpu.typing import FloatArray, PRNGKey  # noqa: F401

    def test_experimental_module(self):
        import genjax_tpu.experimental as experimental

        assert experimental.__all__ == []

    def test_top_level_surface(self):
        # the README-quickstart names all resolve
        for name in [
            "gen", "beta", "flip", "normal", "Target", "ChoiceMap",
            "ChoiceMapBuilder", "SelectionBuilder", "Selection", "Mask",
            "Diff", "Update", "Regenerate", "EmptyRequest", "DiffAnnotate",
            "vmap", "scan", "switch", "mask", "mix", "or_else", "repeat",
            "dimap", "map", "contramap", "accumulate", "reduce", "iterate",
            "iterate_final", "masked_iterate", "masked_iterate_final",
            "IndexRequest", "StaticGenerativeFunction", "Trace",
            "GenerativeFunction", "DiscreteHMM", "marginal", "pretty",
            "Pytree", "Const", "Closure",
        ]:
            assert hasattr(g, name), name
        from genjax_tpu.inference import requests, smc, vi  # noqa: F401
        from genjax_tpu.inference.smc import ChangeTarget, Importance, ImportanceK, SMCAlgorithm  # noqa: F401
        from genjax_tpu.inference.requests import HMC, Rejuvenate, SafeHMC  # noqa: F401
        from genjax_tpu.inference.vi import ELBO, IWELBO, PWake, QWake, adev_distribution  # noqa: F401
        from genjax_tpu.adev import expectation, Dual, ADEVPrimitive, sample_primitive  # noqa: F401
