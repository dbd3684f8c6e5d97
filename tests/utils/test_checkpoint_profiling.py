"""Checkpoint/resume and profiling aux subsystems
(round-trip a sharded ParticleCollection through `utils/checkpoint.py` on
the 8-device mesh; assert the restored state resumes an SMC run
bit-identically)."""

import os

import jax
import jax.numpy as jnp
import jax.tree_util as jtu

import genjax_tpu as g
from genjax_tpu import ChoiceMap, Regenerate, Selection, Target
from genjax_tpu.parallel import ShardedSMC, particle_mesh
from genjax_tpu.utils.checkpoint import restore_checkpoint, save_checkpoint
from genjax_tpu.utils.profiling import annotate, profile_trace


@g.gen
def _conjugate():
    x = g.normal(0.0, 1.0) @ "x"
    _ = g.normal(x, 1.0) @ "y"
    return x


class TestCheckpointRoundTrip:
    def test_sharded_collection_roundtrip_and_resume(self, tmp_path):
        mesh = particle_mesh()
        target = Target(_conjugate, (), ChoiceMap.kw(y=1.0))
        smc = ShardedSMC(n_particles=64, mesh=mesh)
        key = jax.random.key(0)
        k_init, k_resume = jax.random.split(key)
        coll = jax.jit(smc.init)(k_init, target)

        path = os.path.join(tmp_path, "ckpt")
        save_checkpoint(path, coll)
        restored = restore_checkpoint(path, coll)

        # Bit-identical state (weights + every trace leaf), shardings kept.
        for a, b in zip(jtu.tree_leaves(coll), jtu.tree_leaves(restored)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert jnp.array_equal(a, b)
        assert restored.log_weights.sharding == coll.log_weights.sharding

        # Resuming from the restored state is bit-identical to resuming
        # from the live state.
        def resume(c):
            c = smc.rejuvenate(k_resume, c, Regenerate(Selection.at["x"]))
            return smc.maybe_resample(jax.random.fold_in(k_resume, 1), c)

        resume = jax.jit(resume)
        out_live = resume(coll)
        out_restored = resume(restored)
        for a, b in zip(jtu.tree_leaves(out_live), jtu.tree_leaves(out_restored)):
            assert jnp.array_equal(a, b)
        assert jnp.array_equal(
            smc.lml(out_live), smc.lml(out_restored)
        )

    def test_plain_trace_roundtrip(self, tmp_path):
        tr = _conjugate.simulate(jax.random.key(3), ())
        path = os.path.join(tmp_path, "trace_ckpt")
        save_checkpoint(path, tr)
        restored = restore_checkpoint(path, tr)
        assert jnp.array_equal(tr.get_score(), restored.get_score())
        assert jnp.array_equal(
            tr.get_choices()["x"], restored.get_choices()["x"]
        )


class TestProfiling:
    def test_annotate_preserves_semantics_under_jit(self):
        @annotate("density-pass")
        def f(x):
            return jnp.sum(jnp.square(x))

        x = jnp.arange(8.0)
        assert jnp.allclose(jax.jit(f)(x), jnp.sum(jnp.square(x)))
        # The scope name must survive into the lowered HLO (it lives in
        # the debug/location info, stripped from the default text dump).
        hlo = jax.jit(f).lower(x).as_text(debug_info=True)
        assert "density-pass" in hlo

    def test_profile_trace_writes_capture(self, tmp_path):
        log_dir = os.path.join(tmp_path, "prof")
        with profile_trace(log_dir) as d:
            _ = jax.jit(lambda x: x * 2.0)(jnp.ones(16)).block_until_ready()
        produced = []
        for root, _dirs, files in os.walk(d):
            produced.extend(files)
        assert produced, "profiler trace produced no files"


class TestCostSummary:
    def test_cost_counters_present(self):
        import jax.numpy as jnp

        from genjax_tpu.utils.profiling import cost_summary

        s = cost_summary(lambda x: (x @ x.T).sum(), jnp.ones((64, 64)))
        assert s["flops"] >= 2 * 64 * 64 * 64
        assert s.get("bytes accessed", 0) > 0

    def test_cost_summary_on_gfi_method(self):
        import jax
        import jax.numpy as jnp

        import genjax_tpu as g

        @g.gen
        def model(X):
            w = g.mv_normal_diag(jnp.zeros(4), jnp.ones(4)) @ "w"
            _ = g.normal(X @ w, 1.0) @ "ys"

        from genjax_tpu.utils.profiling import cost_summary

        X = jnp.ones((16, 4))
        s = cost_summary(
            lambda k: model.simulate(k, (X,)).get_score(), jax.random.key(0)
        )
        assert s["flops"] > 0

    def test_device_memory_stats_shape(self):
        from genjax_tpu.utils.profiling import device_memory_stats

        stats = device_memory_stats()
        assert isinstance(stats, dict)  # may be empty on the CPU backend
