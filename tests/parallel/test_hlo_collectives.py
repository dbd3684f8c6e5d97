"""Compiled-HLO inspection of the sharded paths:
regressions in collective placement must fail CI instead of silently
serializing. On the 8-device virtual CPU mesh we assert that

(i)   the resampling exchange all-gathers ONLY the K-float weight vector
      (never the particle payload),
(ii)  LML/ESS lower to scalar-sized cross-shard reductions, and
(iii) particle state stays sharded through rejuvenation (no all-gather
      at all in the rejuvenation program).
"""

import re

import jax
import jax.numpy as jnp
import pytest

import genjax_tpu as g
from genjax_tpu import ChoiceMap, Regenerate, Selection, Target
from genjax_tpu.parallel import ShardedSMC, particle_mesh, sharded_ess, sharded_lml

K = 1024
D = 64  # per-particle payload of D floats dwarfs the K-float weights


@g.gen
def wide_model():
    w = g.mv_normal_diag(jnp.zeros(D), jnp.ones(D)) @ "w"
    _ = g.normal(jnp.sum(w), 1.0) @ "y"


@pytest.fixture(scope="module")
def mesh():
    return particle_mesh()


@pytest.fixture(scope="module")
def smc(mesh):
    return ShardedSMC(n_particles=K, mesh=mesh, ess_threshold=2.0)


@pytest.fixture(scope="module")
def collection(smc):
    tgt = Target(wide_model, (), ChoiceMap.kw(y=1.0))
    return jax.jit(smc.init)(jax.random.key(0), tgt)


def _split_computations(hlo_text: str) -> dict[str, str]:
    """Map computation name -> body text for an HLO module dump."""
    comps = {}
    name = None
    body: list[str] = []
    for line in hlo_text.splitlines():
        m = re.match(r"^(ENTRY\s+)?%?([\w.\-]+)\s*\([^)]*\)\s*->.*{", line)
        if m:
            name = m.group(2)
            body = [line]
        elif name is not None:
            body.append(line)
            if line.strip() == "}":
                comps[name] = "\n".join(body)
                name = None
    return comps


def _branch_computations(hlo_text: str) -> set[str]:
    """Names of computations invoked as conditional branches."""
    names: set[str] = set()
    for m in re.finditer(
        r"conditional\([^)]*\)[^\n]*", hlo_text
    ):
        for cm in re.finditer(
            r"(?:true_computation|false_computation|branch_computations=\{[^}]*)"
            r"=?%?([\w.\-]+)",
            m.group(0),
        ):
            names.add(cm.group(1))
        for cm in re.finditer(r"%([\w.\-]+)", m.group(0)):
            names.add(cm.group(1))
    return names


def gathered_element_counts(hlo_text: str, exclude_branches: bool = False):
    """Element counts of every all-gather RESULT in the HLO. With
    `exclude_branches`, all-gathers inside conditional branch
    computations (cold fallback paths) are skipped."""
    if exclude_branches:
        comps = _split_computations(hlo_text)
        branch_names = _branch_computations(hlo_text)
        kept = [
            body
            for cname, body in comps.items()
            if not any(cname.startswith(b) or b.startswith(cname)
                       for b in branch_names)
        ]
        hlo_text = "\n".join(kept) if kept else hlo_text
    counts = []
    for m in re.finditer(
        r"=\s*\(?([a-z0-9]+)\[([\d,]*)\][^=]*?\ball-gather", hlo_text
    ):
        dims = m.group(2)
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        counts.append(n)
    return counts


def reduce_element_counts(hlo_text: str) -> list[int]:
    counts = []
    for m in re.finditer(
        r"=\s*\(?([a-z0-9]+)\[([\d,]*)\][^=]*?\ball-reduce", hlo_text
    ):
        dims = m.group(2)
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        counts.append(n)
    return counts


class TestResampleExchange:
    def test_all_gather_moves_only_weights(self, smc, collection):
        hlo = (
            jax.jit(smc.resample)
            .lower(jax.random.key(1), collection)
            .compile()
            .as_text()
        )
        gathers = gathered_element_counts(hlo, exclude_branches=True)
        assert gathers, "expected the weight all-gather in the resample HLO"
        # Every HOT-PATH all-gather must be weight-sized (~K elements),
        # never the K x D particle payload. (The far-hop fallback branch
        # inside the conditional may gather rows; it is excluded.)
        for n in gathers:
            assert n <= 2 * K, (
                f"hot-path all-gather of {n} elements found (> weight-"
                f"sized {K}); the particle payload is being gathered "
                f"unconditionally."
            )
        # And the exchange must actually ride collective-permutes.
        assert "collective-permute" in hlo, (
            "expected neighbor ppermutes in the resample exchange"
        )


class TestScalarReductions:
    def test_lml_is_scalar_reduction(self, mesh):
        lw = jax.random.normal(jax.random.key(2), (K,))
        hlo = (
            jax.jit(lambda w: sharded_lml(w, mesh))
            .lower(lw)
            .compile()
            .as_text()
        )
        counts = reduce_element_counts(hlo)
        assert counts, "expected a cross-shard all-reduce in the LML HLO"
        assert all(n <= 8 for n in counts), (
            f"LML reduction moved non-scalar payloads: {counts}"
        )
        assert not gathered_element_counts(hlo), (
            "LML should reduce, not gather"
        )

    def test_ess_is_scalar_reduction(self, mesh):
        lw = jax.random.normal(jax.random.key(3), (K,))
        hlo = (
            jax.jit(lambda w: sharded_ess(w, mesh))
            .lower(lw)
            .compile()
            .as_text()
        )
        counts = reduce_element_counts(hlo)
        assert counts
        assert all(n <= 8 for n in counts), (
            f"ESS reduction moved non-scalar payloads: {counts}"
        )


class TestRejuvenationStaysSharded:
    def test_no_all_gather_in_rejuvenation(self, smc, collection):
        req = Regenerate(Selection.at["w"])
        hlo = (
            jax.jit(smc.rejuvenate)
            .lower(jax.random.key(4), collection, req)
            .compile()
            .as_text()
        )
        gathers = gathered_element_counts(hlo)
        big = [n for n in gathers if n > 2 * K]
        assert not big, (
            f"rejuvenation gathered particle-sized payloads: {big}"
        )

    def test_rejuvenated_particles_remain_sharded(self, smc, collection):
        req = Regenerate(Selection.at["w"])
        out = jax.jit(smc.rejuvenate)(jax.random.key(4), collection, req)
        w_leaf = out.get_particles().get_choices()["w"]
        sharding = w_leaf.sharding
        # The particle axis must still be split across all 8 devices.
        assert len(sharding.device_set) == 8, (
            f"particle leaf collapsed to {sharding}"
        )
