"""PRNG hygiene: across a composed SMC + rejuvenation run, every key that
reaches a distribution's `sample` must be distinct
(`ChangeTarget`/`ImportanceK`/`SMCDriver` previously reused parent keys;
the streams only differed by split arity, a latent trap).
"""

import jax
import jax.numpy as jnp
import numpy as np

import genjax_tpu as gx
from genjax_tpu.core.choice_map import ChoiceMap
from genjax_tpu.core.requests import Regenerate
from genjax_tpu.distributions.distribution import exact_density
from genjax_tpu.distributions.library import _normal_logpdf
from genjax_tpu.inference.smc import ImportanceK, SMCDriver
from genjax_tpu.inference.sp import Target

_RECORDED: list[tuple] = []


def _record(key_data) -> None:
    arr = np.asarray(key_data).reshape(-1, 2)
    for row in arr:
        _RECORDED.append((int(row[0]), int(row[1])))


def _recording_sample(key, mu, sigma):
    jax.debug.callback(_record, jax.random.key_data(key))
    return mu + sigma * jax.random.normal(key)


recording_normal = exact_density(
    _recording_sample, _normal_logpdf, "recording_normal"
)


@gx.gen
def _model():
    x = recording_normal(0.0, 1.0) @ "x"
    _ = recording_normal(x, 1.0) @ "obs"
    return x


def _assert_all_distinct():
    assert len(_RECORDED) > 0
    assert len(set(_RECORDED)) == len(_RECORDED), (
        f"duplicate sample keys: {len(_RECORDED) - len(set(_RECORDED))} of "
        f"{len(_RECORDED)}"
    )


class TestSampleKeyDiscipline:
    def test_smc_driver_with_rejuvenation(self):
        _RECORDED.clear()
        target = Target(_model, (), ChoiceMap.kw(obs=1.5))
        driver = SMCDriver(n_particles=8)
        key = jax.random.key(7)
        k_init, k_rej, k_res, k_ext = jax.random.split(key, 4)
        coll = driver.init(k_init, target)
        coll = driver.rejuvenate(k_rej, coll, Regenerate(gx.Selection.at["x"]))
        coll = driver.maybe_resample(k_res, coll)
        jax.block_until_ready(coll.log_weights)
        _assert_all_distinct()

    def test_importance_k_change_target_composition(self):
        _RECORDED.clear()
        target = Target(_model, (), ChoiceMap.kw(obs=0.25))
        alg = ImportanceK(target, k_particles=6)
        _, chm = alg.random_weighted(jax.random.key(3), target)
        jax.block_until_ready(chm["x"])
        _assert_all_distinct()
