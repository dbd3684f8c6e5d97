"""The multichip dryrun must certify NUMBERS, not shapes.

A dryrun that asserted only isfinite/shape would stay green even if a
collective regression skewed every LML by 2x. The dryrun now asserts oracle/dense
agreement for every driver; this test proves the certification has
teeth by breaking a collective on purpose — a sharded LML that counts
only ONE shard's probability mass (exactly what a dropped psum does)
must flip the dryrun to failure.
"""

import jax
import jax.numpy as jnp
import pytest
from jax.scipy.special import logsumexp

import __graft_entry__ as graft
from genjax_tpu import parallel
from genjax_tpu.parallel import smc as parallel_smc


def test_dryrun_passes_when_collectives_work():
    # The honest run certifies on the 8-device virtual mesh (conftest).
    graft.dryrun_multichip(8)


def test_dryrun_fails_on_dropped_psum(monkeypatch):
    n_dev = 8

    def broken_sharded_lml(log_weights, mesh, axis="particles"):
        # Emulates sharded_lml with its psum dropped: the reduction sees
        # only the first shard's weights, under-counting the total
        # probability mass by ~log(n_devices).
        k = log_weights.shape[0]
        local = log_weights[: k // n_dev]
        return logsumexp(local) - jnp.log(float(k))

    # ShardedSMC.lml resolves sharded_lml from its module globals, so
    # patching the module attribute breaks every caller.
    monkeypatch.setattr(parallel_smc, "sharded_lml", broken_sharded_lml)
    if hasattr(parallel, "sharded_lml"):
        monkeypatch.setattr(parallel, "sharded_lml", broken_sharded_lml)

    with pytest.raises(AssertionError, match="dense logsumexp|oracle"):
        graft.dryrun_multichip(n_dev)


def test_dryrun_fails_on_skewed_rejuvenation(monkeypatch):
    # A second, independent failure mode: rejuvenation that silently
    # biases the particle values (e.g. a wrong collective permutation
    # would) must trip the posterior-moment certification.
    real_rejuvenate = parallel_smc.ShardedSMC.rejuvenate

    def biased_rejuvenate(self, key, collection, request):
        col = real_rejuvenate(self, key, collection, request)
        particles = col.get_particles()
        # Shift every particle's latent by +1: a gross posterior bias.
        from genjax_tpu import ChoiceMap
        from genjax_tpu.core.diff import Diff
        from genjax_tpu.core.gfi import Update
        from genjax_tpu.inference.mcmc import _chain_axes

        axes = _chain_axes(particles, self.n_particles)

        def shift(k, tr):
            new_tr, _, _, _ = Update(
                ChoiceMap.kw(x=tr.get_choices()["x"] + 1.0)
            ).edit(k, tr, Diff.no_change(tr.get_args()))
            return new_tr

        keys = jax.random.split(key, self.n_particles)
        shifted = jax.vmap(shift, in_axes=(0, axes), out_axes=axes)(
            keys, particles
        )
        return type(col)(
            particles=shifted,
            log_weights=col.get_log_weights(),
            is_valid=col.is_valid,
        )

    monkeypatch.setattr(
        parallel_smc.ShardedSMC, "rejuvenate", biased_rejuvenate
    )
    with pytest.raises(AssertionError, match="posterior mean"):
        graft.dryrun_multichip(8)
