"""genjax_tpu: an accelerator-native probabilistic programming framework.

A from-scratch implementation of the Gen generative function interface
(GFI) on JAX/XLA, designed for accelerator hardware: dense pytree traces,
handler-based `@gen` tracing (no jaxpr interpretation on GFI paths), a
native distribution library, and vectorized + mesh-sharded inference
(SIR/SMC with distributed resampling, MCMC, VI/ADEV) that XLA compiles
for the device.

Capability reference: genjax-community/genjax (see SURVEY.md).

Quickstart — posterior inference on the README beta-bernoulli model:

>>> import jax, jax.numpy as jnp
>>> import genjax_tpu as gx
>>> @gx.gen
... def beta_bernoulli(a, b):
...     p = gx.beta(a, b) @ "p"
...     v = gx.flip(p) @ "v"
...     return v
>>> key = jax.random.key(0)
>>> target = gx.Target(beta_bernoulli, (2.0, 2.0), gx.ChoiceMap.kw(v=True))
>>> alg = gx.inference.smc.ImportanceK(target, k_particles=500)
>>> _, posterior_sample = alg.random_weighted(key, target)
>>> bool(0.0 < posterior_sample["p"] < 1.0)
True
"""

from genjax_tpu import adev, inference
from genjax_tpu.inference import requests, smc, vi
from genjax_tpu.combinators import *  # noqa: F401,F403
from genjax_tpu.combinators import __all__ as _cmb_all
from genjax_tpu.core import *  # noqa: F401,F403
from genjax_tpu.core import __all__ as _core_all
from genjax_tpu.distributions import *  # noqa: F401,F403
from genjax_tpu.distributions import __all__ as _dist_all
from genjax_tpu.distributions.discrete_hmm import (
    DiscreteHMM,
    DiscreteHMMConfiguration,
    forward_filtering_backward_sampling,
)
from genjax_tpu.inference.sp import (
    Algorithm,
    Marginal,
    SampleDistribution,
    Target,
    marginal,
)
from genjax_tpu.lang import *  # noqa: F401,F403
from genjax_tpu.lang import __all__ as _lang_all
from genjax_tpu.utils.pretty import pretty
from genjax_tpu.utils.time_travel import rec, tag, time_machine

__version__ = "0.1.0"

__all__ = [  # noqa: PLE0604
    *_core_all,
    *_dist_all,
    *_lang_all,
    *_cmb_all,
    "Algorithm",
    "DiscreteHMM",
    "DiscreteHMMConfiguration",
    "Marginal",
    "SampleDistribution",
    "Target",
    "adev",
    "forward_filtering_backward_sampling",
    "inference",
    "marginal",
    "pretty",
    "rec",
    "requests",
    "smc",
    "tag",
    "time_machine",
    "vi",
]

# Whole-API validation wrappers (reference beartype parity; ON by
# default — `core.typecheck.do_typecheck(False)` disables, and
# `checked_mode()` / `do_checked(True)` adds the deeper GFI entry
# validation — see core/typecheck.py).
import sys as _sys  # noqa: E402

from genjax_tpu.core import typecheck as _typecheck  # noqa: E402

_typecheck.instrument(_sys.modules[__name__])
