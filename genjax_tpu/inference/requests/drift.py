"""`GaussianDrift`: symmetric Gaussian random-walk proposal as an edit
request.

New capability relative to the reference (SURVEY.md §2 C27 ships only
`Rejuvenate`/`HMC`; its cookbook hand-rolls random walks per model). A
drift move needs no gradients and no proposal program: perturb the
selected continuous addresses with elementwise Gaussian noise and let
`Update` reweight the joint. Because the proposal is symmetric, the
`Update` weight (the joint score delta) IS the MH log-acceptance ratio,
so this request composes directly with `inference.mcmc.mh`,
`TemperedSMC` rejuvenation, and `ParallelTempering` within-temperature
sweeps.

Accelerator notes: the proposal is one fused elementwise pass per leaf (no
gather, no control flow), and the whole move vmaps over particle/chain
batches like every other request.
"""

from typing import Any, TypeVar

import jax
import jax.numpy as jnp
import jax.random as jrand
import jax.tree_util as jtu

from genjax_tpu.core.concepts import Argdiffs, EditRequest, Retdiff, Weight
from genjax_tpu.core.diff import Diff
from genjax_tpu.core.gfi import Trace, Update
from genjax_tpu.core.pytree import Pytree
from genjax_tpu.core.choice_map import Selection
from genjax_tpu.core.typing import PRNGKey

R = TypeVar("R")

__all__ = ["GaussianDrift"]


def _scale_tree(scale: Any, like: Any) -> Any:
    """Broadcast a scale spec (scalar | pytree matching `like`) into a
    per-leaf tree of proposal standard deviations."""
    if isinstance(scale, (int, float)) or (
        isinstance(scale, jax.Array) and scale.ndim == 0
    ):
        return jtu.tree_map(
            lambda v: jnp.broadcast_to(
                jnp.asarray(scale, dtype=jnp.result_type(float)), jnp.shape(v)
            ),
            like,
        )
    return jtu.tree_map(
        lambda v, s: jnp.broadcast_to(s, jnp.shape(v)), like, scale
    )


@Pytree.dataclass(match_args=True)
class GaussianDrift(EditRequest):
    """Propose `v' = v + scale * xi`, `xi ~ N(0, I)`, on every selected
    address; the returned weight is the exact MH log-acceptance ratio.

    `scale` is a scalar or a pytree matching the selected choices
    (per-leaf standard deviations). The selected addresses must hold
    continuous values; selecting a discrete site will propose off-support
    values and `Update` will score them at -inf (always rejected), which
    is sound but useless.

    >>> import jax
    >>> import genjax_tpu as gx
    >>> from genjax_tpu.inference.requests import GaussianDrift
    >>> from genjax_tpu.inference.mcmc import mh
    >>> @gx.gen
    ... def model():
    ...     mu = gx.normal(0.0, 1.0) @ "mu"
    ...     _ = gx.normal(mu, 1.0) @ "y"
    >>> tr, _ = model.importance(jax.random.key(0), gx.ChoiceMap.kw(y=1.0), ())
    >>> new_tr, accepted = mh(
    ...     jax.random.key(1), tr, GaussianDrift(gx.Selection.at["mu"], 0.5))
    >>> bool(accepted) in (True, False)
    True
    """

    selection: Selection
    scale: Any = 0.25

    def edit(
        self, key: PRNGKey, tr: Trace[Any], argdiffs: Argdiffs
    ) -> tuple[Trace[Any], Weight, Retdiff, EditRequest]:
        assert Diff.static_check_no_change(argdiffs)
        values = tr.get_choices().filter(self.selection)
        scales = _scale_tree(self.scale, values)
        n_leaves = len(jtu.tree_leaves(values))
        seed_tree = jtu.tree_unflatten(
            jtu.tree_structure(values), list(range(n_leaves))
        )
        proposed = jtu.tree_map(
            lambda v, s, seed: v
            + s * jrand.normal(jrand.fold_in(key, seed), jnp.shape(v)),
            values,
            scales,
            seed_tree,
        )
        new_tr, w, retdiff, _ = Update(proposed).edit(key, tr, argdiffs)
        return new_tr, w, retdiff, GaussianDrift(self.selection, self.scale)
