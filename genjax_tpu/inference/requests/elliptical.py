"""Elliptical slice sampling as an SMCP3 edit request.

New relative to the reference (which ships only HMC/MALA-style moves,
`_src/inference/requests/hmc.py`): elliptical slice sampling (Murray,
Adams & MacKay 2010) is the standard tuning-free move for models with
Gaussian priors over the selected sites — latent GPs, random effects,
Kalman-style latents outside the conjugate regime. Every step is
accepted, there is no step size, and the only model access it needs is
already in the GFI: `Regenerate` supplies the auxiliary prior draw and
`Update` + `Trace.project` supply the likelihood evaluations.

Accelerator notes
-----------------
The bracket-shrinking loop is a `lax.while_loop` whose body is one dense
density evaluation (an `Update` edit) — no dynamic shapes, so the move
`jax.vmap`s across chains (JAX lifts the loop to run until every lane
has accepted, masking finished lanes). Typical accept counts are 2-4
iterations, so the masked overhead is small; `max_shrink` bounds the
trace statically.

Validity contract (documented, not checkable in general): each selected
site must carry a (multivariate) normal prior whose parameters do not
depend on *other selected* sites. The prior mean is supplied via `mean`
(scalar or a pytree matching the selected choices); the prior covariance
is never needed explicitly — the auxiliary draw `nu ~ p(theta | rest)`
comes from a `Regenerate` edit, and points on the ellipse
`m + (theta-m) cos(e) + (nu-m) sin(e)` are exact prior draws for every
angle `e`.
"""

from typing import Any

import jax
import jax.numpy as jnp
import jax.random as jrand
import jax.tree_util as jtu

from genjax_tpu.core.choice_map import Selection
from genjax_tpu.core.concepts import Argdiffs, EditRequest, Retdiff, Weight
from genjax_tpu.core.diff import Diff
from genjax_tpu.core.gfi import Trace, Update
from genjax_tpu.core.pytree import Pytree
from genjax_tpu.core.requests import Regenerate
from genjax_tpu.core.staging import where_tree
from genjax_tpu.core.typing import PRNGKey

_TWO_PI = 6.283185307179586


def _on_ellipse(theta, nu, mean, angle):
    """Point at `angle` on the ellipse through `theta` (angle 0) and the
    auxiliary prior draw `nu` (angle pi/2), centered at the prior mean."""
    c, s = jnp.cos(angle), jnp.sin(angle)
    if isinstance(mean, (int, float)) or (
        isinstance(mean, jax.Array) and mean.ndim == 0
    ):
        return jtu.tree_map(
            lambda t, v: mean + (t - mean) * c + (v - mean) * s, theta, nu
        )
    return jtu.tree_map(
        lambda t, v, m: m + (t - m) * c + (v - m) * s, theta, nu, mean
    )


def _loglik(key: PRNGKey, trace: Trace[Any], selection: Selection):
    """log p(everything else | selected sites): the joint score minus the
    selected sites' own (prior) score — the slice function for ESS."""
    return trace.get_score() - trace.project(key, selection)


@Pytree.dataclass(match_args=True)
class EllipticalSlice(EditRequest):
    """One elliptical slice sampling move over the selected addresses.

    The returned weight is 0.0: the move is a slice sampler and leaves
    the posterior invariant with probability one, so an `mh` driver
    wrapping it always accepts. Use it directly or compose it with the
    chain drivers in `genjax_tpu.inference.mcmc`.

    `mean` is the prior mean of the selected sites (scalar, or a pytree
    matching the selected choices); `max_shrink` statically bounds the
    bracket-shrinking loop (the bracket halves in expectation per
    rejection, so the default 32 is effectively never binding — if it is
    reached the move degenerates to keeping the current state, which
    also preserves the posterior).

    >>> import jax, jax.numpy as jnp
    >>> import genjax_tpu as gx
    >>> from genjax_tpu.inference.requests import EllipticalSlice
    >>> @gx.gen
    ... def model():
    ...     f = gx.normal(0.0, 1.0) @ "f"
    ...     _ = gx.normal(f, 0.5) @ "obs"
    >>> tr, _ = model.importance(jax.random.key(0), gx.ChoiceMap.kw(obs=1.0), ())
    >>> req = EllipticalSlice(gx.Selection.at["f"])
    >>> new_tr, w, _, _ = req.edit(jax.random.key(1), tr, gx.Diff.no_change(()))
    >>> float(w)
    0.0
    """

    selection: Selection
    mean: Any = 0.0
    max_shrink: int = Pytree.static(default=32)

    def edit(
        self, key: PRNGKey, tr: Trace[Any], argdiffs: Argdiffs
    ) -> tuple[Trace[Any], Weight, Retdiff, EditRequest]:
        assert Diff.static_check_no_change(argdiffs)
        sel = self.selection
        k_nu, k_slice, k_angle, k_proj, k_edit = jrand.split(key, 5)

        theta = tr.get_choices().filter(sel)
        # Auxiliary prior draw: Regenerate's internal proposal at a site
        # IS the prior conditional, so the discarded trace's selected
        # values are exactly nu ~ p(. | unselected sites).
        nu_tr, _, _, _ = Regenerate(sel).edit(k_nu, tr, argdiffs)
        nu = nu_tr.get_choices().filter(sel)

        # Slice height: log y = loglik(theta) + log u.
        log_y = _loglik(k_proj, tr, sel) + jnp.log(
            jrand.uniform(k_slice, minval=jnp.finfo(jnp.float32).tiny)
        )

        angle0 = jrand.uniform(k_angle, maxval=_TWO_PI)

        def propose(step_key, angle):
            values = _on_ellipse(theta, nu, self.mean, angle)
            cand, _, _, _ = Update(values).edit(step_key, tr, argdiffs)
            return cand, _loglik(k_proj, cand, sel)

        cand0, ll0 = propose(k_edit, angle0)

        def cond(carry):
            _, _, _, _, _, accepted, iters = carry
            return jnp.logical_and(~accepted, iters < self.max_shrink)

        def body(carry):
            loop_key, angle, lo, hi, cand, _, iters = carry
            # Shrink the bracket toward angle 0 (the current state) and
            # redraw; Murray et al. 2010, step 8-10.
            lo = jnp.where(angle < 0.0, angle, lo)
            hi = jnp.where(angle >= 0.0, angle, hi)
            loop_key, k_draw, k_upd = jrand.split(loop_key, 3)
            angle = jrand.uniform(k_draw, minval=lo, maxval=hi)
            cand, ll = propose(k_upd, angle)
            return (loop_key, angle, lo, hi, cand, ll > log_y, iters + 1)

        init = (
            k_edit,
            angle0,
            angle0 - _TWO_PI,
            angle0,
            cand0,
            ll0 > log_y,
            jnp.asarray(0),
        )
        _, _, _, _, cand, accepted, _ = jax.lax.while_loop(cond, body, init)

        # If max_shrink was exhausted (vanishingly rare), keep the
        # current state — the bracket-collapse limit, still invariant.
        new_tr = where_tree(accepted, cand, tr)
        return (
            new_tr,
            jnp.asarray(0.0),
            Diff.unknown_change(new_tr.get_retval()),
            EllipticalSlice(sel, self.mean, self.max_shrink),
        )


def elliptical_slice(
    key: PRNGKey,
    trace: Trace[Any],
    selection: Selection,
    mean: Any = 0.0,
    max_shrink: int = 32,
) -> Trace[Any]:
    """Functional form: one always-accepted ESS move on `trace`."""
    new_tr, _, _, _ = EllipticalSlice(selection, mean, max_shrink).edit(
        key, trace, Diff.no_change(trace.get_args())
    )
    return new_tr
