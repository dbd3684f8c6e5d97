"""Hamiltonian Monte Carlo and MALA as SMCP3 edit requests.

Capability parity with reference `_src/inference/requests/hmc.py:70-225`
(`selection_gradient`, `HMC` with leapfrog over selected choices,
`SafeHMC`); `MALA` is added (the reference's benchmark configs call for
it, BASELINE.md config 4).

Accelerator notes
-----------------
The leapfrog loop is a `lax.scan` whose body is `jax.grad` of the model's
`assess` — one fused density+gradient evaluation per step, dense over the
selected choice leaves. Vectorizing over chains is a `jax.vmap` (or
`shard_map`, see `genjax_tpu.parallel.chains`) around `HMC(...).edit`.
"""

from typing import Any

import jax
import jax.numpy as jnp
import jax.random as jrand
import jax.tree_util as jtu
from jax import grad
from jax.lax import scan

from genjax_tpu.core.choice_map import ChoiceMap, Selection
from genjax_tpu.core.concepts import Argdiffs, EditRequest, Retdiff, Score, Weight
from genjax_tpu.core.diff import Diff
from genjax_tpu.core.gfi import Trace, Update
from genjax_tpu.core.pytree import Pytree
from genjax_tpu.core.requests import DiffAnnotate
from genjax_tpu.core.typing import (
    FloatArray,
    PRNGKey,
    static_check_supports_grad,
)

import math as _math

# python float, NOT a jnp op: a module-level jnp call initializes the
# backend at import time, fixing the platform (and claiming a card)
# before the caller can choose one
_HALF_LOG_2PI = 0.5 * _math.log(2.0 * _math.pi)


def grad_tree_unzip(tree):
    grad_tree = jtu.tree_map(lambda v: v if static_check_supports_grad(v) else None, tree)
    nongrad_tree = jtu.tree_map(
        lambda v: v if not static_check_supports_grad(v) else None, tree
    )
    return grad_tree, nongrad_tree


def grad_tree_zip(grad_tree, nongrad_tree):
    return jtu.tree_map(
        lambda v1, v2: v1 if v1 is not None else v2,
        grad_tree,
        nongrad_tree,
        is_leaf=lambda x: x is None,
    )


def make_selection_grad_fn(
    selection: Selection, trace: Trace[Any], argdiffs: Argdiffs
):
    """Build a reusable `values -> (logdensity, gradient)` closure over the
    selected addresses of `trace` (all other choices held fixed).

    Building the closure once and calling it inside `lax.scan` keeps each
    leapfrog step at exactly one fused forward+backward density pass —
    the hand-written-HMC cost."""
    chm = trace.get_choices()
    filtered = chm.filter(selection)
    complement = chm.filter(~selection)
    _, nongrad_tree = grad_tree_unzip(filtered)
    gen_fn = trace.get_gen_fn()
    primal_args = Diff.tree_primal(argdiffs)

    def differentiable_assess(grad_tree):
        zipped = grad_tree_zip(grad_tree, nongrad_tree)
        full_choices = zipped.merge(complement)
        weight, _ = gen_fn.assess(full_choices, primal_args)
        return weight

    value_and_grad_fn = jax.value_and_grad(differentiable_assess)

    def fn(values: ChoiceMap):
        grad_tree, _ = grad_tree_unzip(values)
        score, gradient = value_and_grad_fn(grad_tree)
        gradient = jtu.tree_map(
            lambda v1, v2: v1 if v1 is not None else jnp.zeros_like(jnp.asarray(v2)),
            gradient,
            nongrad_tree,
            is_leaf=lambda x: x is None,
        )
        return score, grad_tree_zip(gradient, nongrad_tree)

    return fn


def selection_gradient(
    selection: Selection, trace: Trace[Any], argdiffs: Argdiffs
) -> tuple[ChoiceMap, ChoiceMap]:
    """Return (selected values, gradient of the model log density w.r.t.
    them), holding all other choices fixed
    (reference `hmc.py:70-110` interface)."""
    chm = trace.get_choices()
    filtered = chm.filter(selection)
    grad_fn = make_selection_grad_fn(selection, trace, argdiffs)
    _, gradient = grad_fn(filtered)
    grad_tree, nongrad_tree = grad_tree_unzip(filtered)
    return grad_tree_zip(grad_tree, nongrad_tree), gradient


def _std_normal_score(v) -> Score:
    s = -0.5 * jnp.square(v) - _HALF_LOG_2PI
    return jnp.sum(s) if jnp.ndim(s) else s


def _mass_tree(inv_mass, like):
    """Broadcast the inverse-mass spec (None | scalar | pytree matching
    `like`) into a per-leaf tree of M^-1 diagonals."""
    if inv_mass is None:
        return jtu.tree_map(lambda v: jnp.ones_like(jnp.asarray(v)), like)
    if isinstance(inv_mass, (int, float)) or (
        isinstance(inv_mass, jax.Array) and inv_mass.ndim == 0
    ):
        return jtu.tree_map(
            lambda v: jnp.broadcast_to(jnp.asarray(inv_mass, dtype=jnp.result_type(float)), jnp.shape(v)),
            like,
        )
    return jtu.tree_map(
        lambda v, im: jnp.broadcast_to(im, jnp.shape(v)), like, inv_mass
    )


def assess_momenta(momenta, mul=1.0, inv_mass=None):
    """Log density of the momenta under N(0, M) with diagonal
    M = 1/inv_mass: -1/2 p^T M^-1 p - d/2 log 2pi + 1/2 sum log inv_mass."""
    im = _mass_tree(inv_mass, momenta)

    def score(p, im_leaf):
        s = -0.5 * im_leaf * jnp.square(mul * p) - _HALF_LOG_2PI + 0.5 * jnp.log(im_leaf)
        return jnp.sum(s) if jnp.ndim(s) else s

    return jnp.sum(jnp.array(jtu.tree_leaves(jtu.tree_map(score, momenta, im))))


def sample_momenta(key: PRNGKey, choice_gradients, inv_mass=None):
    """Draw p ~ N(0, M) with diagonal M = 1/inv_mass (unit mass when
    `inv_mass` is None), one leaf-keyed fold_in per leaf."""
    leaves_ct = len(jtu.tree_leaves(choice_gradients))
    seed_tree = jtu.tree_unflatten(
        jtu.tree_structure(choice_gradients), list(range(leaves_ct))
    )
    im = _mass_tree(inv_mass, choice_gradients)
    momenta = jtu.tree_map(
        lambda v, seed, im_leaf: jrand.normal(jrand.fold_in(key, seed), jnp.shape(v))
        / jnp.sqrt(im_leaf),
        choice_gradients,
        seed_tree,
        im,
    )
    return momenta, assess_momenta(momenta, inv_mass=inv_mass)


@Pytree.dataclass(match_args=True)
class HMC(EditRequest):
    """Leapfrog HMC over the selected addresses; the returned weight is the
    HMC alpha (log accept ratio): DH = (new model score + new momenta
    score) - (old model score + old momenta score). Accept/reject is the
    caller's (see `genjax_tpu.inference.mcmc.mh`).

    Neal (2011), eqns (5.18)-(5.20). `inv_mass` preconditions the
    kinetic energy with a diagonal mass matrix: momenta are drawn from
    N(0, M) with M = 1/inv_mass and positions step by `eps * inv_mass * p`
    — set `inv_mass` to (an estimate of) the posterior variance of the
    selected values, e.g. from `inference.adaptation.warmup_chains`.
    Accepts None (unit mass), a scalar, or a pytree matching the selected
    choices (leaves broadcastable to each value leaf). `jitter` (0..1)
    draws each trajectory's step size uniformly from
    `eps * [1-jitter, 1+jitter]` — strongly recommended (e.g. 0.2) for
    fixed-L sampling runs, since a deterministic trajectory length
    resonates with the target's periods (accepted proposals that return
    to their start; see the comment in `edit`).

    >>> import jax, jax.numpy as jnp
    >>> import genjax_tpu as gx
    >>> from genjax_tpu.inference.requests import HMC
    >>> @gx.gen
    ... def model():
    ...     mu = gx.normal(0.0, 1.0) @ "mu"
    ...     _ = gx.normal(mu, 1.0) @ "obs"
    >>> tr, _ = model.importance(jax.random.key(0), gx.ChoiceMap.kw(obs=1.0), ())
    >>> req = HMC(gx.Selection.at["mu"], jnp.array(0.1), L=5)
    >>> new_tr, alpha, _, _ = req.edit(jax.random.key(1), tr, gx.Diff.no_change(()))
    >>> bool(jnp.isfinite(alpha))
    True
    """

    selection: Selection
    eps: FloatArray
    L: int = Pytree.static(default=10)
    inv_mass: Any = None
    jitter: float = Pytree.static(default=0.0)

    def edit(
        self, key: PRNGKey, tr: Trace[Any], argdiffs: Argdiffs
    ) -> tuple[Trace[Any], Weight, Retdiff, EditRequest]:
        assert Diff.static_check_no_change(argdiffs)
        original_score = tr.get_score()
        grad_fn = make_selection_grad_fn(self.selection, tr, argdiffs)
        values = tr.get_choices().filter(self.selection)
        _, gradients = grad_fn(values)
        key, sub_key = jrand.split(key)
        momenta, original_momenta_score = sample_momenta(
            sub_key, gradients, inv_mass=self.inv_mass
        )
        im = _mass_tree(self.inv_mass, gradients)
        eps = self.eps
        if self.jitter:
            # Per-trajectory step-size jitter (Neal 2011, §3.2): a fixed
            # (eps, L) makes the trajectory length resonate with the
            # target's periods — on a Gaussian, eps*L*sqrt(inv_mass)/sd
            # near 2*pi returns every proposal to its start with
            # near-perfect acceptance and zero movement (and step-size
            # adaptation is ATTRACTED to that fixed point, since it tunes
            # on acceptance). Drawing eps fresh per trajectory, before
            # seeing the state, preserves detailed balance and blurs the
            # resonance.
            key, jit_key = jrand.split(key)
            eps = eps * (
                1.0 + self.jitter * (2.0 * jrand.uniform(jit_key) - 1.0)
            )

        # Leapfrog over (values, momenta, gradient) with ONE fused
        # forward+backward density pass per step; the trace itself is
        # rebuilt once at the end (a single Update edit), not per step.
        def leapfrog(carry, _):
            values, gradient, momenta = carry
            momenta = jtu.tree_map(lambda m, g: m + (eps / 2) * g, momenta, gradient)
            values = jtu.tree_map(
                lambda v, m, im_leaf: v + eps * im_leaf * m, values, momenta, im
            )
            _, gradient = grad_fn(values)
            momenta = jtu.tree_map(lambda m, g: m + (eps / 2) * g, momenta, gradient)
            return (values, gradient, momenta), None

        (final_values, _, final_momenta), _ = scan(
            leapfrog, (values, gradients, momenta), None, length=self.L
        )
        final_trace, _, retdiff, _ = Update(final_values).edit(key, tr, argdiffs)
        final_momenta_score = assess_momenta(
            final_momenta, mul=-1.0, inv_mass=self.inv_mass
        )
        alpha = (
            final_trace.get_score()
            - original_score
            + final_momenta_score
            - original_momenta_score
        )
        return (
            final_trace,
            alpha,
            retdiff,
            HMC(self.selection, self.eps, self.L, self.inv_mass, self.jitter),
        )


def SafeHMC(selection: Selection, eps: FloatArray, L: int = 10) -> DiffAnnotate:
    """HMC with a static return-value-stability assertion (reference
    `hmc.py:214-225`): the move is rejected at trace time unless the
    site-graph analysis proves the selected addresses cannot reach the
    model's return value (see `lang/analysis.py`)."""

    def retdiff_assertion(retdiff):
        assert Diff.static_check_no_change(retdiff), (
            "SafeHMC: the selected addresses may change the model's "
            "return value; use HMC directly if this is intended."
        )
        return retdiff

    return HMC(selection, eps, L).map(retdiff_assertion)


@Pytree.dataclass(match_args=True)
class MALA(EditRequest):
    """Metropolis-adjusted Langevin: one gradient step plus noise on the
    selected addresses; the weight is the MALA log accept ratio.

    New relative to the reference (BASELINE.md benchmark config 4 calls
    for MALA chains). `inv_mass` preconditions the proposal with a
    diagonal covariance S = inv_mass (per-dimension step scaling):
    `v' = v + eps*S*g + sqrt(2*eps*S)*xi`, with the reverse kernel
    evaluated under the same S (the log-det terms cancel).
    """

    selection: Selection
    eps: FloatArray
    inv_mass: Any = None

    def edit(
        self, key: PRNGKey, tr: Trace[Any], argdiffs: Argdiffs
    ) -> tuple[Trace[Any], Weight, Retdiff, EditRequest]:
        assert Diff.static_check_no_change(argdiffs)
        eps = self.eps
        grad_fn = make_selection_grad_fn(self.selection, tr, argdiffs)
        values = tr.get_choices().filter(self.selection)
        _, grads = grad_fn(values)
        scale = _mass_tree(self.inv_mass, values)
        key, noise_key = jrand.split(key)
        leaves_ct = len(jtu.tree_leaves(values))
        seed_tree = jtu.tree_unflatten(
            jtu.tree_structure(values), list(range(leaves_ct))
        )
        noise = jtu.tree_map(
            lambda v, s: jrand.normal(jrand.fold_in(noise_key, s), jnp.shape(v)),
            values,
            seed_tree,
        )
        proposed = jtu.tree_map(
            lambda v, g, xi, s: v + eps * s * g + jnp.sqrt(2.0 * eps * s) * xi,
            values,
            grads,
            noise,
            scale,
        )

        def q_score(to_vals, from_vals, from_grads):
            # log q(to | from) under the preconditioned Langevin proposal
            # (the 1/2 log det 4*pi*eps*S normalizer is shared between the
            # forward and reverse kernels and cancels in alpha).
            diffs = jtu.tree_map(
                lambda t, f, g, s: -jnp.sum(
                    jnp.square(t - f - eps * s * g) / (4.0 * eps * s)
                ),
                to_vals,
                from_vals,
                from_grads,
                scale,
            )
            return jnp.sum(jnp.array(jtu.tree_leaves(diffs)))

        fwd_q = q_score(proposed, values, grads)
        new_tr, w, retdiff, _ = Update(proposed).edit(key, tr, argdiffs)
        new_values = new_tr.get_choices().filter(self.selection)
        _, new_grads = grad_fn(new_values)
        bwd_q = q_score(values, new_values, new_grads)
        alpha = w + bwd_q - fwd_q
        return (
            new_tr,
            alpha,
            retdiff,
            MALA(self.selection, self.eps, self.inv_mass),
        )
