"""Reversible-jump MCMC across Switch branches.

Beyond the reference (genjax-community/genjax has no transdimensional
machinery; Gen.jl exposes the capability through involutive MCMC —
Cusumano-Towner et al. 2020). A reversible jump is a matched PAIR of
directed proposals between two model configurations (e.g. Switch
branches of different dimensionality): each direction reads the current
configuration's parameters, draws auxiliary randomness to pad the
dimension gap, maps through a differentiable bijection, and writes the
other configuration via one `Update` edit — whose GFI weight is exactly
the joint-density ratio, including the branch-index site and the
newly-active branch's priors (`combinators/switch.py` index-move
semantics). The acceptance ratio is then

    log alpha = w_update + log q_rev(u') - log q_fwd(u) + log |det J|

with the Jacobian taken over the raveled (params, u) -> (params', u')
map — square by the RJ dimension-matching condition, which is asserted
at trace time.

Accelerator notes: instead of branching on the jump direction (whose two sides
have different pytree structures — anathema to `lax.cond`), BOTH
directions are evaluated densely and the live one is selected with
`where_tree` — two density evaluations per step, the standard dense
trade, and the whole kernel jits and vmaps across chains.
"""

from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from genjax_tpu.core.choice_map import ChoiceMap
from genjax_tpu.core.diff import Diff
from genjax_tpu.core.gfi import GenerativeFunction, Trace, Update
from genjax_tpu.core.pytree import Pytree
from genjax_tpu.core.staging import where_tree
from genjax_tpu.core.typing import PRNGKey

__all__ = ["JumpProposal", "reversible_jump"]


@Pytree.dataclass
class JumpProposal(Pytree):
    """One direction of a reversible jump.

    - `read(choices) -> params`: extract this configuration's
      (continuous, plain-array) parameters from the model choices.
    - `aux`: generative function for the auxiliary randomness
      (`aux_args(choices)` builds its arguments; use a site-free @gen
      function when the direction needs no padding).
    - `involution(params, u_chm) -> (params_other, u_rev_chm)`: the
      differentiable map to the OTHER configuration's parameters plus
      the reverse direction's auxiliary choices (dimensions must match:
      dim params + dim u == dim params_other + dim u_rev).
    - `constraint(params_other) -> ChoiceMap`: the Update constraint
      realizing the jump — must set the branch-index site and every
      site of the newly-active configuration.
    """

    read: Callable[[ChoiceMap], Any] = Pytree.static()
    aux: GenerativeFunction[Any] = Pytree.field()
    aux_args: Callable[[ChoiceMap], tuple] = Pytree.static(
        default=lambda chm: ()
    )
    involution: Callable[[Any, ChoiceMap], tuple[Any, ChoiceMap]] = (
        Pytree.static(default=None)
    )
    constraint: Callable[[Any], ChoiceMap] = Pytree.static(default=None)


def _directed_jump(
    key: PRNGKey,
    trace: Trace[Any],
    fwd: JumpProposal,
    rev: JumpProposal,
    argdiffs,
):
    """Propose one direction; returns (candidate trace, log alpha)."""
    k_aux, k_upd = jax.random.split(key)
    choices = trace.get_choices()
    params = fwd.read(choices)
    aux_tr = fwd.aux.simulate(k_aux, fwd.aux_args(choices))
    u = aux_tr.get_choices()
    q_fwd = aux_tr.get_score()

    p_flat, un_p = ravel_pytree(params)
    u_flat, un_u = ravel_pytree(u)
    dp = p_flat.shape[0]

    # Output structures come from one primal evaluation.
    params_other, u_rev = fwd.involution(params, u)
    po_flat, un_po = ravel_pytree(params_other)
    ur_flat, un_ur = ravel_pytree(u_rev)
    if dp + u_flat.shape[0] != po_flat.shape[0] + ur_flat.shape[0]:
        raise ValueError(
            "reversible_jump: dimension mismatch — dim(params) + dim(u) "
            f"= {dp + u_flat.shape[0]} but dim(params') + dim(u') = "
            f"{po_flat.shape[0] + ur_flat.shape[0]}; the involution must "
            "conserve total dimension."
        )

    def f_flat(xu):
        po, ur = fwd.involution(un_p(xu[:dp]), un_u(xu[dp:]))
        return jnp.concatenate([ravel_pytree(po)[0], ravel_pytree(ur)[0]])

    xu = jnp.concatenate([p_flat, u_flat])
    jac = jax.jacfwd(f_flat)(xu)
    _, logdet = jnp.linalg.slogdet(jac)

    new_tr, w, _, _ = Update(fwd.constraint(params_other)).edit(
        k_upd, trace, argdiffs
    )
    q_rev, _ = rev.aux.assess(u_rev, rev.aux_args(new_tr.get_choices()))
    return new_tr, w + q_rev - q_fwd + logdet


def reversible_jump(
    key: PRNGKey,
    trace: Trace[Any],
    up: JumpProposal,
    down: JumpProposal,
    is_up: Callable[[ChoiceMap], Any],
) -> tuple[Trace[Any], Any]:
    """One reversible-jump MH step between two model configurations.

    `is_up(choices)` returns True when the UP proposal applies to the
    current state (e.g. `lambda chm: chm["m"] == 0`). Both directions
    are evaluated densely and the live one selected, so the step is
    jit/vmap-clean. Returns `(new_trace, accepted)`.
    """
    k_up, k_down, k_acc = jax.random.split(key, 3)
    argdiffs = Diff.no_change(trace.get_args())
    up_tr, up_alpha = _directed_jump(k_up, trace, up, down, argdiffs)
    down_tr, down_alpha = _directed_jump(k_down, trace, down, up, argdiffs)

    going_up = is_up(trace.get_choices())
    cand = where_tree(going_up, up_tr, down_tr)
    log_alpha = jnp.where(going_up, up_alpha, down_alpha)
    accept = jnp.log(jax.random.uniform(k_acc)) < log_alpha
    return where_tree(accept, cand, trace), accept
