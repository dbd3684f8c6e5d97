"""Involutive MCMC: user-programmable deterministic moves with
auxiliary randomness and automatic Jacobian correction.

Beyond the reference (genjax-community/genjax has no involutive-MCMC
machinery; the capability exists in Gen.jl as the `involutive_mcmc`
kernel family — Cusumano-Towner et al. 2020, "Automating involutive
MCMC using probabilistic and differentiable programming"). The kernel:

1. draw auxiliary randomness  u ~ q(. ; trace)   (any @gen function),
2. map (x, u) -> (x', u') through a user-supplied INVOLUTION f
   (f(f(x, u)) == (x, u)),
3. accept with probability
   min(1, p(x') q(u'; x') / (p(x) q(u; x)) * |det Df(x, u)|).

Random-walk, reflection, swap, and scaling moves — and the reversible-
jump style moves built from them — are all instances. The model and
auxiliary densities come straight from the GFI (`Update` edits and
`assess`), and the Jacobian is one `jax.jacfwd` over the raveled
(x, u) vector with `slogdet` — exact, no hand-derived determinants.

Accelerator notes: the involution is ordinary traced JAX code, so the whole
kernel jits and vmaps across chains; the Jacobian cost is
O((dim x + dim u)^2), which is the right trade for the low-dimensional
structured moves involutions are used for (use HMC/MALA for bulk
high-dimensional updates).
"""

from typing import Any, Callable

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
from jax.flatten_util import ravel_pytree

from genjax_tpu.core.choice_map import ChoiceMap, Selection
from genjax_tpu.core.diff import Diff
from genjax_tpu.core.gfi import GenerativeFunction, Trace, Update
from genjax_tpu.core.staging import where_tree
from genjax_tpu.core.typing import PRNGKey, static_check_supports_grad

__all__ = ["involutive_mh", "involutive_step"]


def _check_continuous(tree, what: str):
    bad = [
        jnp.asarray(v).dtype
        for v in jtu.tree_leaves(tree)
        if not static_check_supports_grad(v)
    ]
    if bad:
        raise TypeError(
            f"involutive_mh: {what} contains non-differentiable leaves "
            f"(dtypes {bad}); the Jacobian correction requires continuous "
            "values — move discrete updates into a separate Gibbs/MH step."
        )


def involutive_step(
    key: PRNGKey,
    trace: Trace[Any],
    selection: Selection,
    aux_model: GenerativeFunction[Any],
    involution: Callable[[ChoiceMap, ChoiceMap], tuple[ChoiceMap, ChoiceMap]],
    aux_args: Callable[[ChoiceMap], tuple] = lambda chm: (),
):
    """One involutive proposal; returns `(proposed_trace, log_alpha)`
    without accept/reject (compose with your own acceptance logic, or
    use `involutive_mh`).

    `selection` picks the (continuous) model sites the involution acts
    on; `aux_model(*aux_args(choices))` traces the auxiliary randomness
    (all of its sites participate); `involution(x_chm, u_chm)` maps the
    filtered model ChoiceMap and the auxiliary ChoiceMap to their
    images, and must be a differentiable involution of the pair.
    """
    k_aux, k_upd = jax.random.split(key)
    argdiffs = Diff.no_change(trace.get_args())

    x = trace.get_choices().filter(selection)
    aux_arguments = aux_args(trace.get_choices())
    aux_tr = aux_model.simulate(k_aux, aux_arguments)
    u = aux_tr.get_choices()
    _check_continuous(x, "the selected model sites")
    _check_continuous(u, "the auxiliary choices")

    x_flat, un_x = ravel_pytree(x)
    u_flat, un_u = ravel_pytree(u)
    dx = x_flat.shape[0]

    def f_flat(xu):
        x_new, u_new = involution(un_x(xu[:dx]), un_u(xu[dx:]))
        return jnp.concatenate(
            [ravel_pytree(x_new)[0], ravel_pytree(u_new)[0]]
        )

    xu = jnp.concatenate([x_flat, u_flat])
    out = f_flat(xu)
    jac = jax.jacfwd(f_flat)(xu)
    _, logdet = jnp.linalg.slogdet(jac)

    x_prime = un_x(out[:dx])
    u_prime = un_u(out[dx:])

    new_tr, w, _, _ = Update(x_prime).edit(k_upd, trace, argdiffs)
    # Model term: for a pure value substitution the Update weight IS
    # score(x') - score(x); using it (rather than re-assessing) keeps
    # one density evaluation per step.
    q_fwd = aux_tr.get_score()
    q_rev, _ = aux_model.assess(u_prime, aux_args(new_tr.get_choices()))
    log_alpha = w + q_rev - q_fwd + logdet
    return new_tr, log_alpha


def involutive_mh(
    key: PRNGKey,
    trace: Trace[Any],
    selection: Selection,
    aux_model: GenerativeFunction[Any],
    involution: Callable[[ChoiceMap, ChoiceMap], tuple[ChoiceMap, ChoiceMap]],
    aux_args: Callable[[ChoiceMap], tuple] = lambda chm: (),
) -> tuple[Trace[Any], Any]:
    """One involutive MH step: propose via `involutive_step`, then
    accept/reject. Returns `(new_trace, accepted)` — dense selects, no
    control flow, so it vmaps across chains.

    >>> import jax, jax.numpy as jnp
    >>> import genjax_tpu as gx
    >>> from genjax_tpu.inference.involutive import involutive_mh
    >>> @gx.gen
    ... def model():
    ...     x = gx.normal(0.0, 1.0) @ "x"
    ...     _ = gx.normal(x, 1.0) @ "y"
    >>> @gx.gen
    ... def aux():
    ...     _ = gx.normal(0.0, 0.5) @ "u"
    >>> def reflect(x_chm, u_chm):
    ...     # random-walk: (x, u) -> (x + u, -u); self-inverse, det 1
    ...     import jax.tree_util as jtu
    ...     x2 = jtu.tree_map(lambda x: x + u_chm["u"], x_chm)
    ...     u2 = jtu.tree_map(lambda u: -u, u_chm)
    ...     return x2, u2
    >>> tr, _ = model.importance(jax.random.key(0), gx.ChoiceMap.kw(y=1.0), ())
    >>> new_tr, acc = involutive_mh(
    ...     jax.random.key(1), tr, gx.Selection.at["x"], aux, reflect)
    >>> bool(acc) in (True, False)
    True
    """
    k_step, k_acc = jax.random.split(key)
    new_tr, log_alpha = involutive_step(
        k_step, trace, selection, aux_model, involution, aux_args
    )
    accept = jnp.log(jax.random.uniform(k_acc)) < log_alpha
    return where_tree(accept, new_tr, trace), accept
