"""MAP estimation and Laplace approximation over selected choices.

Beyond the reference (genjax-community/genjax has no optimization-based
inference): the standard fast path for continuous latents — gradient
ascent on the model's log joint over a `Selection` (everything else held
fixed), then a Gaussian approximation from the curvature at the mode,
including the Laplace evidence estimate

    log p(y) ~ log p(map, y) + d/2 log 2pi - 1/2 log det(-H).

Accelerator shape: optimization is an optax loop inside one `lax.scan` whose
body is the same fused value+gradient density pass HMC uses
(`make_selection_grad_fn`); the Hessian is one `jax.hessian` of the
flattened selected vector (dense d x d — this is a tool for modest-
dimensional parameter blocks, not million-dimensional latents). Both
jit, vmap (parallel restarts), and shard like everything else.
"""

from typing import Any

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from genjax_tpu.core.choice_map import Selection
from genjax_tpu.core.diff import Diff
from genjax_tpu.core.gfi import Trace, Update
from genjax_tpu.core.pytree import Pytree
from genjax_tpu.core.typing import FloatArray, PRNGKey
from genjax_tpu.inference.requests.hmc import make_selection_grad_fn

__all__ = ["map_estimate", "laplace_approximation", "LaplaceApproximation"]


def map_estimate(
    key: PRNGKey,
    trace: Trace[Any],
    selection: Selection,
    n_steps: int = 500,
    optimizer: Any = None,
) -> tuple[Trace[Any], FloatArray]:
    """Maximize the model's log joint over the selected choices.

    Returns `(map_trace, log_density_history)`; the returned trace is the
    input trace updated (one `Update` edit) with the optimized values.
    `optimizer` is any optax gradient transformation (default
    `optax.adam(0.05)`).

    >>> import jax, jax.numpy as jnp
    >>> import genjax_tpu as gx
    >>> from genjax_tpu.inference.map_laplace import map_estimate
    >>> @gx.gen
    ... def model():
    ...     mu = gx.normal(0.0, 1.0) @ "mu"
    ...     _ = gx.normal(mu, 1.0) @ "obs"
    >>> tr, _ = model.importance(jax.random.key(0), gx.ChoiceMap.kw(obs=1.0), ())
    >>> map_tr, hist = map_estimate(jax.random.key(1), tr, gx.Selection.at["mu"])
    >>> bool(jnp.abs(map_tr.get_choices()["mu"] - 0.5) < 1e-3)  # exact mode
    True
    """
    import optax

    if optimizer is None:
        optimizer = optax.adam(0.05)
    argdiffs = Diff.no_change(trace.get_args())
    grad_fn = make_selection_grad_fn(selection, trace, argdiffs)
    values = trace.get_choices().filter(selection)
    opt_state = optimizer.init(values)

    def step(carry, _):
        values, opt_state = carry
        score, grads = grad_fn(values)
        # ascent: optax minimizes, so feed the negated gradient
        neg = jax.tree_util.tree_map(lambda g: -g, grads)
        updates, opt_state = optimizer.update(neg, opt_state, values)
        values = optax.apply_updates(values, updates)
        return (values, opt_state), score

    (values, _), hist = jax.lax.scan(
        step, (values, opt_state), None, length=n_steps
    )
    map_trace, _, _, _ = Update(values).edit(key, trace, argdiffs)
    return map_trace, hist


@Pytree.dataclass
class LaplaceApproximation(Pytree):
    """Gaussian approximation at a mode: flat `mean` (+ `unravel` back to
    the choice structure), dense `covariance`, and the Laplace evidence
    estimate `log_marginal`."""

    mean: FloatArray
    covariance: FloatArray
    log_marginal: FloatArray
    unravel: Any = Pytree.static()

    def sample(self, key: PRNGKey, n: int | None = None):
        """Draw from the approximation; returns selected-choice pytrees."""
        chol = jnp.linalg.cholesky(self.covariance)
        shape = (self.mean.shape[0],) if n is None else (n, self.mean.shape[0])
        eps = jax.random.normal(key, shape)
        flat = self.mean + eps @ chol.T
        if n is None:
            return self.unravel(flat)
        return jax.vmap(self.unravel)(flat)


def laplace_approximation(
    trace: Trace[Any], selection: Selection
) -> LaplaceApproximation:
    """Laplace approximation around `trace`'s current selected values
    (run `map_estimate` first so they sit at the mode).

    The negative-Hessian of the log joint (w.r.t. the flattened selected
    vector) is the Gaussian precision; `log_marginal` is the standard
    evidence estimate, EXACT when the joint is Gaussian in the selected
    values.

    >>> import jax, jax.numpy as jnp
    >>> import genjax_tpu as gx
    >>> from genjax_tpu.inference.map_laplace import map_estimate, laplace_approximation
    >>> @gx.gen
    ... def model():
    ...     mu = gx.normal(0.0, 1.0) @ "mu"
    ...     _ = gx.normal(mu, 1.0) @ "obs"
    >>> tr, _ = model.importance(jax.random.key(0), gx.ChoiceMap.kw(obs=1.0), ())
    >>> map_tr, _ = map_estimate(jax.random.key(1), tr, gx.Selection.at["mu"])
    >>> lap = laplace_approximation(map_tr, gx.Selection.at["mu"])
    >>> exact_lml = gx.normal.logpdf(1.0, 0.0, jnp.sqrt(2.0))
    >>> bool(jnp.abs(lap.log_marginal - exact_lml) < 1e-3)  # exact: Gaussian joint
    True
    >>> bool(jnp.abs(lap.covariance[0, 0] - 0.5) < 1e-3)  # posterior variance
    True
    """
    argdiffs = Diff.no_change(trace.get_args())
    grad_fn = make_selection_grad_fn(selection, trace, argdiffs)
    values = trace.get_choices().filter(selection)
    flat, unravel = ravel_pytree(values)

    def flat_logp(x):
        score, _ = grad_fn(unravel(x))
        return score

    d = flat.shape[0]
    hess = jax.hessian(flat_logp)(flat)
    precision = -hess
    covariance = jnp.linalg.inv(precision)
    _, logdet = jnp.linalg.slogdet(precision)
    logp_mode = flat_logp(flat)
    log_marginal = logp_mode + 0.5 * d * jnp.log(2.0 * jnp.pi) - 0.5 * logdet
    return LaplaceApproximation(
        mean=flat,
        covariance=covariance,
        log_marginal=log_marginal,
        unravel=unravel,
    )
