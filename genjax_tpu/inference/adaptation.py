"""MCMC warmup adaptation: dual-averaging step sizes and cross-chain
mass matrices.

Beyond the reference (genjax-community/genjax ships raw `HMC`/`SafeHMC`
with user-supplied `eps` only — `_src/inference/requests/hmc.py:112-225`);
step-size/mass adaptation is table stakes for HMC users, so this module
packages the standard warmup recipe in the form a many-chain accelerator layout makes natural:

- **Step size** by Nesterov dual averaging on the acceptance statistic
  (Hoffman & Gelman 2014, §3.2) — a scalar recursion carried through the
  warmup `lax.scan`, shared across all chains.
- **Diagonal mass matrix** from the **cross-chain variance** of the
  selected values. The classic single-chain recipe needs long windowed
  Welford accumulators because one chain only visits the posterior
  slowly; with the thousands of parallel chains this framework's drivers
  run (`mcmc.run_chains`, BASELINE config 4), the instantaneous spread
  *across* chains estimates the posterior variance in one step — no
  windows, no per-chain state, and the estimator is a dense per-leaf
  `var(axis=0)` that XLA fuses into the chain program.

The warmup schedule is three statically-unrolled phases (an eps-only
burn-in on unit mass, a mass-estimation phase, and an eps polish under
the final metric), each a single `lax.scan` — no data-dependent Python
control flow, one compiled program per phase.
"""

from typing import Any

import jax
import jax.numpy as jnp
import jax.random as jrand
import jax.tree_util as jtu

from genjax_tpu.core.choice_map import Selection
from genjax_tpu.core.diff import Diff
from genjax_tpu.core.gfi import Trace
from genjax_tpu.core.pytree import Pytree
from genjax_tpu.core.staging import where_tree
from genjax_tpu.core.typing import FloatArray, PRNGKey
from genjax_tpu.inference.mcmc import _chain_axes
from genjax_tpu.inference.requests.hmc import HMC, MALA

# -- dual averaging ----------------------------------------------------------


@Pytree.dataclass
class DualAveragingState(Pytree):
    """Carried state of the Nesterov dual-averaging recursion on
    `log eps` (Hoffman & Gelman 2014, §3.2)."""

    log_eps: FloatArray
    log_eps_bar: FloatArray
    h_bar: FloatArray
    step: FloatArray
    mu: FloatArray


def da_init(eps0: float) -> DualAveragingState:
    """Start dual averaging at `eps0`, shrinking toward `10 * eps0`."""
    log_eps0 = jnp.log(jnp.asarray(eps0, dtype=jnp.result_type(float)))
    zero = jnp.zeros_like(log_eps0)
    return DualAveragingState(
        log_eps=log_eps0,
        log_eps_bar=zero,
        h_bar=zero,
        step=zero,
        mu=jnp.log(10.0) + log_eps0,
    )


def da_update(
    state: DualAveragingState,
    accept_prob: FloatArray,
    target: float = 0.8,
    gamma: float = 0.05,
    t0: float = 10.0,
    kappa: float = 0.75,
) -> DualAveragingState:
    """One dual-averaging step toward `E[accept_prob] = target`."""
    t = state.step + 1.0
    eta_h = 1.0 / (t + t0)
    h_bar = (1.0 - eta_h) * state.h_bar + eta_h * (target - accept_prob)
    log_eps = state.mu - (jnp.sqrt(t) / gamma) * h_bar
    eta_x = t ** (-kappa)
    log_eps_bar = eta_x * log_eps + (1.0 - eta_x) * state.log_eps_bar
    return DualAveragingState(log_eps, log_eps_bar, h_bar, t, state.mu)


def da_final(state: DualAveragingState) -> FloatArray:
    """The averaged (final) step size."""
    return jnp.exp(state.log_eps_bar)


# -- cross-chain mass estimation ---------------------------------------------


def cross_chain_inv_mass(traces: Trace[Any], selection: Selection, n_chains=None):
    """Estimate a diagonal inverse mass matrix (= posterior variance of
    the selected values) from the spread across a batch of chains.

    Returns a pytree matching `traces.get_choices().filter(selection)`
    minus the chain axis, with Stan-style shrinkage toward a small
    constant: `(n/(n+5)) * var + 1e-3 * (5/(n+5))` — regularized against
    the zero-variance corner when chains have not yet dispersed.

    Leaves without the leading chain axis (shared-args layout) have no
    cross-chain spread to measure and fall back to unit mass.
    """
    if n_chains is None:
        n_chains = jnp.shape(traces.get_score())[0]
    values = traces.get_choices().filter(selection)
    n = float(n_chains)
    shrink = n / (n + 5.0)

    def leaf_var(v):
        v = jnp.asarray(v)
        if v.ndim >= 1 and v.shape[0] == n_chains:
            var = jnp.var(v.astype(jnp.result_type(float)), axis=0)
            return shrink * var + 1e-3 * (1.0 - shrink)
        return jnp.ones(jnp.shape(v), dtype=jnp.result_type(float))

    return jtu.tree_map(leaf_var, values)


# -- warmup driver ------------------------------------------------------------


@Pytree.dataclass
class WarmupResult(Pytree):
    """Tuned kernel parameters: pass `eps` and `inv_mass` straight into
    `HMC(sel, eps, L, inv_mass)` / `MALA(sel, eps, inv_mass)`."""

    eps: FloatArray
    inv_mass: Any
    accept_rate: FloatArray


def _make_request(algorithm: str, selection, eps, L, inv_mass, jitter):
    if algorithm == "hmc":
        return HMC(selection, eps, L, inv_mass, jitter)
    if algorithm == "mala":
        return MALA(selection, eps, inv_mass)
    raise ValueError(
        f"warmup_chains: unknown algorithm {algorithm!r}; expected 'hmc' or 'mala'."
    )


def _adaptive_phase(
    key: PRNGKey,
    traces,
    axes,
    n_chains: int,
    selection,
    algorithm: str,
    L: int,
    inv_mass,
    da: DualAveragingState,
    n_steps: int,
    target: float,
    jitter: float,
):
    """`n_steps` vectorized MH steps with a shared, per-step-adapted eps."""

    def step(carry, step_key):
        traces, da = carry
        eps = jnp.exp(da.log_eps)
        request = _make_request(algorithm, selection, eps, L, inv_mass, jitter)
        keys = jrand.split(step_key, n_chains)

        def one(k, tr):
            k_move, k_accept = jrand.split(k)
            proposed, alpha, _, _ = request.edit(
                k_move, tr, Diff.no_change(tr.get_args())
            )
            accept = jnp.log(jrand.uniform(k_accept)) < alpha
            prob = jnp.where(
                jnp.isnan(alpha), 0.0, jnp.exp(jnp.minimum(alpha, 0.0))
            )
            return where_tree(accept, proposed, tr), prob

        traces, probs = jax.vmap(one, in_axes=(0, axes), out_axes=(axes, 0))(
            keys, traces
        )
        mean_prob = jnp.mean(probs)
        return (traces, da_update(da, mean_prob, target=target)), mean_prob

    keys = jrand.split(key, n_steps)
    (traces, da), accept_hist = jax.lax.scan(step, (traces, da), keys)
    return traces, da, accept_hist


def warmup_chains(
    key: PRNGKey,
    traces: Trace[Any],
    selection: Selection,
    n_steps: int = 200,
    *,
    algorithm: str = "hmc",
    L: int = 10,
    eps0: float = 0.1,
    target_accept: float | None = None,
    adapt_mass: bool = True,
    jitter: float = 0.2,
    n_chains: int | None = None,
) -> tuple[Trace[Any], WarmupResult]:
    """Warm up a batch of chains: adapt a shared step size (dual
    averaging on the cross-chain mean acceptance probability) and, when
    `adapt_mass`, a shared diagonal mass matrix (cross-chain variance).

    `traces` is a chain batch with a leading chain axis (build it the
    same way as for `mcmc.run_chains`; `share_chain_args` layouts are
    respected). Returns `(warmed_traces, WarmupResult)`; continue
    sampling with the SAME trajectory jitter the warmup used::

        req = HMC(sel, result.eps, L, result.inv_mass, jitter=0.2)
        final, _ = run_chains(key, warmed, req, n_samples)

    `jitter` matters for fixed-L HMC: without it, step-size adaptation
    is attracted to trajectory lengths that resonate with the target
    (near-perfect acceptance, near-zero movement — `HMC.edit` explains);
    the jitter blurs the resonance both during warmup and sampling.

    >>> import jax, jax.numpy as jnp
    >>> import genjax_tpu as gx
    >>> from genjax_tpu.inference.adaptation import warmup_chains
    >>> @gx.gen
    ... def model():
    ...     mu = gx.normal(0.0, 2.0) @ "mu"
    ...     _ = gx.normal(mu, 1.0) @ "obs"
    >>> keys = jax.random.split(jax.random.key(0), 64)
    >>> trs, _ = jax.vmap(lambda k: model.importance(k, gx.ChoiceMap.kw(obs=1.0), ()))(keys)
    >>> warmed, result = warmup_chains(
    ...     jax.random.key(1), trs, gx.Selection.at["mu"], n_steps=60, L=5)
    >>> bool(result.eps > 0), result.inv_mass["mu"].shape
    (True, ())
    """
    if target_accept is None:
        target_accept = 0.8 if algorithm == "hmc" else 0.574
    if n_chains is None:
        n_chains = jnp.shape(traces.get_score())[0]
    axes = _chain_axes(traces, n_chains)

    # Phase schedule (fractions of n_steps): eps-only burn-in on unit
    # mass, mass estimation, eps polish under the final metric.
    n1 = max(1, int(0.3 * n_steps))
    n3 = max(1, int(0.2 * n_steps))
    n2 = max(1, n_steps - n1 - n3)

    k1, k2, k3 = jrand.split(key, 3)
    da = da_init(eps0)
    inv_mass = None

    traces, da, _ = _adaptive_phase(
        k1, traces, axes, n_chains, selection, algorithm, L, inv_mass, da,
        n1, target_accept, jitter,
    )

    if adapt_mass:
        inv_mass = cross_chain_inv_mass(traces, selection, n_chains)
        # The metric changed, so the phase-1 step size is tuned for the
        # wrong geometry; under a variance-matched metric the conditioned
        # target is roughly isotropic unit-scale, so restart averaging
        # from eps = 1 (dual averaging recovers in a few steps either way).
        da = da_init(1.0)
    traces, da2, _ = _adaptive_phase(
        k2, traces, axes, n_chains, selection, algorithm, L, inv_mass, da,
        n2, target_accept, jitter,
    )

    if adapt_mass:
        inv_mass = cross_chain_inv_mass(traces, selection, n_chains)
    traces, da3, accept_hist = _adaptive_phase(
        k3, traces, axes, n_chains, selection, algorithm, L, inv_mass, da2,
        n3, target_accept, jitter,
    )

    return traces, WarmupResult(
        eps=da_final(da3),
        inv_mass=inv_mass,
        accept_rate=jnp.mean(accept_hist),
    )
