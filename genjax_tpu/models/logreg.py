"""Benchmark config 4: Bayesian logistic regression — HMC/MALA over
thousands of vectorized parallel chains.

The per-chain density is dominated by the `X @ w` matvec; vmapped over
chains it becomes a `(chains, D) @ (D, N)` matmul — matrix-unit work, exactly
where accelerator FLOPs should go.
"""

import jax
import jax.numpy as jnp

from genjax_tpu import ChoiceMap, Selection, bernoulli, gen, mv_normal_diag
from genjax_tpu.inference.mcmc import run_chains, share_chain_args
from genjax_tpu.inference.requests import HMC, MALA


@gen
def logistic_regression(X):
    d = X.shape[-1]
    w = mv_normal_diag(jnp.zeros(d), jnp.ones(d)) @ "w"
    logits = X @ w
    # logit parameterization: softplus-stable density (sigmoid+probs
    # saturates in f32 and NaNs HMC gradients at |logit| > ~17)
    _ = bernoulli(logits=logits) @ "ys"
    return logits


def simulate_logreg_data(key, n: int, d: int):
    kx, kw, ky = jax.random.split(key, 3)
    X = jax.random.normal(kx, (n, d))
    w_true = jax.random.normal(kw, (d,))
    ys = jax.random.bernoulli(ky, jax.nn.sigmoid(X @ w_true)).astype(jnp.int32)
    return X, ys, w_true


def _init_chains(key, X, ys, n_chains):
    keys = jax.random.split(key, n_chains)
    trs, _ = jax.vmap(
        lambda k: logistic_regression.importance(k, ChoiceMap.kw(ys=ys), (X,))
    )(keys)
    # One shared copy of the (N, D) design matrix instead of n_chains
    # broadcast copies — every HMC density pass then reads the shared
    # operand (see mcmc.share_chain_args).
    return share_chain_args(trs, (X,))


def run_hmc_chains(
    key, X, ys, n_chains: int = 8192, n_steps: int = 100, eps: float = 0.05, L: int = 10
):
    """Vectorized HMC: returns (final w draws, acceptance mask history)."""
    k_init, k_run = jax.random.split(key)
    trs = _init_chains(k_init, X, ys, n_chains)
    request = HMC(Selection.at["w"], jnp.asarray(eps), L=L)
    finals, accs = run_chains(k_run, trs, request, n_steps)
    return finals.get_choices()["w"], accs


def run_nuts_chains(
    key, X, ys, n_chains: int = 8192, n_steps: int = 100,
    eps: float = 0.05, max_depth: int = 6,
):
    """Vectorized NUTS: returns (final w draws, acceptance-stat history).

    Each draw costs exactly `2**max_depth - 1` gradient passes (the
    fixed-schedule SIMD batching of inference/requests/nuts.py), so the
    benchmark comparison against HMC quantifies the padding trade."""
    from genjax_tpu.inference.requests import NUTS

    k_init, k_run = jax.random.split(key)
    trs = _init_chains(k_init, X, ys, n_chains)
    request = NUTS(Selection.at["w"], jnp.asarray(eps), max_depth=max_depth)
    finals, accs = run_chains(k_run, trs, request, n_steps)
    return finals.get_choices()["w"], accs


def run_mala_chains(
    key, X, ys, n_chains: int = 8192, n_steps: int = 100, eps: float = 0.01
):
    k_init, k_run = jax.random.split(key)
    trs = _init_chains(k_init, X, ys, n_chains)
    request = MALA(Selection.at["w"], jnp.asarray(eps))
    finals, accs = run_chains(k_run, trs, request, n_steps)
    return finals.get_choices()["w"], accs
