"""Gaussian process models: kernels, a GP-regression generative
function, and an elliptical-slice-sampled latent-GP driver.

Application model family beyond the reference's zoo (its cookbook stops
at curve fitting with iid coefficient priors,
`docs/cookbook/active/intro.ipynb`). GPs are the canonical use case for
`inference.requests.EllipticalSlice`: the latent function values carry
a CORRELATED Gaussian prior (one `mv_normal` site), and conjugate
GP regression gives closed-form posterior mean/covariance/LML oracles
for exactness tests.

Accelerator notes: kernel matrices are dense (n, n) Gram matrices built from
one `x @ x.T`-style broadcast — matrix-unit work — and the Cholesky in
`mv_normal` keeps the prior draw dense. Latent-GP inference (non-
Gaussian likelihoods) composes the `gp_latent` site with any likelihood
and runs tuning-free under ESS.
"""

from typing import Any

import jax
import jax.numpy as jnp

from genjax_tpu.core.choice_map import ChoiceMap, Selection
from genjax_tpu.core.gfi import GenerativeFunction
from genjax_tpu.core.typing import FloatArray, PRNGKey
from genjax_tpu.lang.static import gen

__all__ = [
    "rbf_kernel",
    "matern32_kernel",
    "make_gp_regression",
    "gp_posterior",
    "run_gp_ess",
]


def _sqdist(xs: FloatArray, zs: FloatArray) -> FloatArray:
    """Pairwise squared distances; inputs (n,) or (n, d).

    Direct broadcast differences, NOT the x2 + z2 - 2 x.z matmul trick:
    at the GPU's default TF32 matmul precision the cancellation
    makes near-zero distances slightly negative, which destroys the
    Gram matrix's positive-definiteness (Cholesky NaNs downstream).
    Model input sets are small, so the O(n^2 d) broadcast is free.
    """
    xs = xs[:, None] if xs.ndim == 1 else xs
    zs = zs[:, None] if zs.ndim == 1 else zs
    diff = xs[:, None, :] - zs[None, :, :]
    return jnp.sum(diff * diff, axis=-1)


def rbf_kernel(xs, zs, lengthscale=1.0, variance=1.0):
    """Squared-exponential kernel matrix k(xs, zs)."""
    return variance * jnp.exp(-0.5 * _sqdist(xs, zs) / lengthscale**2)


def matern32_kernel(xs, zs, lengthscale=1.0, variance=1.0):
    """Matern-3/2 kernel matrix."""
    r = jnp.sqrt(_sqdist(xs, zs)) / lengthscale
    s3r = jnp.sqrt(3.0) * r
    return variance * (1.0 + s3r) * jnp.exp(-s3r)


def make_gp_regression(
    kernel=rbf_kernel, jitter: float = 1e-5
) -> GenerativeFunction[Any]:
    """GP regression as a generative function: latent function values
    `f ~ N(0, K(xs, xs))` at the site "f", observations
    `y ~ N(f, obs_noise)` at "y". Arguments: `(xs, obs_noise,
    lengthscale, variance)`."""
    from genjax_tpu.distributions.library import mv_normal, normal

    @gen
    def gp_regression(xs, obs_noise, lengthscale, variance):
        n = xs.shape[0]
        K = kernel(xs, xs, lengthscale, variance) + jitter * jnp.eye(n)
        f = mv_normal(jnp.zeros(n), K) @ "f"
        _ = normal(f, obs_noise * jnp.ones(n)) @ "y"
        return f

    return gp_regression


def gp_posterior(xs, ys, obs_noise, lengthscale=1.0, variance=1.0, kernel=rbf_kernel):
    """Exact conjugate GP-regression posterior over f(xs): returns
    `(mean, cov, lml)` — the oracle for the sampling drivers."""
    n = xs.shape[0]
    K = kernel(xs, xs, lengthscale, variance)
    S = K + obs_noise**2 * jnp.eye(n)
    L = jnp.linalg.cholesky(S)
    alpha = jax.scipy.linalg.cho_solve((L, True), ys)
    mean = K @ alpha
    cov = K - K @ jax.scipy.linalg.cho_solve((L, True), K)
    lml = (
        -0.5 * ys @ alpha
        - jnp.sum(jnp.log(jnp.diag(L)))
        - 0.5 * n * jnp.log(2.0 * jnp.pi)
    )
    return mean, cov, lml


def run_gp_ess(
    key: PRNGKey,
    xs: FloatArray,
    ys: FloatArray,
    n_steps: int = 2000,
    obs_noise: float = 0.3,
    lengthscale: float = 1.0,
    variance: float = 1.0,
    kernel=rbf_kernel,
):
    """Sample the latent GP with elliptical slice sampling (tuning-free;
    the correlated prior draw comes from the model's own `mv_normal`
    site via `Regenerate`). Returns the (n_steps, n) chain of latent
    function values."""
    from genjax_tpu.inference.mcmc import mh_chain
    from genjax_tpu.inference.requests import EllipticalSlice

    model = make_gp_regression(kernel)
    args = (xs, obs_noise, lengthscale, variance)
    tr, _ = model.importance(key, ChoiceMap.kw(y=ys), args)
    req = EllipticalSlice(Selection.at["f"], mean=0.0)
    _, fs = mh_chain(
        jax.random.fold_in(key, 1),
        tr,
        req,
        n_steps,
        collect=lambda t: t.get_choices()["f"],
    )
    return fs
