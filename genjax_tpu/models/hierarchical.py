"""Hierarchical partial pooling (eight schools) with an exact
quadrature oracle.

The canonical multilevel model (Rubin 1981; Gelman et al. BDA §5.5):
J groups each report an effect estimate ``y_j`` with known standard
error ``sigma_j``; group effects ``theta_j`` share a population prior
``N(mu, tau^2)``. The posterior over ``(mu, tau)`` is the classic
funnel — the standard stress test for gradient-based samplers.

No reference counterpart (genjax-community/genjax ships no hierarchical
model family); this module follows the same gallery conventions as
`models/logreg.py` and validates against closed forms:

- **Non-centered parameterization** (`eight_schools`): latents are
  ``(mu, log_tau, z)`` with ``theta = mu + tau * z`` — the geometry
  HMC-family samplers need in the small-``tau`` funnel neck, and the
  accelerator-friendly layout (one vectorized ``z`` site, no per-group
  addresses).
- **Centered parameterization** (`eight_schools_centered`): latents
  ``(mu, log_tau, theta)`` — kept as the funnel-pathology demonstrator.
- ``tau`` is sampled in log space via `exp_half_cauchy` (X = log
  HalfCauchy), so gradient samplers never hit the ``tau >= 0``
  boundary; models recover ``tau = exp(log_tau)`` internally.
- **Exact oracle** (`eight_schools_quadrature`): marginalizing
  ``theta`` gives ``y_j | mu, tau ~ N(mu, sigma_j^2 + tau^2)``, so the
  2-D posterior ``p(mu, log_tau | y)`` is computable on a grid to
  quadrature accuracy, and each ``theta_j | mu, tau, y_j`` is Gaussian
  in closed form — exact posterior moments for every latent, with no
  Monte Carlo error on the oracle side.
"""

import jax
import jax.numpy as jnp

from genjax_tpu import exp_half_cauchy, gen, mv_normal_diag, normal
from genjax_tpu.core.choice_map import ChoiceMap
from genjax_tpu.core.pytree import Pytree

# Rubin (1981) SAT coaching data.
EIGHT_SCHOOLS_Y = jnp.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
EIGHT_SCHOOLS_SIGMA = jnp.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])

MU_SCALE = 5.0
TAU_SCALE = 5.0


@gen
def eight_schools(sigma):
    """Non-centered: theta = mu + tau * z with z ~ N(0, I)."""
    j = sigma.shape[-1]
    mu = normal(0.0, MU_SCALE) @ "mu"
    log_tau = exp_half_cauchy(TAU_SCALE) @ "log_tau"
    z = mv_normal_diag(jnp.zeros(j), jnp.ones(j)) @ "z"
    theta = mu + jnp.exp(log_tau) * z
    _ = mv_normal_diag(theta, sigma) @ "ys"
    return theta


@gen
def eight_schools_centered(sigma):
    """Centered: theta sampled directly — the funnel-pathology variant."""
    j = sigma.shape[-1]
    mu = normal(0.0, MU_SCALE) @ "mu"
    log_tau = exp_half_cauchy(TAU_SCALE) @ "log_tau"
    tau = jnp.exp(log_tau)
    theta = mv_normal_diag(mu * jnp.ones(j), tau * jnp.ones(j)) @ "theta"
    _ = mv_normal_diag(theta, sigma) @ "ys"
    return theta


@Pytree.dataclass
class HierarchicalOracle(Pytree):
    """Exact posterior moments from 2-D quadrature over (mu, log_tau)."""

    mu_mean: jnp.ndarray
    mu_var: jnp.ndarray
    tau_mean: jnp.ndarray
    tau_var: jnp.ndarray
    log_tau_mean: jnp.ndarray
    theta_mean: jnp.ndarray  # (J,)
    theta_var: jnp.ndarray  # (J,)
    log_evidence: jnp.ndarray


def eight_schools_quadrature(
    y,
    sigma,
    *,
    n_mu: int = 601,
    n_lt: int = 601,
    mu_span: float = 40.0,
    lt_lo: float = -12.0,
    lt_hi: float = 7.0,
) -> HierarchicalOracle:
    """Exact (to quadrature) posterior moments for the eight-schools
    model — either parameterization; they define the same joint over
    ``(mu, tau, theta)``.

    Marginalizing ``theta``: ``y_j | mu, tau ~ N(mu, sigma_j^2 + tau^2)``
    and ``theta_j | mu, tau, y_j`` is the precision-weighted Gaussian
    ``N((y_j tau^2 + mu sigma_j^2) / (tau^2 + sigma_j^2),
    tau^2 sigma_j^2 / (tau^2 + sigma_j^2))`` (stable at tau = 0). The
    grid covers ``mu in [-mu_span, mu_span]``, ``log_tau in
    [lt_lo, lt_hi]`` — the prior+likelihood mass outside is negligible
    at the defaults for data on the eight-schools scale.
    """
    mus = jnp.linspace(-mu_span, mu_span, n_mu)
    lts = jnp.linspace(lt_lo, lt_hi, n_lt)
    mu_g, lt_g = jnp.meshgrid(mus, lts, indexing="ij")  # (n_mu, n_lt)
    tau2 = jnp.exp(2.0 * lt_g)

    # log prior
    lp = normal.logpdf(mu_g, 0.0, MU_SCALE) + exp_half_cauchy.logpdf(
        lt_g, TAU_SCALE
    )
    # log marginal likelihood of each y_j given (mu, tau)
    var = tau2[..., None] + sigma[None, None, :] ** 2
    resid2 = (y[None, None, :] - mu_g[..., None]) ** 2
    lp = lp + jnp.sum(
        -0.5 * (jnp.log(2.0 * jnp.pi * var) + resid2 / var), axis=-1
    )

    dmu = mus[1] - mus[0]
    dlt = lts[1] - lts[0]
    log_z = jax.scipy.special.logsumexp(lp) + jnp.log(dmu * dlt)
    w = jnp.exp(lp - jax.scipy.special.logsumexp(lp))

    def mom(f):
        m1 = jnp.sum(w * f)
        return m1, jnp.sum(w * f * f) - m1 * m1

    mu_mean, mu_var = mom(mu_g)
    tau = jnp.exp(lt_g)
    tau_mean, tau_var = mom(tau)
    lt_mean = jnp.sum(w * lt_g)

    # conditional theta moments, then mixed over the grid
    s2 = sigma[None, None, :] ** 2
    t2 = tau2[..., None]
    cond_m = (y[None, None, :] * t2 + mu_g[..., None] * s2) / (t2 + s2)
    cond_v = t2 * s2 / (t2 + s2)
    th_mean = jnp.sum(w[..., None] * cond_m, axis=(0, 1))
    th_m2 = jnp.sum(w[..., None] * (cond_v + cond_m * cond_m), axis=(0, 1))
    return HierarchicalOracle(
        mu_mean=mu_mean,
        mu_var=mu_var,
        tau_mean=tau_mean,
        tau_var=tau_var,
        log_tau_mean=lt_mean,
        theta_mean=th_mean,
        theta_var=th_m2 - th_mean * th_mean,
        log_evidence=log_z,
    )


def run_eight_schools(
    key,
    y=EIGHT_SCHOOLS_Y,
    sigma=EIGHT_SCHOOLS_SIGMA,
    *,
    algorithm: str = "chees",
    n_chains: int = 64,
    n_warmup: int = 300,
    n_samples: int = 500,
    **kwargs,
):
    """Sample the non-centered posterior; returns `PosteriorSamples`
    plus derived per-school ``theta`` draws of shape
    ``(n_chains, n_samples, J)``.

    ``log_tau`` is initialized Uniform(-2, 2) per chain (Stan's
    convention) rather than from its half-Cauchy prior: prior draws
    occasionally start a chain at tau ~ e^7, where the z-conditional
    is so narrow that a globally-adapted step size never moves it —
    the stuck chains then bias tau upward with rhat > 1.2. (Found
    against the quadrature oracle; see `sample_posterior(init=...)`.)"""
    from genjax_tpu.inference.sample import sample_posterior

    out = sample_posterior(
        key,
        eight_schools,
        ChoiceMap.kw(ys=y),
        (sigma,),
        algorithm=algorithm,
        n_chains=n_chains,
        n_warmup=n_warmup,
        n_samples=n_samples,
        init=lambda k: ChoiceMap.kw(
            log_tau=jax.random.uniform(k, minval=-2.0, maxval=2.0)
        ),
        **kwargs,
    )
    mu = out.samples["mu"]
    tau = jnp.exp(out.samples["log_tau"])
    theta = mu[..., None] + tau[..., None] * out.samples["z"]
    return out, theta
