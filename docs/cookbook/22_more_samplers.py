"""Cookbook: three more posterior samplers — elliptical slice, SVGD,
and SMC².

When to reach for each:

- **Elliptical slice** (`requests.EllipticalSlice`): the selected sites
  have Gaussian priors (latent GPs, random effects). Tuning-free, every
  step accepted; only needs the prior mean.
- **SVGD** (`svgd.svgd`): you want a deterministic particle
  approximation with gradient information but no chains — e.g. a quick,
  parallel posterior sketch whose particle interaction is matrix products.
- **SMC²** (`smc2.SMC2`): state-space model with unknown parameters,
  processed ONLINE — parameter particles carry their own particle
  filters and rejuvenate via PMMH when they degenerate.
"""

import jax
import jax.numpy as jnp
import numpy as np

import genjax_tpu as genjax
from genjax_tpu import ChoiceMap as C
from genjax_tpu import Selection as S
from genjax_tpu import gen, normal
from genjax_tpu.inference.mcmc import mh_chain
from genjax_tpu.inference.requests import EllipticalSlice
from genjax_tpu.inference.smc2 import SMC2
from genjax_tpu.inference.svgd import svgd


def main():
    # --- 1. elliptical slice sampling on a Gaussian-prior latent ---
    # A tiny "GP regression in disguise": iid N(0.5, 1) prior over an
    # 8-vector f, Gaussian likelihood. Posterior is conjugate:
    # per-dimension N((0.5 + 4 y_i)/5, 1/5).
    D = 8

    @gen
    def latent_field(y):
        f = normal(jnp.full((D,), 0.5), 1.0) @ "f"
        _ = normal(f, 0.5) @ "y"
        return f

    y = jnp.linspace(-1.0, 2.0, D)
    tr, _ = latent_field.importance(jax.random.key(0), C.kw(y=y), (y,))
    # No step size, no trajectory length: just the selection and the
    # prior mean. Every move is accepted.
    req = EllipticalSlice(S.at["f"], mean=0.5)
    _, fs = jax.jit(
        lambda k, t: mh_chain(
            k, t, req, 2000, collect=lambda t: t.get_choices()["f"]
        )
    )(jax.random.key(1), tr)
    post_mean = (0.5 + 4.0 * y) / 5.0
    assert jnp.max(jnp.abs(jnp.mean(fs[400:], 0) - post_mean)) < 0.15

    # --- 2. SVGD: a deterministic particle posterior ---
    @gen
    def scalar_model():
        mu = normal(0.0, 1.0) @ "mu"
        _ = normal(mu, 1.0) @ "obs"
        return mu

    traces, phi_norms = jax.jit(
        lambda k: svgd(
            k, scalar_model, (), C.kw(obs=2.0), S.at["mu"],
            n_particles=128, n_steps=300, step_size=0.3,
        )
    )(jax.random.key(2))
    mus = traces.get_choices()["mu"]
    # exact posterior N(1.0, 0.5); phi -> 0 signals convergence
    assert abs(float(jnp.mean(mus)) - 1.0) < 0.1
    assert float(phi_norms[-1]) < 1e-3

    # --- 3. SMC²: online parameters for a state-space model ---
    @gen
    def init_model(theta):
        z = normal(0.0, 1.0) @ "z"
        _ = normal(z, 0.4) @ "y"
        return z

    @gen
    def step_model(z_prev, t, theta):
        z = normal(theta * z_prev, 0.5) @ "z"
        _ = normal(z, 0.4) @ "y"
        return z

    rng = np.random.default_rng(3)
    z, ys = rng.standard_normal(), []
    ys.append(z + 0.4 * rng.standard_normal())
    for _ in range(24):
        z = 0.8 * z + 0.5 * rng.standard_normal()
        ys.append(z + 0.4 * rng.standard_normal())
    ys = jnp.asarray(np.array(ys, dtype=np.float32))

    alg = SMC2(
        step_model, init_model,
        prior_sample=lambda k: jax.random.normal(k),
        log_prior=lambda v: genjax.normal.logpdf(v, 0.0, 1.0),
        n_theta=128, n_x=128, step_scales=jnp.asarray(0.25),
    )
    out = jax.jit(alg.run)(jax.random.key(4), ys)
    w = jax.nn.softmax(out["log_weights"])
    theta_mean = float(jnp.sum(w * out["thetas"]))
    # Kalman-grid exact posterior mean for this dataset is 0.641
    assert abs(theta_mean - 0.641) < 0.1
    # the population degenerated and was rejuvenated along the way
    assert int(out["n_rejuvenations"]) >= 1
    print("ch22 ok:", theta_mean)


if __name__ == "__main__":
    main()
