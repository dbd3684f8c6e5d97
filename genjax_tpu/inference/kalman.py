"""Exact inference for linear-Gaussian state-space models (Kalman).

The continuous counterpart of `distributions/discrete_hmm.py` (reference
`_src/generative_functions/distributions/discrete_hmm.py` ships the
discrete exact testbed only): filtering, RTS smoothing, and the exact
log marginal likelihood for

    z_0 ~ N(mu0, P0),   z_t = A z_{t-1} + N(0, Q),   y_t = H z_t + N(0, R),

with y_0 observed at t = 0 (no predict step before the first update —
the same convention as `BootstrapFilter` models whose init traces an
observation). Everything is a `lax.scan` of dense (d, d) linear algebra:
jit/vmap-friendly, and the oracle of choice for validating particle
filters, PMMH/particle-Gibbs chains, and MAP/Laplace output on
conjugate-linear models (see tests/inference/test_kalman_oracle.py).
"""

from typing import Any

import jax
import jax.numpy as jnp

from genjax_tpu.core.pytree import Pytree
from genjax_tpu.core.typing import FloatArray, PRNGKey

__all__ = ["LinearGaussianSSM", "kalman_predict_update"]


def _predict_update_full(A, Q, H, R, mu, P, y, predict=True):
    """Predict+update returning the predicted moments too (the smoother
    needs them); the single source of the Kalman algebra.

    Runs at full f32 matmul precision: the GPU's default TF32 matmuls
    (10 mantissa bits) can let the covariance recursion drift enough to
    corrupt smoothed states in near-singular models (singular-Q STS
    seasonal blocks). These are tiny matrices; precision here is free."""
    with jax.default_matmul_precision("float32"):
        return _predict_update_full_impl(A, Q, H, R, mu, P, y, predict)


def _predict_update_full_impl(A, Q, H, R, mu, P, y, predict=True):
    mu_pred = jnp.where(predict, A @ mu, mu)
    P_pred = jnp.where(predict, A @ P @ A.T + Q, P)
    S = H @ P_pred @ H.T + R
    resid = y - H @ mu_pred
    chol = jnp.linalg.cholesky(S)
    white = jax.scipy.linalg.solve_triangular(chol, resid, lower=True)
    ll = (
        -0.5 * jnp.sum(white**2)
        - jnp.sum(jnp.log(jnp.diagonal(chol)))
        - 0.5 * H.shape[0] * jnp.log(2.0 * jnp.pi)
    )
    K = P_pred @ jax.scipy.linalg.cho_solve((chol, True), H).T
    mu_new = mu_pred + K @ resid
    P_new = (jnp.eye(P.shape[0]) - K @ H) @ P_pred
    return mu_new, P_new, ll, mu_pred, P_pred


def kalman_predict_update(A, Q, H, R, mu, P, y, predict=True):
    """One Kalman step: (optionally) predict through (A, Q), then update
    on `y` through (H, R). Returns `(mu', P', log p(y | past))` — the
    innovation log-likelihood that particle-filter weights (and the LML)
    are built from. Pure dense algebra; vmap over particles freely."""
    mu_new, P_new, ll, _, _ = _predict_update_full(
        A, Q, H, R, mu, P, y, predict=predict
    )
    return mu_new, P_new, ll


def _at_least_2d(M, d):
    M = jnp.asarray(M, dtype=jnp.result_type(float))
    if M.ndim == 0:
        return M * jnp.eye(d)
    if M.ndim == 1:
        # a vector means per-dimension diagonal dynamics — passing it
        # through raw would make A @ mu an inner product and silently
        # corrupt every covariance via broadcasting
        return jnp.diag(M)
    return M


@Pytree.dataclass
class LinearGaussianSSM(Pytree):
    """Model matrices: `A` (d,d) transition, `Q` (d,d) transition noise
    covariance, `H` (p,d) emission, `R` (p,p) emission noise covariance,
    `mu0` (d,) / `P0` (d,d) initial state. Scalars broadcast to
    identity-scaled matrices.

    >>> import jax.numpy as jnp
    >>> from genjax_tpu.inference.kalman import LinearGaussianSSM
    >>> m = LinearGaussianSSM.build(a=0.9, q=0.5, h=1.0, r=0.4, d=1)
    >>> ys = jnp.array([[0.3], [1.0], [0.5]])
    >>> mus, Ps, lml = m.filter(ys)
    >>> mus.shape, Ps.shape, bool(jnp.isfinite(lml))
    ((3, 1), (3, 1, 1), True)
    """

    A: FloatArray
    Q: FloatArray
    H: FloatArray
    R: FloatArray
    mu0: FloatArray
    P0: FloatArray

    @staticmethod
    def build(a, q, h, r, d: int = 1, p: int | None = None, mu0=None, p0=1.0):
        """Convenience constructor from scalars or matrices; `q`, `r`,
        `p0` are noise STANDARD DEVIATIONS when given as scalars."""
        if p is None:
            p = d
        A = _at_least_2d(a, d)
        def noise_cov(v, n):
            # scalar/vector inputs are per-dimension noise STDS; only a
            # full matrix is taken as a covariance verbatim
            v = jnp.asarray(v, dtype=jnp.result_type(float))
            if v.ndim == 0:
                return v**2 * jnp.eye(n)
            if v.ndim == 1:
                return jnp.diag(v**2)
            return v

        Q = noise_cov(q, d)
        H = (
            jnp.asarray(h, dtype=jnp.result_type(float)) * jnp.eye(p, d)
            if jnp.ndim(h) == 0
            else _at_least_2d(h, d)
        )
        R = noise_cov(r, p)
        mu0 = jnp.zeros(d) if mu0 is None else jnp.asarray(mu0)
        P0 = noise_cov(p0, d)
        return LinearGaussianSSM(A, Q, H, R, mu0, P0)

    def filter(self, ys: FloatArray):
        """Forward pass; returns `(filtered_means (T, d), filtered_covs
        (T, d, d), log_marginal_likelihood)`. `ys` is (T, p)."""
        A, Q, H, R = self.A, self.Q, self.H, self.R
        p = H.shape[0]

        def step(carry, inp):
            mu, P, t = carry
            y = inp
            mu_new, P_new, ll = kalman_predict_update(
                A, Q, H, R, mu, P, y, predict=(t != 0)
            )
            return (mu_new, P_new, t + 1), (mu_new, P_new, ll)

        (_, _, _), (mus, Ps, lls) = jax.lax.scan(
            step, (self.mu0, self.P0, 0), ys
        )
        return mus, Ps, jnp.sum(lls)

    def lml(self, ys: FloatArray) -> FloatArray:
        """Exact log p(y_{0:T-1})."""
        _, _, l = self.filter(ys)
        return l

    def smooth(self, ys: FloatArray):
        """RTS smoothing pass; returns `(smoothed_means (T, d),
        smoothed_covs (T, d, d))`."""
        A, Q = self.A, self.Q

        # re-run the filter, keeping predicted moments (one shared
        # implementation of the Kalman algebra: _predict_update_full)
        def fstep(carry, y):
            mu, P, t = carry
            mu_new, P_new, _, mu_pred, P_pred = _predict_update_full(
                A, Q, self.H, self.R, mu, P, y, predict=(t != 0)
            )
            return (mu_new, P_new, t + 1), (mu_new, P_new, mu_pred, P_pred)

        _, (mus, Ps, mu_preds, P_preds) = jax.lax.scan(
            fstep, (self.mu0, self.P0, 0), ys
        )

        # backward: mu_s[t] = mu_f[t] + C (mu_s[t+1] - mu_pred[t+1]),
        # C = P_f[t] A^T P_pred[t+1]^+  — pseudo-inverse, NOT solve:
        # models with deterministic state directions (singular Q, e.g.
        # STS seasonal blocks) make P_pred near-singular, and the LU
        # solve turns into garbage gains in f32 (smoothed seasonal
        # correlation fell from 0.9999 to -0.11 before this). The PSD
        # eigh pseudo-inverse is the correct limit: null directions of
        # P_pred are also null in P_f A^T, so they get zero gain.
        def _pinv_psd(M):
            s, U = jnp.linalg.eigh(M)
            cutoff = 1e-6 * jnp.max(s)
            inv = jnp.where(s > cutoff, 1.0 / jnp.where(s > cutoff, s, 1.0), 0.0)
            return (U * inv[None, :]) @ U.T

        def bstep(carry, inp):
            mu_s_next, P_s_next = carry
            mu_f, P_f, mu_pred_next, P_pred_next = inp
            with jax.default_matmul_precision("float32"):
                C = P_f @ A.T @ _pinv_psd(P_pred_next)
                mu_s = mu_f + C @ (mu_s_next - mu_pred_next)
                P_s = P_f + C @ (P_s_next - P_pred_next) @ C.T
            return (mu_s, P_s), (mu_s, P_s)

        inputs = (
            mus[:-1],
            Ps[:-1],
            mu_preds[1:],
            P_preds[1:],
        )
        _, (mu_s_rest, P_s_rest) = jax.lax.scan(
            bstep, (mus[-1], Ps[-1]), inputs, reverse=True
        )
        mu_s = jnp.concatenate([mu_s_rest, mus[-1:]], axis=0)
        P_s = jnp.concatenate([P_s_rest, Ps[-1:]], axis=0)
        return mu_s, P_s

    def sample(self, key: PRNGKey, T: int):
        """Simulate `(latents (T, d), observations (T, p))`.

        Noise factors use an eigendecomposition square root, not
        Cholesky: models with deterministic state directions (e.g. STS
        seasonal blocks) have SINGULAR Q, where Cholesky is NaN but the
        PSD square root is well-defined."""

        def psd_sqrt(M):
            s, U = jnp.linalg.eigh(M)
            return U * jnp.sqrt(jnp.maximum(s, 0.0))[None, :]

        d = self.A.shape[0]
        p = self.H.shape[0]
        kz0, krest = jax.random.split(key)
        cholP0 = psd_sqrt(self.P0)
        cholQ = psd_sqrt(self.Q)
        cholR = psd_sqrt(self.R)
        z0 = self.mu0 + cholP0 @ jax.random.normal(kz0, (d,))

        def step(z, k):
            kz, ky = jax.random.split(k)
            y = self.H @ z + cholR @ jax.random.normal(ky, (p,))
            z_next = self.A @ z + cholQ @ jax.random.normal(kz, (d,))
            return z_next, (z, y)

        _, (zs, ys) = jax.lax.scan(step, z0, jax.random.split(krest, T))
        return zs, ys
