"""Structural time series: composable level/trend/seasonal/AR state-
space components with exact Kalman inference and gradient-based
marginal-likelihood fitting.

Application model family beyond the reference (its state-space coverage
is the discrete HMM testbed, `_src/generative_functions/distributions/
discrete_hmm.py`). Components assemble block-diagonally into a
`LinearGaussianSSM` (`inference/kalman.py`), so filtering, smoothing,
decomposition, forecasting, and the exact log marginal likelihood all
come from the shared Kalman algebra — and because that algebra is plain
traced JAX, `lml` is DIFFERENTIABLE: `fit` trains the component scales
by direct gradient ascent on the exact evidence (no E-M, no sampling).

Accelerator notes: one `lax.scan` over time with small dense matrix algebra per
step; fitting is `jax.value_and_grad` through the scan inside an optax
loop — a single compiled program.
"""

from typing import Any

import jax
import jax.numpy as jnp

from genjax_tpu.core.pytree import Pytree
from genjax_tpu.core.typing import FloatArray
from genjax_tpu.inference.kalman import LinearGaussianSSM

__all__ = [
    "ar",
    "local_level",
    "local_linear_trend",
    "seasonal",
    "StructuralTimeSeries",
]


@Pytree.dataclass
class _Component(Pytree):
    """One STS block: transition `A` (d, d), process noise stds
    `q` (d,), emission row `h` (d,), initial std `p0` (d,)."""

    name: str = Pytree.static()
    A: FloatArray = Pytree.field()
    q: FloatArray = Pytree.field()
    h: FloatArray = Pytree.field()
    p0: FloatArray = Pytree.field()


def local_level(level_scale=0.1, initial_scale=10.0) -> _Component:
    """Random-walk level: x_t = x_{t-1} + N(0, level_scale^2)."""
    return _Component(
        "level",
        jnp.eye(1),
        jnp.asarray([level_scale], dtype=jnp.result_type(float)),
        jnp.ones(1),
        jnp.asarray([initial_scale], dtype=jnp.result_type(float)),
    )


def local_linear_trend(
    level_scale=0.1, slope_scale=0.05, initial_scale=10.0
) -> _Component:
    """Level + integrated slope (Holt-style trend)."""
    return _Component(
        "trend",
        jnp.array([[1.0, 1.0], [0.0, 1.0]]),
        jnp.asarray([level_scale, slope_scale], dtype=jnp.result_type(float)),
        jnp.array([1.0, 0.0]),
        jnp.full(2, initial_scale, dtype=jnp.result_type(float)),
    )


def seasonal(num_seasons: int, drift_scale=0.01, initial_scale=5.0) -> _Component:
    """Sum-to-zero seasonal effect with `num_seasons` seasons: the
    current effect is minus the sum of the previous S-1 effects plus
    drift noise."""
    s = num_seasons - 1
    A = jnp.zeros((s, s)).at[0].set(-1.0)
    A = A.at[jnp.arange(1, s), jnp.arange(0, s - 1)].set(1.0)
    q = jnp.zeros(s).at[0].set(drift_scale)
    h = jnp.zeros(s).at[0].set(1.0)
    return _Component(
        f"seasonal{num_seasons}",
        A,
        jnp.asarray(q, dtype=jnp.result_type(float)),
        h,
        jnp.full(s, initial_scale, dtype=jnp.result_type(float)),
    )


def ar(coefficient=0.8, scale=0.2, initial_scale=None) -> _Component:
    """AR(1) disturbance component."""
    if initial_scale is None:
        # stationary std
        initial_scale = float(scale) / max(
            (1.0 - float(coefficient) ** 2) ** 0.5, 1e-3
        )
    return _Component(
        "ar1",
        jnp.asarray([[coefficient]], dtype=jnp.result_type(float)),
        jnp.asarray([scale], dtype=jnp.result_type(float)),
        jnp.ones(1),
        jnp.asarray([initial_scale], dtype=jnp.result_type(float)),
    )


@Pytree.dataclass
class StructuralTimeSeries(Pytree):
    """Sum of STS components observed with Gaussian noise.

    >>> import jax, jax.numpy as jnp
    >>> from genjax_tpu.models.sts import (
    ...     StructuralTimeSeries, local_level, seasonal)
    >>> sts = StructuralTimeSeries(
    ...     (local_level(0.2), seasonal(4, 0.01)), obs_noise=0.3)
    >>> _, ys = sts.ssm().sample(jax.random.key(0), 40)
    >>> float(sts.lml(ys[:, 0])) < 0.0
    True
    >>> parts = sts.decompose(ys[:, 0])
    >>> sorted(parts)
    ['level', 'seasonal4']
    """

    components: tuple
    obs_noise: Any = Pytree.field(default=0.1)

    def _dims(self):
        return [c.A.shape[0] for c in self.components]

    def ssm(self) -> LinearGaussianSSM:
        """Assemble the block-diagonal LinearGaussianSSM."""
        dims = self._dims()
        d = sum(dims)
        A = jnp.zeros((d, d))
        Q = jnp.zeros((d, d))
        P0 = jnp.zeros((d, d))
        H = jnp.zeros((1, d))
        off = 0
        for c, dc in zip(self.components, dims):
            sl = slice(off, off + dc)
            A = A.at[sl, sl].set(c.A)
            Q = Q.at[sl, sl].set(jnp.diag(c.q**2))
            P0 = P0.at[sl, sl].set(jnp.diag(c.p0**2))
            H = H.at[0, sl].set(c.h)
            off += dc
        R = jnp.asarray(self.obs_noise, dtype=jnp.result_type(float)) ** 2
        return LinearGaussianSSM(A, Q, H, R[None, None], jnp.zeros(d), P0)

    def lml(self, ys: FloatArray) -> FloatArray:
        """Exact log marginal likelihood of the (T,) series."""
        return self.ssm().lml(ys[:, None])

    def decompose(self, ys: FloatArray) -> dict:
        """Smoothed per-component observation contributions:
        `{name: (T,) series}` summing (with noise) to the fit."""
        mus, _ = self.ssm().smooth(ys[:, None])
        out = {}
        off = 0
        for c, dc in zip(self.components, self._dims()):
            out[c.name] = mus[:, off : off + dc] @ c.h
            off += dc
        return out

    def forecast(self, ys: FloatArray, horizon: int):
        """Predictive means and VARIANCES for the next `horizon` steps
        given the (T,) history — closed form, no sampling."""
        m = self.ssm()
        mus, Ps, _ = m.filter(ys[:, None])

        def step(carry, _):
            mu, P = carry
            # full f32 matmul precision: the covariance recursion on
            # singular-Q blocks can drift under the GPU's default TF32
            # matmuls (same hazard kalman._predict_update_full guards).
            with jax.default_matmul_precision("float32"):
                mu = m.A @ mu
                P = m.A @ P @ m.A.T + m.Q
                y_mean = (m.H @ mu)[0]
                y_var = (m.H @ P @ m.H.T + m.R)[0, 0]
            return (mu, P), (y_mean, y_var)

        _, (means, variances) = jax.lax.scan(
            step, (mus[-1], Ps[-1]), None, length=horizon
        )
        return means, variances

    def fit(
        self,
        ys: FloatArray,
        n_steps: int = 300,
        learning_rate: float = 0.05,
    ) -> "tuple[StructuralTimeSeries, FloatArray]":
        """Maximize the exact marginal likelihood over every component's
        noise scales and the observation noise by gradient ascent in
        log-scale space (the Kalman filter is differentiable traced
        JAX). Returns `(fitted_sts, lml_history)`."""
        import jax.tree_util as jtu
        import optax

        # Structurally-zero process-noise entries (e.g. the seasonal
        # block's non-drift states) are part of the component's
        # DEFINITION, not parameters: freeing them would let the
        # optimizer silently leave the model class (a "seasonal" block
        # with noise in its sum-to-zero recursion is no longer
        # sum-to-zero). Only entries that start positive are trained.
        masks = [c.q > 0 for c in self.components]

        def pack(sts):
            return (
                [jnp.log(c.q + 1e-8) for c in sts.components],
                jnp.log(jnp.asarray(sts.obs_noise) + 1e-8),
            )

        def unpack(params):
            logqs, log_r = params
            comps = tuple(
                _Component(
                    c.name,
                    c.A,
                    jnp.where(mask, jnp.exp(lq), 0.0),
                    c.h,
                    c.p0,
                )
                for c, lq, mask in zip(self.components, logqs, masks)
            )
            return StructuralTimeSeries(comps, jnp.exp(log_r))

        def loss(params):
            return -unpack(params).lml(ys)

        params = pack(self)
        optimizer = optax.adam(learning_rate)
        opt_state = optimizer.init(params)

        def step(carry, _):
            params, opt_state = carry
            neg_lml, grads = jax.value_and_grad(loss)(params)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), -neg_lml

        (params, _), history = jax.lax.scan(
            step, (params, opt_state), None, length=n_steps
        )
        return unpack(params), history
