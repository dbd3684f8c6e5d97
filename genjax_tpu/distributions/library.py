"""The native distribution library: 44+ distributions implemented directly
on `jax.random` samplers and `jax.scipy.special` densities.

Capability parity with the reference's TFP wrapper set
(`_src/generative_functions/distributions/tensorflow_probability/__init__.py:72-317`,
44 distributions). The reference delegates to TensorFlow Probability; this
build is accelerator-native: every sampler/density is a plain JAX program so the
whole model density fuses into one XLA computation, and every sampler is
`vmap`/`shard_map`-compatible (rejection samplers use `lax.while_loop`,
which JAX batches into masked fixed-point iteration).

Parameterizations follow the TFP conventions the reference exposes, so
models written against the reference port unchanged:
e.g. `normal(loc, scale)`, `gamma(concentration, rate)`,
`bernoulli(logits=...)` (int samples), `flip(prob)` (bool samples),
`categorical(logits=...)`, `inverse_gamma(concentration, scale)`.
"""

import textwrap
import math
import warnings

import jax
import jax.numpy as jnp
from jax.scipy.special import (
    betaln,
    erfinv,
    gammaln,
    log_softmax,
    logit,
    ndtr,
    xlog1py,
    xlogy,
    zeta,
)

from genjax_tpu.core.pytree import Const
from genjax_tpu.distributions.distribution import ExactDensity, exact_density
from genjax_tpu.distributions.mathx import (
    lambertw,
    log_bessel_i0,
    log_bessel_iv,
    log_binom,
)

import math as _math

# python float, NOT a jnp op: a module-level jnp call initializes the
# backend at import time, fixing the platform (and claiming a card)
# before the caller can choose one
_HALF_LOG_2PI = 0.5 * _math.log(2.0 * _math.pi)


def _maybe_sample_shape(kwargs):
    ss = kwargs.pop("sample_shape", ())
    return Const.unwrap_value(ss)


def native_distribution(sample_fn, logpdf_fn, name: str) -> ExactDensity:
    """Build a singleton `ExactDensity` from native JAX sample/logpdf
    callables (the analogue of the reference's `tfp_distribution` factory)."""

    def sampler(key, *args, **kwargs):
        sample_shape = _maybe_sample_shape(kwargs)
        v = sample_fn(key, *args, **kwargs)
        if sample_shape:
            # `sample_shape` is static (a Const): the count must stay a
            # Python int — jnp on constants is STAGED under jit (jax 0.9)
            # and would make the split count a tracer.
            keys = jax.random.split(key, math.prod(tuple(sample_shape)))
            flat = jax.vmap(lambda k: sample_fn(k, *args, **kwargs))(keys)
            return jnp.reshape(flat, tuple(sample_shape) + jnp.shape(v))
        return v

    def logpdf(v, *args, **kwargs):
        kwargs.pop("sample_shape", None)
        return logpdf_fn(v, *args, **kwargs)

    return exact_density(sampler, logpdf, name)


def implicit_logit_warning(make):
    """Bare positional parameters to bernoulli/categorical are interpreted in
    logit scale, with a deprecation warning (reference
    `distribution.py:479-500`)."""

    def wrapper(implicit_logits=None, **kwargs):
        if implicit_logits is not None:
            warnings.warn(
                textwrap.dedent(
                    """
                    The use of a bare argument here is deprecated. Please
                    specify `logits=` or `probs=`. The default, used in this
                    case, is logits."""
                ),
                DeprecationWarning,
            )
            return make(logits=implicit_logits, **kwargs)
        return make(**kwargs)

    return wrapper


def _logits_to_log_probs_bernoulli(logits):
    # (log p, log 1-p) = (-softplus(-l), -softplus(l))
    return -jax.nn.softplus(-logits), -jax.nn.softplus(logits)


def _guard_support(in_support, v, safe, lp_fn):
    """Score `-inf` outside the support instead of NaN or a wrong finite
    value.

    Under the GFI, a logpdf can be handed ANY value of the right shape —
    `Update`/`generate` constraints transplanted across Switch branches,
    Mask flips, or user choice maps land out-of-support values on
    bounded-support densities (found by the structural GFI fuzzer:
    a normal draw constrained onto a beta site scored NaN and poisoned
    the whole edit algebra). The mathematically right score is `-inf`
    (zero density -> impossible trace -> importance weight -inf, MH
    rejects); TFP's unchecked densities return NaN here, which this
    library deliberately does not match.

    Double-`where`: the density formula is evaluated at `safe` where the
    value is outside the support, so gradients at IN-support points never
    see the NaN branch (a single `jnp.where` propagates the untaken
    branch's NaN cotangent).
    """
    vs = jnp.where(in_support, v, safe)
    return jnp.where(in_support, lp_fn(vs), -jnp.inf)


# =====================================================================
# Continuous scalar families
# =====================================================================


def _normal_sample(key, loc, scale):
    return loc + scale * jax.random.normal(key, shape=jnp.shape(loc + scale * 0.0))


def _normal_logpdf(v, loc, scale):
    z = (v - loc) / scale
    return -0.5 * z * z - jnp.log(scale) - _HALF_LOG_2PI


normal = native_distribution(_normal_sample, _normal_logpdf, "normal")


def _uniform_sample(key, low=0.0, high=1.0):
    shape = jnp.shape(jnp.zeros(()) + low + high)
    return jax.random.uniform(key, shape=shape, minval=low, maxval=high)


def _uniform_logpdf(v, low=0.0, high=1.0):
    in_support = (v >= low) & (v <= high)
    return jnp.where(in_support, -jnp.log(high - low), -jnp.inf)


uniform = native_distribution(_uniform_sample, _uniform_logpdf, "uniform")


def _trace_time_scalar(v) -> float | None:
    """The concrete float value of `v` if it is knowable at trace time
    (a python scalar, or a 0-d non-tracer array — e.g. a model literal
    canonicalized by `lang.static._canon_args`, which stays a constant
    under `jit`); None for tracers and non-scalars."""
    if isinstance(v, bool):
        return None
    if isinstance(v, (int, float)):
        return float(v)
    from genjax_tpu.core.typing import static_check_is_concrete

    if static_check_is_concrete(v) and jnp.ndim(v) == 0:
        try:
            return float(v)
        except (TypeError, ValueError):
            return None
    return None


def _static_small_int(v, limit: float) -> int | None:
    """If `v` is a trace-time-concrete positive integer <= limit, return
    it; else None. (Model hyperparameters written as literals stay
    concrete under jit, enabling static sampler specialization.)"""
    fv = _trace_time_scalar(v)
    if fv is not None and fv.is_integer() and 1.0 <= fv <= limit:
        return int(fv)
    return None


def _static_half_int_double(v, limit: float) -> int | None:
    """If `v` is trace-time concrete with 2v a positive integer <= limit,
    return 2v as int; else None."""
    fv = _trace_time_scalar(v)
    if fv is None:
        return None
    dv = 2.0 * fv
    if dv.is_integer() and 1.0 <= dv <= limit:
        return int(dv)
    return None


def _fast_gamma_unit(key, concentration):
    """Rejection-free Gamma(concentration, rate=1) draw for trace-time
    half-integer shapes: Gamma(n) = -log(prod of n uniforms) and
    Gamma(1/2) = Z^2 / 2. Returns None when no specialization applies.

    Rejection samplers are worst-lane bound when vectorized (all lanes
    rerun until the slowest accepts); these closed forms are single fused
    PRNG passes."""
    double = _static_half_int_double(concentration, 17)
    if double is None:
        return None
    n, has_half = divmod(double, 2)
    total = jnp.zeros(())
    k_exp, k_norm = jax.random.split(key)
    if n > 0:
        u = jax.random.uniform(
            k_exp, (n,), minval=jnp.finfo(jnp.float32).tiny, maxval=1.0
        )
        total = -jnp.sum(jnp.log(u))
    if has_half:
        z = jax.random.normal(k_norm)
        total = total + 0.5 * z * z
    return total


def _beta_sample(key, concentration1, concentration0):
    # Order-statistic fast path: for integer (a, b), Beta(a, b) is the
    # a-th smallest of a+b-1 uniforms — rejection-free.
    a = _static_small_int(concentration1, 8)
    b = _static_small_int(concentration0, 8)
    if a is not None and b is not None and a + b <= 9:
        n = a + b - 1
        if n == 1:
            return jax.random.uniform(key)
        u = jax.random.uniform(key, (n,))
        return jnp.sort(u)[a - 1]
    # Half-integer fast path via two rejection-free gammas.
    k1, k2 = jax.random.split(key)
    g1 = _fast_gamma_unit(k1, concentration1)
    g2 = _fast_gamma_unit(k2, concentration0)
    if g1 is not None and g2 is not None:
        return g1 / (g1 + g2)
    return jax.random.beta(key, concentration1, concentration0)


def _beta_logpdf(v, concentration1, concentration0):
    # Closed [0, 1]: xlogy/xlog1py already give the correct boundary
    # limits (-inf/+inf by concentration); the guard handles outside.
    return _guard_support(
        (v >= 0.0) & (v <= 1.0),
        v,
        0.5,
        lambda vs: xlogy(concentration1 - 1.0, vs)
        + xlog1py(concentration0 - 1.0, -vs)
        - betaln(concentration1, concentration0),
    )


beta = native_distribution(_beta_sample, _beta_logpdf, "beta")


def _cauchy_sample(key, loc=0.0, scale=1.0):
    shape = jnp.shape(jnp.zeros(()) + loc + scale)
    return loc + scale * jax.random.cauchy(key, shape=shape)


def _cauchy_logpdf(v, loc=0.0, scale=1.0):
    z = (v - loc) / scale
    return -jnp.log(jnp.pi) - jnp.log(scale) - jnp.log1p(z * z)


cauchy = native_distribution(_cauchy_sample, _cauchy_logpdf, "cauchy")


def _half_cauchy_sample(key, loc, scale):
    shape = jnp.shape(jnp.zeros(()) + loc + scale)
    return loc + scale * jnp.abs(jax.random.cauchy(key, shape=shape))


def _half_cauchy_logpdf(v, loc, scale):
    z = (v - loc) / scale
    lp = jnp.log(2.0) - jnp.log(jnp.pi) - jnp.log(scale) - jnp.log1p(z * z)
    return jnp.where(v >= loc, lp, -jnp.inf)


half_cauchy = native_distribution(_half_cauchy_sample, _half_cauchy_logpdf, "half_cauchy")


def _exp_half_cauchy_sample(key, scale):
    shape = jnp.shape(scale * 1.0)
    return jnp.log(scale) + jnp.log(
        jnp.abs(jax.random.cauchy(key, shape=shape))
    )


def _exp_half_cauchy_logpdf(v, scale):
    # X = log(HalfCauchy(0, scale)): the unconstrained parameterization
    # for hierarchical scale priors (gradient samplers never hit the
    # tau >= 0 boundary). p(x) = HC(e^x; scale) * e^x; both tails decay
    # exponentially in x (left like e^x, right like e^-x).
    z = v - jnp.log(scale)
    # log(2/pi) + z - log1p(e^{2z}), with log1p(e^t) = softplus(t).
    return jnp.log(2.0) - jnp.log(jnp.pi) + z - jax.nn.softplus(2.0 * z)


exp_half_cauchy = native_distribution(
    _exp_half_cauchy_sample, _exp_half_cauchy_logpdf, "exp_half_cauchy"
)


def _half_normal_sample(key, scale):
    return scale * jnp.abs(jax.random.normal(key, shape=jnp.shape(scale * 1.0)))


def _half_normal_logpdf(v, scale):
    z = v / scale
    lp = jnp.log(2.0) - 0.5 * z * z - jnp.log(scale) - _HALF_LOG_2PI
    return jnp.where(v >= 0, lp, -jnp.inf)


half_normal = native_distribution(_half_normal_sample, _half_normal_logpdf, "half_normal")


def _student_t_sample(key, df, loc, scale):
    shape = jnp.shape(jnp.zeros(()) + df + loc + scale)
    df_c = _trace_time_scalar(df)
    if df_c is not None and shape == ():
        k1, k2 = jax.random.split(key)
        g = _fast_gamma_unit(k1, df_c / 2.0)
        if g is not None:
            z = jax.random.normal(k2)
            return loc + scale * z / jnp.sqrt(2.0 * g / df)
    return loc + scale * jax.random.t(key, df, shape=shape)


def _student_t_logpdf(v, df, loc, scale):
    z = (v - loc) / scale
    return (
        gammaln((df + 1.0) / 2.0)
        - gammaln(df / 2.0)
        - 0.5 * jnp.log(df * jnp.pi)
        - jnp.log(scale)
        - ((df + 1.0) / 2.0) * jnp.log1p(z * z / df)
    )


student_t = native_distribution(_student_t_sample, _student_t_logpdf, "student_t")


def _half_student_t_sample(key, df, loc, scale):
    shape = jnp.shape(jnp.zeros(()) + df + loc + scale)
    return loc + scale * jnp.abs(jax.random.t(key, df, shape=shape))


def _half_student_t_logpdf(v, df, loc, scale):
    lp = jnp.log(2.0) + _student_t_logpdf(v, df, loc, scale)
    return jnp.where(v >= loc, lp, -jnp.inf)


half_student_t = native_distribution(
    _half_student_t_sample, _half_student_t_logpdf, "half_student_t"
)


def _exponential_sample(key, rate):
    return jax.random.exponential(key, shape=jnp.shape(rate * 1.0)) / rate


def _exponential_logpdf(v, rate):
    return jnp.where(v >= 0, jnp.log(rate) - rate * v, -jnp.inf)


exponential = native_distribution(_exponential_sample, _exponential_logpdf, "exponential")


def _gamma_sample(key, concentration, rate):
    if jnp.shape(rate) == ():
        g = _fast_gamma_unit(key, concentration)
        if g is not None:
            return g / rate
    return jax.random.gamma(key, concentration, shape=jnp.shape(concentration * rate * 1.0)) / rate


def _gamma_logpdf(v, concentration, rate):
    # v = 0 stays in the formula (xlogy gives the correct boundary limit
    # for every concentration); v < 0 is -inf — without the guard,
    # concentration == 1 scored a wrong FINITE density at negative v.
    return _guard_support(
        v >= 0.0,
        v,
        1.0,
        lambda vs: xlogy(concentration, rate)
        + xlogy(concentration - 1.0, vs)
        - rate * vs
        - gammaln(concentration),
    )


gamma = native_distribution(_gamma_sample, _gamma_logpdf, "gamma")


def _inverse_gamma_sample(key, concentration, scale):
    g = jax.random.gamma(key, concentration, shape=jnp.shape(concentration * scale * 1.0))
    return scale / g


def _inverse_gamma_logpdf(v, concentration, scale):
    return _guard_support(
        v > 0.0,
        v,
        1.0,
        lambda vs: xlogy(concentration, scale)
        - (concentration + 1.0) * jnp.log(vs)
        - scale / vs
        - gammaln(concentration),
    )


inverse_gamma = native_distribution(
    _inverse_gamma_sample, _inverse_gamma_logpdf, "inverse_gamma"
)


def _exp_gamma_sample(key, concentration, rate=1.0):
    return jax.random.loggamma(key, concentration, shape=jnp.shape(concentration * rate * 1.0)) - jnp.log(rate)


def _exp_gamma_logpdf(v, concentration, rate=1.0):
    # X = log(Gamma(concentration, rate)).
    return (
        xlogy(concentration, rate)
        + concentration * v
        - rate * jnp.exp(v)
        - gammaln(concentration)
    )


exp_gamma = native_distribution(_exp_gamma_sample, _exp_gamma_logpdf, "exp_gamma")


def _exp_inverse_gamma_sample(key, concentration, scale=1.0):
    return -(jax.random.loggamma(key, concentration, shape=jnp.shape(concentration * scale * 1.0)) - jnp.log(scale))


def _exp_inverse_gamma_logpdf(v, concentration, scale=1.0):
    # X = log(InverseGamma(concentration, scale)) = -log(Gamma(conc, scale)).
    return (
        xlogy(concentration, scale)
        - concentration * v
        - scale * jnp.exp(-v)
        - gammaln(concentration)
    )


exp_inverse_gamma = native_distribution(
    _exp_inverse_gamma_sample, _exp_inverse_gamma_logpdf, "exp_inverse_gamma"
)


def _chi2_sample(key, df):
    df_c = _trace_time_scalar(df)
    if df_c is not None:
        g = _fast_gamma_unit(key, df_c / 2.0)
        if g is not None:
            return 2.0 * g
    return jax.random.chisquare(key, df, shape=jnp.shape(df * 1.0))


def _chi2_logpdf(v, df):
    return _gamma_logpdf(v, df / 2.0, 0.5)


chi2 = native_distribution(_chi2_sample, _chi2_logpdf, "chi2")


def _chi_sample(key, df):
    return jnp.sqrt(jax.random.chisquare(key, df, shape=jnp.shape(df * 1.0)))


def _chi_logpdf(v, df):
    return _guard_support(
        v >= 0.0,
        v,
        1.0,
        lambda vs: xlogy(df - 1.0, vs)
        - vs * vs / 2.0
        - (df / 2.0 - 1.0) * jnp.log(2.0)
        - gammaln(df / 2.0),
    )


chi = native_distribution(_chi_sample, _chi_logpdf, "chi")


def _laplace_sample(key, loc, scale):
    shape = jnp.shape(jnp.zeros(()) + loc + scale)
    return loc + scale * jax.random.laplace(key, shape=shape)


def _laplace_logpdf(v, loc, scale):
    return -jnp.abs(v - loc) / scale - jnp.log(2.0 * scale)


laplace = native_distribution(_laplace_sample, _laplace_logpdf, "laplace")


def _gumbel_sample(key, loc, scale):
    shape = jnp.shape(jnp.zeros(()) + loc + scale)
    return loc + scale * jax.random.gumbel(key, shape=shape)


def _gumbel_logpdf(v, loc, scale):
    z = (v - loc) / scale
    return -z - jnp.exp(-z) - jnp.log(scale)


gumbel = native_distribution(_gumbel_sample, _gumbel_logpdf, "gumbel")


def _log_normal_sample(key, loc, scale):
    shape = jnp.shape(jnp.zeros(()) + loc + scale)
    return jnp.exp(loc + scale * jax.random.normal(key, shape=shape))


def _log_normal_logpdf(v, loc, scale):
    return _guard_support(
        v > 0.0,
        v,
        1.0,
        lambda vs: _normal_logpdf(jnp.log(vs), loc, scale) - jnp.log(vs),
    )


log_normal = native_distribution(_log_normal_sample, _log_normal_logpdf, "log_normal")


def _logit_normal_sample(key, loc, scale):
    shape = jnp.shape(jnp.zeros(()) + loc + scale)
    return jax.nn.sigmoid(loc + scale * jax.random.normal(key, shape=shape))


def _logit_normal_logpdf(v, loc, scale):
    return _guard_support(
        (v > 0.0) & (v < 1.0),
        v,
        0.5,
        lambda vs: _normal_logpdf(logit(vs), loc, scale)
        - jnp.log(vs)
        - jnp.log1p(-vs),
    )


logit_normal = native_distribution(
    _logit_normal_sample, _logit_normal_logpdf, "logit_normal"
)


def _truncated_normal_sample(key, loc, scale, low, high):
    a = (low - loc) / scale
    b = (high - loc) / scale
    shape = jnp.shape(jnp.zeros(()) + loc + scale + low + high)
    return loc + scale * jax.random.truncated_normal(key, a, b, shape=shape)


def _truncated_normal_logpdf(v, loc, scale, low, high):
    a = (low - loc) / scale
    b = (high - loc) / scale
    z = (v - loc) / scale
    log_z_norm = jnp.log(ndtr(b) - ndtr(a))
    lp = -0.5 * z * z - _HALF_LOG_2PI - jnp.log(scale) - log_z_norm
    return jnp.where((v >= low) & (v <= high), lp, -jnp.inf)


truncated_normal = native_distribution(
    _truncated_normal_sample, _truncated_normal_logpdf, "truncated_normal"
)


def _cauchy_cdf(z):
    return jnp.arctan(z) / jnp.pi + 0.5


def _truncated_cauchy_sample(key, loc, scale, low, high):
    a = _cauchy_cdf((low - loc) / scale)
    b = _cauchy_cdf((high - loc) / scale)
    shape = jnp.shape(jnp.zeros(()) + loc + scale + low + high)
    u = jax.random.uniform(key, shape=shape, minval=a, maxval=b)
    return loc + scale * jnp.tan(jnp.pi * (u - 0.5))


def _truncated_cauchy_logpdf(v, loc, scale, low, high):
    a = _cauchy_cdf((low - loc) / scale)
    b = _cauchy_cdf((high - loc) / scale)
    lp = _cauchy_logpdf(v, loc, scale) - jnp.log(b - a)
    return jnp.where((v >= low) & (v <= high), lp, -jnp.inf)


truncated_cauchy = native_distribution(
    _truncated_cauchy_sample, _truncated_cauchy_logpdf, "truncated_cauchy"
)


def _weibull_sample(key, concentration, scale):
    shape = jnp.shape(jnp.zeros(()) + concentration + scale)
    return jax.random.weibull_min(key, scale, concentration, shape=shape)


def _weibull_logpdf(v, concentration, scale):
    # Without the guard, concentration == 1 scored a wrong FINITE
    # density at negative v (the xlogy term vanishes there).
    def lp(vs):
        z = vs / scale
        return (
            jnp.log(concentration)
            - jnp.log(scale)
            + xlogy(concentration - 1.0, z)
            - z**concentration
        )

    return _guard_support(v >= 0.0, v, 1.0, lp)


weibull = native_distribution(_weibull_sample, _weibull_logpdf, "weibull")


def _kumaraswamy_sample(key, concentration1, concentration0):
    shape = jnp.shape(jnp.zeros(()) + concentration1 + concentration0)
    u = jax.random.uniform(key, shape=shape, minval=1e-7, maxval=1.0 - 1e-7)
    return (1.0 - u ** (1.0 / concentration0)) ** (1.0 / concentration1)


def _kumaraswamy_logpdf(v, concentration1, concentration0):
    a, b = concentration1, concentration0
    return _guard_support(
        (v >= 0.0) & (v <= 1.0),
        v,
        0.5,
        lambda vs: jnp.log(a)
        + jnp.log(b)
        + xlogy(a - 1.0, vs)
        + xlog1py(b - 1.0, -(vs**a)),
    )


kumaraswamy = native_distribution(_kumaraswamy_sample, _kumaraswamy_logpdf, "kumaraswamy")


def _double_sided_maxwell_sample(key, loc, scale):
    shape = jnp.shape(jnp.zeros(()) + loc + scale)
    return jax.random.double_sided_maxwell(key, loc, scale, shape=shape)


def _double_sided_maxwell_logpdf(v, loc, scale):
    z = (v - loc) / scale
    return 2.0 * jnp.log(jnp.abs(z)) - 0.5 * z * z - _HALF_LOG_2PI - jnp.log(scale)


double_sided_maxwell = native_distribution(
    _double_sided_maxwell_sample, _double_sided_maxwell_logpdf, "double_sided_maxwell"
)


def _moyal_sample(key, loc, scale):
    shape = jnp.shape(jnp.zeros(()) + loc + scale)
    u = jax.random.uniform(key, shape=shape, minval=1e-7, maxval=1.0 - 1e-7)
    # CDF: F(z) = erfc(exp(-z/2) / sqrt(2)); invert via erfinv.
    z = -2.0 * jnp.log(jnp.sqrt(2.0) * erfinv(1.0 - u))
    return loc + scale * z


def _moyal_logpdf(v, loc, scale):
    z = (v - loc) / scale
    return -0.5 * (z + jnp.exp(-z)) - _HALF_LOG_2PI - jnp.log(scale)


moyal = native_distribution(_moyal_sample, _moyal_logpdf, "moyal")


def _inverse_gaussian_sample(key, loc, concentration):
    # jax.random.wald(mean) samples InverseGaussian(mean, lambda=1);
    # X = lam * Wald(mu/lam) ~ IG(mu, lam).
    shape = jnp.shape(jnp.zeros(()) + loc + concentration)
    return concentration * jax.random.wald(key, loc / concentration, shape=shape)


def _inverse_gaussian_logpdf(v, loc, concentration):
    lam, mu = concentration, loc
    return _guard_support(
        v > 0.0,
        v,
        1.0,
        lambda vs: 0.5
        * (jnp.log(lam) - jnp.log(2.0 * jnp.pi) - 3.0 * jnp.log(vs))
        - lam * (vs - mu) ** 2 / (2.0 * mu * mu * vs),
    )


inverse_gaussian = native_distribution(
    _inverse_gaussian_sample, _inverse_gaussian_logpdf, "inverse_gaussian"
)


def _lambert_w_normal_sample(key, loc, scale, tailweight):
    # Heavy-tail Lambert W x Normal: Y = loc + scale * Z exp(d Z^2 / 2).
    shape = jnp.shape(jnp.zeros(()) + loc + scale + tailweight)
    z = jax.random.normal(key, shape=shape)
    return loc + scale * z * jnp.exp(tailweight * z * z / 2.0)


def _lambert_w_normal_logpdf(v, loc, scale, tailweight):
    d = tailweight
    u = (v - loc) / scale
    # Invert u = z exp(d z^2/2): z = sign(u) sqrt(W(d u^2)/d).
    du2 = d * u * u
    w = lambertw(du2)
    z2 = jnp.where(d > 0, w / jnp.maximum(d, 1e-30), u * u)
    z = jnp.sign(u) * jnp.sqrt(jnp.maximum(z2, 0.0))
    # dz/du = z / (u (1 + W(d u^2)))  [standard Lambert W derivative algebra]
    log_dz_du = jnp.where(
        jnp.abs(u) > 1e-30,
        jnp.log(jnp.abs(z)) - jnp.log(jnp.abs(u)) - jnp.log1p(w),
        0.0,
    )
    return _normal_logpdf(z, 0.0, 1.0) + log_dz_du - jnp.log(scale)


lambert_w_normal = native_distribution(
    _lambert_w_normal_sample, _lambert_w_normal_logpdf, "lambert_w_normal"
)


def _von_mises_sample(key, loc, concentration):
    # Best-Fisher (1979) rejection sampling, batched via lax.while_loop.
    kappa = jnp.asarray(concentration, dtype=jnp.result_type(float))
    shape = jnp.shape(jnp.zeros(()) + loc + kappa)
    kappa = jnp.broadcast_to(kappa, shape)

    tau = 1.0 + jnp.sqrt(1.0 + 4.0 * kappa * kappa)
    rho = (tau - jnp.sqrt(2.0 * tau)) / (2.0 * jnp.maximum(kappa, 1e-10))
    r = (1.0 + rho * rho) / (2.0 * rho)

    def cond(state):
        _, _, accepted, count = state
        return jnp.logical_and(~jnp.all(accepted), count < 100)

    def body(state):
        key, w, accepted, count = state
        key, k1, k2, k3 = jax.random.split(key, 4)
        u1 = jax.random.uniform(k1, shape)
        u2 = jax.random.uniform(k2, shape)
        z = jnp.cos(jnp.pi * u1)
        f = (1.0 + r * z) / (r + z)
        c = kappa * (r - f)
        accept_new = jnp.logical_or(c * (2.0 - c) - u2 > 0, jnp.log(c / jnp.maximum(u2, 1e-30)) + 1.0 - c >= 0)
        w = jnp.where(jnp.logical_and(~accepted, accept_new), f, w)
        accepted = jnp.logical_or(accepted, accept_new)
        return (key, w, accepted, count + 1)

    key, k_sign = jax.random.split(key)
    init = (key, jnp.zeros(shape), jnp.zeros(shape, dtype=bool), 0)
    _, w, _, _ = jax.lax.while_loop(cond, body, init)
    sign = jnp.where(jax.random.uniform(k_sign, shape) < 0.5, -1.0, 1.0)
    theta = sign * jnp.arccos(jnp.clip(w, -1.0, 1.0))
    # Small-kappa limit: uniform on circle.
    key_unif = jax.random.fold_in(k_sign, 7)
    unif = jax.random.uniform(key_unif, shape, minval=-jnp.pi, maxval=jnp.pi)
    theta = jnp.where(kappa < 1e-5, unif, theta)
    out = loc + theta
    # Wrap to [-pi + loc_mod ... ]: von Mises support is any 2pi interval.
    return jnp.mod(out + jnp.pi, 2.0 * jnp.pi) - jnp.pi


def _von_mises_logpdf(v, loc, concentration):
    return (
        concentration * jnp.cos(v - loc)
        - jnp.log(2.0 * jnp.pi)
        - log_bessel_i0(concentration)
    )


von_mises = native_distribution(_von_mises_sample, _von_mises_logpdf, "von_mises")


def _vmf_log_norm(kappa, dim):
    """log C_d(kappa) for the von Mises-Fisher density on S^{d-1}."""
    nu = dim / 2.0 - 1.0
    return (
        nu * jnp.log(jnp.maximum(kappa, 1e-30))
        - (dim / 2.0) * jnp.log(2.0 * jnp.pi)
        - log_bessel_iv(nu, kappa)
    )


def _householder_rotate(e1_vec, mu):
    """Apply the Householder reflection taking e1 to mu (unit vectors)."""
    d = mu.shape[-1]
    e1 = jnp.zeros((d,)).at[0].set(1.0)
    u = e1 - mu
    norm = jnp.linalg.norm(u)
    u = jnp.where(norm > 1e-12, u / jnp.maximum(norm, 1e-12), u)
    return e1_vec - 2.0 * jnp.dot(u, e1_vec) * u


def _von_mises_fisher_sample(key, mean_direction, concentration):
    # Wood (1994) rejection sampling for the transverse component.
    mu = mean_direction
    d = mu.shape[-1]
    kappa = concentration

    b = (-2.0 * kappa + jnp.sqrt(4.0 * kappa * kappa + (d - 1.0) ** 2)) / (d - 1.0)
    x0 = (1.0 - b) / (1.0 + b)
    c = kappa * x0 + (d - 1.0) * jnp.log1p(-x0 * x0)

    def cond(state):
        _, _, accepted, count = state
        return jnp.logical_and(~accepted, count < 100)

    def body(state):
        key, w, accepted, count = state
        key, k1, k2 = jax.random.split(key, 3)
        z = jax.random.beta(k1, (d - 1.0) / 2.0, (d - 1.0) / 2.0)
        u = jax.random.uniform(k2)
        w_new = (1.0 - (1.0 + b) * z) / (1.0 - (1.0 - b) * z)
        accept_new = kappa * w_new + (d - 1.0) * jnp.log1p(-x0 * w_new) - c >= jnp.log(u)
        w = jnp.where(jnp.logical_and(~accepted, accept_new), w_new, w)
        accepted = jnp.logical_or(accepted, accept_new)
        return (key, w, accepted, count + 1)

    key, k_dir = jax.random.split(key)
    init = (key, jnp.zeros(()), jnp.zeros((), dtype=bool), 0)
    _, w, _, _ = jax.lax.while_loop(cond, body, init)

    v = jax.random.normal(k_dir, (d - 1,))
    v = v / jnp.maximum(jnp.linalg.norm(v), 1e-12)
    x_e1 = jnp.concatenate([w[None], jnp.sqrt(jnp.maximum(1.0 - w * w, 0.0)) * v])
    return _householder_rotate(x_e1, mu)


def _von_mises_fisher_logpdf(v, mean_direction, concentration):
    d = mean_direction.shape[-1]
    return concentration * jnp.sum(v * mean_direction, axis=-1) + _vmf_log_norm(
        concentration, d
    )


von_mises_fisher = native_distribution(
    _von_mises_fisher_sample, _von_mises_fisher_logpdf, "von_mises_fisher"
)


def _power_spherical_sample(key, mean_direction, concentration):
    # De Cao & Aziz (2020): exact sampling without rejection.
    mu = mean_direction
    d = mu.shape[-1]
    kappa = concentration
    alpha = (d - 1.0) / 2.0 + kappa
    bet = (d - 1.0) / 2.0

    k1, k2 = jax.random.split(key)
    z = jax.random.beta(k1, alpha, bet)
    t = 2.0 * z - 1.0
    v = jax.random.normal(k2, (d - 1,))
    v = v / jnp.maximum(jnp.linalg.norm(v), 1e-12)
    y = jnp.concatenate([t[None], jnp.sqrt(jnp.maximum(1.0 - t * t, 0.0)) * v])
    return _householder_rotate(y, mu)


def _power_spherical_logpdf(v, mean_direction, concentration):
    d = mean_direction.shape[-1]
    kappa = concentration
    alpha = (d - 1.0) / 2.0 + kappa
    bet = (d - 1.0) / 2.0
    # N = 2^(a+b) * pi^b * Gamma(a) / Gamma(a+b)   (De Cao & Aziz 2020)
    log_norm = -(
        (alpha + bet) * jnp.log(2.0)
        + bet * jnp.log(jnp.pi)
        + gammaln(alpha)
        - gammaln(alpha + bet)
    )
    return log_norm + kappa * jnp.log1p(jnp.sum(v * mean_direction, axis=-1))


power_spherical = native_distribution(
    _power_spherical_sample, _power_spherical_logpdf, "power_spherical"
)


# =====================================================================
# Multivariate continuous
# =====================================================================


def _mv_normal_diag_sample(key, loc, scale_diag):
    return loc + scale_diag * jax.random.normal(key, shape=jnp.shape(loc))


def _mv_normal_diag_logpdf(v, loc, scale_diag):
    return jnp.sum(_normal_logpdf(v, loc, scale_diag), axis=-1)


mv_normal_diag = native_distribution(
    _mv_normal_diag_sample, _mv_normal_diag_logpdf, "mv_normal_diag"
)


def _mv_normal_sample(key, loc, covariance_matrix):
    return jax.random.multivariate_normal(key, loc, covariance_matrix)


def _mv_normal_logpdf(v, loc, covariance_matrix):
    d = loc.shape[-1]
    chol = jnp.linalg.cholesky(covariance_matrix)
    diff = v - loc
    y = jax.scipy.linalg.solve_triangular(chol, diff, lower=True)
    return (
        -0.5 * jnp.sum(y * y, axis=-1)
        - jnp.sum(jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)), axis=-1)
        - 0.5 * d * jnp.log(2.0 * jnp.pi)
    )


mv_normal = native_distribution(_mv_normal_sample, _mv_normal_logpdf, "mv_normal")


def _dirichlet_sample(key, concentration):
    # Concrete half-integer concentration vectors (the common literal
    # hyperparameter case): normalized rejection-free gammas — ~12x
    # faster than the generic per-component gamma rejection at 1M draws.
    from genjax_tpu.core.typing import static_check_is_concrete

    if static_check_is_concrete(concentration) and jnp.ndim(concentration) == 1:
        import numpy as np

        vals = np.asarray(concentration, dtype=np.float64)
        doubles = 2.0 * vals
        if bool(
            np.all(doubles == np.round(doubles))
            and np.all((doubles >= 1.0) & (doubles <= 17.0))
        ):
            # Two PRNG calls total: one uniform block for all integer
            # parts, one normal block for all half parts (PRNG dispatch
            # count, not rejection, dominates small-component draws).
            parts = [divmod(int(d), 2) for d in doubles]
            n_exp = sum(n for n, _ in parts)
            n_half = sum(h for _, h in parts)
            k_u, k_z = jax.random.split(key)
            e = jnp.zeros((0,))
            if n_exp:
                u = jax.random.uniform(
                    k_u, (n_exp,), minval=jnp.finfo(jnp.float32).tiny, maxval=1.0
                )
                e = -jnp.log(u)
            z2 = jnp.zeros((0,))
            if n_half:
                z = jax.random.normal(k_z, (n_half,))
                z2 = 0.5 * z * z
            gs = []
            off_e = off_h = 0
            for n, h in parts:
                g_val = jnp.zeros(())
                if n:
                    g_val = jnp.sum(
                        jax.lax.dynamic_slice_in_dim(e, off_e, n)
                    )
                    off_e += n
                if h:
                    g_val = g_val + z2[off_h]
                    off_h += 1
                gs.append(g_val)
            gs = jnp.stack(gs)
            return gs / jnp.sum(gs)
    return jax.random.dirichlet(key, concentration)


def _dirichlet_logpdf(v, concentration):
    # Componentwise [0, 1] guard (the NaN source under cross-branch
    # transplants); the simplex-sum invariant itself is not checked
    # (float-brittle — same stance as TFP's unchecked densities).
    in_support = jnp.all((v >= 0.0) & (v <= 1.0), axis=-1)
    vs = jnp.where(in_support[..., None], v, 0.5)
    lp = (
        jnp.sum(xlogy(concentration - 1.0, vs), axis=-1)
        + gammaln(jnp.sum(concentration, axis=-1))
        - jnp.sum(gammaln(concentration), axis=-1)
    )
    return jnp.where(in_support, lp, -jnp.inf)


dirichlet = native_distribution(_dirichlet_sample, _dirichlet_logpdf, "dirichlet")


# =====================================================================
# Discrete families
# =====================================================================


def _bern_sample(key, logits=None, probs=None):
    p = jax.nn.sigmoid(logits) if probs is None else probs
    draw = jax.random.bernoulli(key, p, shape=jnp.shape(p * 1.0))
    return draw.astype(jnp.int32)


def _bern_logpdf(v, logits=None, probs=None):
    vf = jnp.asarray(v, dtype=jnp.result_type(float))
    if probs is None:
        log_p, log_1mp = _logits_to_log_probs_bernoulli(logits)
    else:
        log_p, log_1mp = jnp.log(probs), jnp.log1p(-probs)
    # Support {0, 1}: a fractional/out-of-range transplant scored a wrong
    # finite "interpolated" density without the guard.
    return jnp.where(
        (vf == 0.0) | (vf == 1.0),
        vf * log_p + (1.0 - vf) * log_1mp,
        -jnp.inf,
    )


# bernoulli / categorical apply the implicit-logit interpretation to bare
# positional arguments (with a deprecation warning), matching the reference.
def _bernoulli_sample(key, *args, **kwargs):
    if args:
        warnings.warn(
            "Bare argument to genjax_tpu.bernoulli is interpreted as logits; "
            "prefer logits=/probs=.",
            DeprecationWarning,
        )
        kwargs = {"logits": args[0], **kwargs}
    return _bern_sample(key, **kwargs)


def _bernoulli_logpdf(v, *args, **kwargs):
    if args:
        kwargs = {"logits": args[0], **kwargs}
    return _bern_logpdf(v, **kwargs)


bernoulli = native_distribution(_bernoulli_sample, _bernoulli_logpdf, "bernoulli")


def _flip_sample(key, p):
    return jax.random.bernoulli(key, p, shape=jnp.shape(p * 1.0))


def _flip_logpdf(v, p):
    vf = jnp.asarray(v, dtype=jnp.result_type(float))
    return jnp.where(
        (vf == 0.0) | (vf == 1.0),
        xlogy(vf, p) + xlog1py(1.0 - vf, -p),
        -jnp.inf,
    )


flip = native_distribution(_flip_sample, _flip_logpdf, "flip")


def _categorical_sample(key, *args, **kwargs):
    if args:
        warnings.warn(
            "Bare argument to genjax_tpu.categorical is interpreted as "
            "logits; prefer logits=/probs=.",
            DeprecationWarning,
        )
        kwargs = {"logits": args[0], **kwargs}
    logits = kwargs.get("logits")
    probs = kwargs.get("probs")
    if logits is None:
        logits = jnp.log(probs)
    return jax.random.categorical(key, logits)


def _categorical_logpdf(v, *args, **kwargs):
    if args:
        kwargs = {"logits": args[0], **kwargs}
    logits = kwargs.get("logits")
    probs = kwargs.get("probs")
    if logits is None:
        logits = jnp.log(probs)
    log_probs = log_softmax(logits, axis=-1)
    v = jnp.asarray(v, dtype=jnp.int32)
    # Index-bounds guard: without it a negative index WRAPS (scoring the
    # last category's probability) and an overlarge one clamps — both
    # silently wrong under cross-branch transplants.
    n_cat = jnp.shape(log_probs)[-1]
    in_support = (v >= 0) & (v < n_cat)
    vs = jnp.where(in_support, v, 0)
    if jnp.ndim(log_probs) == 1:
        # One shared logits row scored at scalar or batched draws (e.g.
        # `sample_shape=` iid indices): a plain gather broadcasts.
        return jnp.where(in_support, log_probs[vs], -jnp.inf)
    gathered = jnp.take_along_axis(log_probs, vs[..., None], axis=-1)[..., 0]
    return jnp.where(in_support, gathered, -jnp.inf)


categorical = native_distribution(_categorical_sample, _categorical_logpdf, "categorical")


def _binomial_sample(key, total_count, probs=None, logits=None):
    p = jax.nn.sigmoid(logits) if probs is None else probs
    # Small integer counts: sum of n Bernoullis (one fused uniform pass)
    # instead of the general rejection sampler.
    n = _static_small_int(total_count, 16)
    if n is not None and jnp.shape(p) == ():
        u = jax.random.uniform(key, (n,))
        return jnp.sum((u < p).astype(jnp.float32))
    return jax.random.binomial(key, total_count, p)


def _binomial_logpdf(v, total_count, probs=None, logits=None):
    n = total_count
    if probs is None:
        log_p, log_1mp = _logits_to_log_probs_bernoulli(logits)
    else:
        log_p, log_1mp = jnp.log(probs), jnp.log1p(-probs)
    vf = jnp.asarray(v, dtype=jnp.result_type(float))
    in_support = (vf >= 0.0) & (vf <= n)
    vs = jnp.where(in_support, vf, 0.0)  # gammaln poles off-support
    return jnp.where(
        in_support, log_binom(n, vs) + vs * log_p + (n - vs) * log_1mp, -jnp.inf
    )


binomial = native_distribution(_binomial_sample, _binomial_logpdf, "binomial")


def _beta_binomial_sample(key, total_count, concentration1, concentration0):
    k1, k2 = jax.random.split(key)
    p = _beta_sample(k1, concentration1, concentration0)
    return _binomial_sample(k2, total_count, probs=p)


def _beta_binomial_logpdf(v, total_count, concentration1, concentration0):
    n, a, b = total_count, concentration1, concentration0
    vf = jnp.asarray(v, dtype=jnp.result_type(float))
    in_support = (vf >= 0.0) & (vf <= n)
    vs = jnp.where(in_support, vf, 0.0)
    return jnp.where(
        in_support,
        log_binom(n, vs) + betaln(vs + a, n - vs + b) - betaln(a, b),
        -jnp.inf,
    )


beta_binomial = native_distribution(
    _beta_binomial_sample, _beta_binomial_logpdf, "beta_binomial"
)


def _beta_quotient_sample(
    key,
    concentration1_numerator,
    concentration0_numerator,
    concentration1_denominator,
    concentration0_denominator,
):
    k1, k2 = jax.random.split(key)
    x = jax.random.beta(k1, concentration1_numerator, concentration0_numerator)
    y = jax.random.beta(k2, concentration1_denominator, concentration0_denominator)
    return x / y


def _beta_quotient_logpdf(v, a1, b1, a2, b2):
    """Density of X/Y for X~Beta(a1,b1), Y~Beta(a2,b2), via Gauss 2F1
    (closed form; see e.g. Pham-Gia 2000)."""
    from jax.scipy.special import hyp2f1

    in_support = v > 0.0
    v = jnp.where(in_support, v, 1.0)  # safe value; guarded below
    log_norm = betaln(a1 + a2, b1) - betaln(a1, b1) - betaln(a2, b2)
    # Branch z <= 1.
    z_lo = jnp.clip(v, 1e-30, 1.0)
    lp_lo = (
        log_norm
        + xlogy(a1 - 1.0, z_lo)
        + jnp.log(hyp2f1(a1 + a2, 1.0 - b1, a1 + a2 + b1, z_lo))
    )
    # Branch z > 1: use the reciprocal-argument form.
    z_hi = jnp.maximum(v, 1.0)
    lp_hi = (
        betaln(a1 + a2, b2)
        - betaln(a1, b1)
        - betaln(a2, b2)
        - (a2 + 1.0) * jnp.log(z_hi)
        + jnp.log(hyp2f1(a1 + a2, 1.0 - b2, a1 + a2 + b2, 1.0 / z_hi))
    )
    return jnp.where(in_support, jnp.where(v <= 1.0, lp_lo, lp_hi), -jnp.inf)


beta_quotient = native_distribution(
    _beta_quotient_sample, _beta_quotient_logpdf, "beta_quotient"
)


def _geometric_sample(key, logits=None, probs=None):
    p = jax.nn.sigmoid(logits) if probs is None else probs
    # Support {0, 1, ...}: number of failures before the first success.
    u = jax.random.uniform(key, shape=jnp.shape(p * 1.0), minval=1e-7, maxval=1.0)
    return jnp.floor(jnp.log(u) / jnp.log1p(-p)).astype(jnp.int32)


def _geometric_logpdf(v, logits=None, probs=None):
    p = jax.nn.sigmoid(logits) if probs is None else probs
    vf = jnp.asarray(v, dtype=jnp.result_type(float))
    # Support {0, 1, ...}: negative transplants scored a wrong finite
    # density without the guard.
    return jnp.where(vf >= 0.0, xlog1py(vf, -p) + jnp.log(p), -jnp.inf)


geometric = native_distribution(_geometric_sample, _geometric_logpdf, "geometric")


def _poisson_sample(key, rate):
    return jax.random.poisson(key, rate)


def _poisson_logpdf(v, rate):
    vf = jnp.asarray(v, dtype=jnp.result_type(float))
    # Negative integers already hit gammaln's pole (-inf); the explicit
    # guard also covers negative non-integers.
    return jnp.where(
        vf >= 0.0, xlogy(vf, rate) - rate - gammaln(vf + 1.0), -jnp.inf
    )


poisson = native_distribution(_poisson_sample, _poisson_logpdf, "poisson")


def _negative_binomial_sample(key, total_count, logits=None, probs=None):
    # Gamma-Poisson mixture: lam ~ Gamma(r, rate=(1-p)/p); X ~ Poisson(lam).
    p = jax.nn.sigmoid(logits) if probs is None else probs
    k1, k2 = jax.random.split(key)
    lam = _gamma_sample(k1, total_count, 1.0) * (p / (1.0 - p))
    return jax.random.poisson(k2, lam)


def _negative_binomial_logpdf(v, total_count, logits=None, probs=None):
    r = total_count
    vf = jnp.asarray(v, dtype=jnp.result_type(float))
    if probs is None:
        log_p, log_1mp = _logits_to_log_probs_bernoulli(logits)
    else:
        log_p, log_1mp = jnp.log(probs), jnp.log1p(-probs)
    return jnp.where(
        vf >= 0.0,
        gammaln(vf + r) - gammaln(r) - gammaln(vf + 1.0) + r * log_1mp
        + vf * log_p,
        -jnp.inf,
    )


negative_binomial = native_distribution(
    _negative_binomial_sample, _negative_binomial_logpdf, "negative_binomial"
)


def _multinomial_sample(key, total_count, probs=None, logits=None):
    p = jax.nn.softmax(logits, axis=-1) if probs is None else probs
    return jax.random.multinomial(key, total_count, p).astype(jnp.float32)


def _multinomial_logpdf(v, total_count, probs=None, logits=None):
    if probs is None:
        log_p = log_softmax(logits, axis=-1)
    else:
        log_p = jnp.log(probs)
    vf = jnp.asarray(v, dtype=jnp.result_type(float))
    # Counts must be nonnegative and sum to total_count; a transplanted
    # vector violating either scored a wrong finite density.
    in_support = jnp.all(vf >= 0.0, axis=-1) & (
        jnp.sum(vf, axis=-1) == total_count
    )
    vs = jnp.where(in_support[..., None], vf, 0.0)
    lp = (
        gammaln(total_count + 1.0)
        - jnp.sum(gammaln(vs + 1.0), axis=-1)
        + jnp.sum(vs * log_p, axis=-1)
    )
    return jnp.where(in_support, lp, -jnp.inf)


multinomial = native_distribution(_multinomial_sample, _multinomial_logpdf, "multinomial")


def _dirichlet_multinomial_sample(key, total_count, concentration):
    k1, k2 = jax.random.split(key)
    p = jax.random.dirichlet(k1, concentration)
    return jax.random.multinomial(k2, total_count, p).astype(jnp.float32)


def _dirichlet_multinomial_logpdf(v, total_count, concentration):
    a = concentration
    vf = jnp.asarray(v, dtype=jnp.result_type(float))
    a0 = jnp.sum(a, axis=-1)
    in_support = jnp.all(vf >= 0.0, axis=-1) & (
        jnp.sum(vf, axis=-1) == total_count
    )
    vs = jnp.where(in_support[..., None], vf, 0.0)
    lp = (
        gammaln(total_count + 1.0)
        - jnp.sum(gammaln(vs + 1.0), axis=-1)
        + gammaln(a0)
        - gammaln(total_count + a0)
        + jnp.sum(gammaln(vs + a) - gammaln(a), axis=-1)
    )
    return jnp.where(in_support, lp, -jnp.inf)


dirichlet_multinomial = native_distribution(
    _dirichlet_multinomial_sample, _dirichlet_multinomial_logpdf, "dirichlet_multinomial"
)


def _skellam_sample(key, rate1, rate2):
    k1, k2 = jax.random.split(key)
    return (
        jax.random.poisson(k1, rate1).astype(jnp.int32)
        - jax.random.poisson(k2, rate2).astype(jnp.int32)
    )


def _skellam_logpmf(v, rate1, rate2):
    vf = jnp.asarray(v, dtype=jnp.result_type(float))
    return (
        -(rate1 + rate2)
        + (vf / 2.0) * (jnp.log(rate1) - jnp.log(rate2))
        + log_bessel_iv(jnp.abs(vf), 2.0 * jnp.sqrt(rate1 * rate2), num_terms=60)
    )


skellam = native_distribution(_skellam_sample, _skellam_logpmf, "skellam")


def _zipf_sample(key, power):
    # Devroye's rejection-inversion sampler for the (shifted) Zipf
    # distribution over {1, 2, ...}.
    a = power

    def cond(state):
        _, _, accepted, count = state
        return jnp.logical_and(~accepted, count < 100)

    def body(state):
        key, x, accepted, count = state
        key, k1, k2 = jax.random.split(key, 3)
        u = jax.random.uniform(k1, minval=1e-12, maxval=1.0)
        v = jax.random.uniform(k2)
        x_new = jnp.floor(u ** (-1.0 / (a - 1.0)))
        t = (1.0 + 1.0 / x_new) ** (a - 1.0)
        ok = jnp.isfinite(x_new) & (v * x_new * (t - 1.0) / (2.0 ** (a - 1.0) - 1.0) <= t / (2.0 ** (a - 1.0)))
        x = jnp.where(jnp.logical_and(~accepted, ok), x_new, x)
        accepted = jnp.logical_or(accepted, ok)
        return (key, x, accepted, count + 1)

    init = (key, jnp.ones(()), jnp.zeros((), dtype=bool), 0)
    _, x, _, _ = jax.lax.while_loop(cond, body, init)
    return x.astype(jnp.int32)


def _zipf_logpmf(v, power):
    vf = jnp.asarray(v, dtype=jnp.result_type(float))
    lp = -power * jnp.log(vf) - jnp.log(zeta(power, 1.0))
    return jnp.where(vf >= 1.0, lp, -jnp.inf)


zipf = native_distribution(_zipf_sample, _zipf_logpmf, "zipf")


def _non_central_chi2_sample(key, df, noncentrality):
    # Poisson-mixture representation: J ~ Poisson(nc/2); X ~ ChiSq(df + 2J).
    k1, k2 = jax.random.split(key)
    j = jax.random.poisson(k1, noncentrality / 2.0)
    return jax.random.chisquare(k2, df + 2.0 * j)


def _non_central_chi2_logpdf(v, df, noncentrality):
    lam = noncentrality
    nu = df / 2.0 - 1.0
    return _guard_support(
        v > 0.0,
        v,
        1.0,
        lambda vs: -jnp.log(2.0)
        - (vs + lam) / 2.0
        + (nu / 2.0) * (jnp.log(vs) - jnp.log(lam))
        + log_bessel_iv(nu, jnp.sqrt(lam * vs), num_terms=60),
    )


non_central_chi2 = native_distribution(
    _non_central_chi2_sample, _non_central_chi2_logpdf, "non_central_chi2"
)
