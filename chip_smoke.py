"""Bring-up smoke test: the inference main path on NVIDIA GPUs.

    python chip_smoke.py            # one card: every one-card phase
    python chip_smoke.py --chips 4  # four cards: the sharded drivers only

Each phase drives a library entry point at the size `bench.py` uses,
checks what comes out against the phase's closed-form oracle or plain
reference, and prints one line: its compile seconds (set-up), its steady
seconds (timed around `jax.block_until_ready`), the device's
`peak_bytes_in_use` so far, and every check beside its tolerance. A
failed check or an exception ends the process with a nonzero code and no
result line. The last line of a passing run is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

There is no CPU fallback: without a GPU the script exits nonzero before
any phase. The phase functions take their sizes as arguments, so the
tests run each of them at a tiny size on the CPU.
"""

import argparse
import dataclasses
import json
import math
import pathlib
import statistics
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.special import logsumexp

ROOT = pathlib.Path(__file__).resolve().parent


@dataclasses.dataclass
class Check:
    """One comparison: `err` must not exceed `tol` (NaN fails)."""

    name: str
    err: float
    tol: float

    @property
    def ok(self) -> bool:
        return bool(self.err <= self.tol)


@dataclasses.dataclass
class PhaseResult:
    compile_s: float | None
    steady_s: float
    checks: list
    info: dict = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return all(c.ok for c in self.checks)


def _compile(fn, *args):
    """AOT-compile `jit(fn)` for `args`: (executable, seconds)."""
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def _steady(compiled, *args, reps: int = 3):
    """One warm call, then the median seconds of `reps` calls, each
    waited for with `block_until_ready`: (output, seconds)."""
    out = jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    return out, statistics.median(times)


def _run(fn, *args, reps: int = 3):
    """Compile and time `fn(*args)`: (output, compile s, steady s)."""
    compiled, compile_s = _compile(fn, *args)
    out, steady_s = _steady(compiled, *args, reps=reps)
    return out, compile_s, steady_s


# ---------------------------------------------------------------------------
# One-card phases
# ---------------------------------------------------------------------------


def phase_sir(k: int = 1_000_000, seed: int = 0) -> PhaseResult:
    """Beta-Bernoulli SIR (the README quickstart) through
    `beta_bernoulli.importance` vmapped over `k` particles. Oracle:
    p ~ Beta(2, 2), v ~ Bernoulli(p), v = 1 gives log Z = log 0.5 and the
    posterior Beta(3, 2) with mean 0.6. Tolerances are 6 standard errors,
    estimated from the weights by the delta method."""
    from genjax_tpu import ChoiceMap
    from genjax_tpu.models.beta_bernoulli import beta_bernoulli

    constraint = ChoiceMap.d({"v": True})

    def sir(key):
        keys = jax.random.split(key, k)
        trs, ws = jax.vmap(beta_bernoulli.importance, in_axes=(0, None, None))(
            keys, constraint, (2.0, 2.0)
        )
        p = trs.get_choices()["p"]
        lml = logsumexp(ws) - jnp.log(float(k))
        wn = jax.nn.softmax(ws)
        mean_p = jnp.sum(wn * p)
        w = jnp.exp(ws - jnp.max(ws))
        se_lml = jnp.std(w) / jnp.mean(w) / jnp.sqrt(float(k))
        se_mean = jnp.sqrt(jnp.sum(wn**2 * (p - mean_p) ** 2))
        return lml, mean_p, se_lml, se_mean

    out, compile_s, steady_s = _run(sir, jax.random.key(seed))
    lml, mean_p, se_lml, se_mean = (float(v) for v in out)
    return PhaseResult(
        compile_s,
        steady_s,
        [
            Check("|lml - log 0.5|", abs(lml - math.log(0.5)), 6 * se_lml),
            Check("|E[p|v] - 0.6|", abs(mean_p - 0.6), 6 * se_mean),
        ],
        {"lml": lml, "mean_p": mean_p, "particles_per_s": k / steady_s},
    )


def phase_pf(
    k: int = 1_000_000,
    t: int = 50,
    seeds: int = 4,
    widths: tuple = (1, 32),
    seed: int = 0,
) -> PhaseResult:
    """The flagship path of `__graft_entry__.entry()`: the bootstrap
    filter of `models.ssm` over T = `t` observations with `k` particles,
    whose systematic resampling runs through `ops.expand.expand_rows`.

    Checks: the filter's LML is finite; its systematic and multinomial
    (`take_rows`) variants agree within 6 standard errors estimated from
    `seeds` seeds; and at the operation level `expand_rows` equals its
    plain reference `take_rows(x, systematic_resample(...))` bit for bit
    at each width F in `widths` (same key and weights, pure data
    movement). The two row movers are also timed, side by side."""
    from genjax_tpu.core.gather import take_rows
    from genjax_tpu.inference.smc import systematic_cum_counts, systematic_resample
    from genjax_tpu.models.ssm import run_bootstrap_filter, simulate_ssm_data
    from genjax_tpu.ops.expand import expand_rows

    _, ys = simulate_ssm_data(jax.random.key(1), t)

    def filt(method):
        return lambda key: run_bootstrap_filter(
            key, ys, n_particles=k, resampling=method
        )[0]

    key0 = jax.random.key(seed)
    sys_fn, compile_s = _compile(filt("systematic"), key0)
    _, steady_s = _steady(sys_fn, key0)
    mult_fn, _ = _compile(filt("multinomial"), key0)
    keys = [jax.random.key(100 + i) for i in range(seeds)]
    lml_sys = np.array([float(sys_fn(kk)) for kk in keys])
    lml_mult = np.array([float(mult_fn(kk)) for kk in keys])
    se = math.sqrt(
        (np.var(lml_sys, ddof=1) + np.var(lml_mult, ddof=1)) / seeds
    )
    checks = [
        Check("non-finite filter LMLs", float(np.sum(~np.isfinite(lml_sys))), 0.0),
        Check(
            "|mean lml systematic - multinomial|",
            abs(float(np.mean(lml_sys) - np.mean(lml_mult))),
            6 * se,
        ),
    ]
    info = {
        "lml_systematic": float(np.mean(lml_sys)),
        "lml_multinomial": float(np.mean(lml_mult)),
        "particle_steps_per_s": t * k / steady_s,
    }

    kw, kx, kr = jax.random.split(jax.random.key(seed + 1), 3)
    lw = jax.random.normal(kw, (k,))

    def expand(key, lw, x):
        return expand_rows(x, systematic_cum_counts(key, lw, k), n_rows=k)

    def take(key, lw, x):
        return take_rows(x, systematic_resample(key, lw, k))

    for f in widths:
        x = jax.random.normal(kx, (k, f))
        # One program computes both, so both see the same cumulative counts.
        a, b = jax.jit(lambda *args: (expand(*args), take(*args)))(kr, lw, x)
        checks.append(
            Check(f"rows differing, expand vs take (F={f})",
                  float(np.sum(np.any(np.asarray(a) != np.asarray(b), axis=1))),
                  0.0)
        )
        for name, fn in (("expand", expand), ("take", take)):
            _, s = _steady(_compile(fn, kr, lw, x)[0], kr, lw, x, reps=5)
            info[f"{name}_ms_f{f}"] = s * 1e3
    return PhaseResult(compile_s, steady_s, checks, info)


def _conjugate_target():
    """x ~ N(0, 1), y ~ N(x, 1), observe y = 1: the dry run's model."""
    import genjax_tpu as g
    from genjax_tpu import ChoiceMap, Target

    @g.gen
    def conj():
        x = g.normal(0.0, 1.0) @ "x"
        y = g.normal(x, 1.0) @ "y"
        return y

    return Target(conj, (), ChoiceMap.kw(y=1.0))


def _smc_round(smc, target):
    """init, LML, resample, one Regenerate rejuvenation: (LML, ESS before
    resampling, posterior mean of x)."""
    from genjax_tpu import Regenerate, Selection

    def round_(key):
        col = smc.init(key, target)
        lml = smc.lml(col)
        ess0 = smc.ess(col)
        col = smc.maybe_resample(jax.random.fold_in(key, 1), col)
        col = smc.rejuvenate(
            jax.random.fold_in(key, 2), col, Regenerate(Selection.at["x"])
        )
        return lml, ess0, jnp.mean(col.get_particles().get_choices()["x"])

    return round_


def _smc_checks(k, lml, ess0, mean_x, label=""):
    from __graft_entry__ import EXACT_LML, POST_MEAN, POST_VAR

    # The dry run's LML tolerance, and for the mean the posterior variance
    # over the importance ESS plus what resampling can add (var / K).
    return [
        Check(f"|lml - exact|{label}", abs(lml - EXACT_LML), 6 * 1.87 / math.sqrt(k)),
        Check(
            f"|E[x|y] - 0.5|{label}",
            abs(mean_x - POST_MEAN),
            6 * math.sqrt(POST_VAR * (1 / ess0 + 1 / k)),
        ),
    ]


def phase_smc_round(k: int = 1_000_000, seed: int = 5) -> PhaseResult:
    """One `parallel.ShardedSMC` round over `particle_mesh(1)` on the
    conjugate model of `__graft_entry__`, checked against its exact LML
    and posterior mean."""
    from genjax_tpu.parallel import ShardedSMC, particle_mesh

    smc = ShardedSMC(n_particles=k, mesh=particle_mesh(1), ess_threshold=2.0)
    out, compile_s, steady_s = _run(
        _smc_round(smc, _conjugate_target()), jax.random.key(seed)
    )
    lml, ess0, mean_x = (float(v) for v in out)
    return PhaseResult(
        compile_s,
        steady_s,
        _smc_checks(k, lml, ess0, mean_x),
        {"lml": lml, "ess": ess0, "mean_x": mean_x,
         "particle_rounds_per_s": k / steady_s},
    )


def phase_hmc(
    n_chains: int = 8192,
    n_steps: int = 10,
    n: int = 256,
    d: int = 16,
    eps: float = 0.02,
    L: int = 5,
    seed: int = 4,
) -> PhaseResult:
    """`models.logreg.run_hmc_chains` under the default matmul precision
    (TF32 on the card for the f32 `X @ w`) and under "highest", on the
    same key. They must agree within 4 Monte Carlo standard errors of the
    chain mean, coordinate by coordinate."""
    from genjax_tpu.models.logreg import run_hmc_chains, simulate_logreg_data

    X, yo, _ = simulate_logreg_data(jax.random.key(3), n, d)

    def chains(key):
        w = run_hmc_chains(key, X, yo, n_chains=n_chains, n_steps=n_steps,
                           eps=eps, L=L)[0]
        return jnp.mean(w, axis=0), jnp.std(w, axis=0)

    key = jax.random.key(seed)
    (m_def, _), compile_s, steady_s = _run(chains, key)
    with jax.default_matmul_precision("highest"):
        (m_hi, s_hi), _, steady_hi = _run(chains, key)
    diff = np.abs(np.asarray(m_def) - np.asarray(m_hi))
    se = np.asarray(s_hi) / math.sqrt(n_chains)
    return PhaseResult(
        compile_s,
        steady_s,
        [Check("max |mean w default - highest| / MC SE", float(np.max(diff / se)), 4.0)],
        {"max_abs_diff_w": float(np.max(diff)),
         "chain_steps_per_s": n_chains * n_steps / steady_s,
         "highest_steady_s": steady_hi},
    )


# SVGD's particle mean is an estimate whose Monte Carlo resolution is
# about std / sqrt(n) per coordinate; a precision change must stay well
# inside it. TF32 rounds the f32 distance and density matmuls to 10
# mantissa bits: allow one resolution unit. bf16 stores the kernel
# matrix itself with 8 mantissa bits (4x TF32's rounding): allow four.
SVGD_TOL_DEFAULT = 1.0
SVGD_TOL_BF16 = 4.0


def phase_svgd(
    n_particles: int = 4096,
    d: int = 16,
    n_data: int = 256,
    n_steps: int = 2000,
    seed: int = 6,
) -> PhaseResult:
    """`inference.svgd.svgd` on the logistic-regression posterior:
    an f32 kernel under "highest" (the reference), an f32 kernel under
    the default precision, and a bf16 kernel. Particle means must agree
    with the reference within SVGD_TOL_DEFAULT and SVGD_TOL_BF16 units of
    std / sqrt(n_particles), coordinate by coordinate."""
    import genjax_tpu as g
    from genjax_tpu.inference.svgd import svgd
    from genjax_tpu.models.logreg import logistic_regression, simulate_logreg_data

    X, ys, _ = simulate_logreg_data(jax.random.key(5), n_data, d)

    def make(kernel_dtype):
        def run(key):
            trs, _ = svgd(
                key, logistic_regression, (X,), g.ChoiceMap.kw(ys=ys),
                g.Selection.at["w"], n_particles=n_particles,
                n_steps=n_steps, step_size=0.05, kernel_dtype=kernel_dtype,
            )
            w = trs.get_choices()["w"]
            return jnp.mean(w, axis=0), jnp.std(w, axis=0)

        return run

    key = jax.random.key(seed)
    with jax.default_matmul_precision("highest"):
        (m_hi, s_hi), _, steady_hi = _run(make(None), key)
    (m_def, _), compile_s, steady_s = _run(make(None), key)
    (m_bf, _), _, steady_bf = _run(make(jnp.bfloat16), key)
    unit = np.asarray(s_hi) / math.sqrt(n_particles)

    def err(m):
        return float(np.max(np.abs(np.asarray(m) - np.asarray(m_hi)) / unit))

    return PhaseResult(
        compile_s,
        steady_s,
        [
            Check("max |mean f32 default - highest| / (std/sqrt n)",
                  err(m_def), SVGD_TOL_DEFAULT),
            Check("max |mean bf16 - f32 highest| / (std/sqrt n)",
                  err(m_bf), SVGD_TOL_BF16),
        ],
        {"ms_per_step_default": steady_s / n_steps * 1e3,
         "ms_per_step_highest": steady_hi / n_steps * 1e3,
         "ms_per_step_bf16": steady_bf / n_steps * 1e3},
    )


# A float32 reduction's rounding error grows with the depth of its
# summation tree, about log2(n) ulps (3e-6 relative at 2^26); 1e-5 leaves
# room for the serial partial sums each GPU thread takes first.
LSE_RTOL = 1e-5


def phase_logsumexp(
    log2_sizes: tuple = (20, 26), elements_per_timing: int = 2**32,
    seed: int = 7,
) -> PhaseResult:
    """What a fused one-pass logsumexp would compete against: XLA's
    `jax.scipy.special.logsumexp` beside a read-only reduction
    (`sum |x|`) over the same bytes, at 2^20 floats (4 MB, inside the
    H100's 50 MB L2) and 2^26 (256 MB, over 4x the L2). Each is timed as
    an in-program loop over the same array; both results are checked
    against float64 NumPy."""
    info, checks = {}, []
    compile_total = steady_total = 0.0
    for lg in log2_sizes:
        n = 2**lg
        reps = max(1, elements_per_timing // n)
        x = jax.random.normal(jax.random.key(seed), (n,), jnp.float32)

        def loop(reduce, reps=reps):
            # The carry enters every pass, so no pass can be hoisted; at
            # ~1e-30 it leaves x unchanged in float32.
            def timed(x):
                return jax.lax.fori_loop(
                    0, reps, lambda _, c: 1e-30 * reduce(x - c),
                    jnp.float32(0), unroll=8,
                )

            return timed

        lse_val = float(jax.jit(logsumexp)(x))
        abs_val = float(jax.jit(lambda v: jnp.sum(jnp.abs(v)))(x))
        x64 = np.asarray(x, dtype=np.float64)
        m = x64.max()
        lse_ref = m + math.log(np.sum(np.exp(x64 - m)))
        abs_ref = float(np.sum(np.abs(x64)))
        checks += [
            Check(f"|lse - f64| (2^{lg})", abs(lse_val - lse_ref),
                  LSE_RTOL * max(1.0, abs(lse_ref))),
            Check(f"|sum|x| - f64| (2^{lg})", abs(abs_val - abs_ref),
                  LSE_RTOL * abs_ref),
        ]
        for name, reduce in (("lse", logsumexp),
                             ("read", lambda v: jnp.sum(jnp.abs(v)))):
            _, c, s = _run(loop(reduce), x)
            compile_total += c
            steady_total += s
            per = s / reps
            info[f"{name}_us_2^{lg}"] = per * 1e6
            info[f"{name}_GBps_2^{lg}"] = 4 * n / per / 1e9
    return PhaseResult(compile_total, steady_total, checks, info)


# ---------------------------------------------------------------------------
# Four-card phases
# ---------------------------------------------------------------------------


def phase_dryrun(n_devices: int = 4) -> PhaseResult:
    """`__graft_entry__.dryrun_multichip` on the real cards: every mesh
    driver certified against the conjugate oracle or a dense same-key
    run (it raises on disagreement). Compilation is inside its wall time."""
    from __graft_entry__ import dryrun_multichip

    t0 = time.perf_counter()
    dryrun_multichip(n_devices)
    return PhaseResult(None, time.perf_counter() - t0, [])


def phase_sharded_smc(k: int = 4_000_000, n_devices: int = 4, seed: int = 5) -> PhaseResult:
    """`ShardedSMC` with `k` particles sharded over `n_devices` cards
    against the same-key run on one card. The LML must agree to 1e-4
    (only the order of the cross-card sum differs), and the sharded round
    must match the conjugate oracle."""
    from genjax_tpu.parallel import ShardedSMC, particle_mesh

    target = _conjugate_target()
    key = jax.random.key(seed)
    outs = {}
    for n in (n_devices, 1):
        smc = ShardedSMC(n_particles=k, mesh=particle_mesh(n), ess_threshold=2.0)
        out, c, s = _run(_smc_round(smc, target), key)
        outs[n] = ([float(v) for v in out], c, s)
    (lml, ess0, mean_x), compile_s, steady_s = outs[n_devices]
    (lml_1, _, mean_1), _, steady_1 = outs[1]
    return PhaseResult(
        compile_s,
        steady_s,
        [Check(f"|lml {n_devices} cards - 1 card|", abs(lml - lml_1), 1e-4)]
        + _smc_checks(k, lml, ess0, mean_x, f" ({n_devices} cards)"),
        {"lml": lml, "lml_1card": lml_1, "mean_x": mean_x,
         "mean_x_1card": mean_1, "steady_s_1card": steady_1},
    )


ONE_CARD = (
    ("sir_1m", phase_sir),
    ("pf_t50_1m", phase_pf),
    ("smc_round_1m", phase_smc_round),
    ("hmc_logreg_8k", phase_hmc),
    ("svgd_d16", phase_svgd),
    ("logsumexp_finding", phase_logsumexp),
)
FOUR_CARDS = (
    ("dryrun_multichip_4", phase_dryrun),
    ("sharded_smc_4m", phase_sharded_smc),
)


def _fmt(v) -> str:
    return "n/a" if v is None else f"{v:.6g}" if isinstance(v, float) else str(v)


def phase_line(name: str, result: PhaseResult, peak_bytes) -> str:
    checks = "; ".join(
        f"{c.name} = {c.err:.3g} (tol {c.tol:.3g}) {'ok' if c.ok else 'FAIL'}"
        for c in result.checks
    )
    info = " ".join(f"{k}={_fmt(v)}" for k, v in result.info.items())
    return (
        f"[{name}] compile_s={_fmt(result.compile_s)} "
        f"steady_s={_fmt(result.steady_s)} peak_bytes_in_use={peak_bytes} | "
        f"{checks or 'raises on failure'} | {info}"
    ).rstrip(" |")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--chips", type=int, choices=(1, 4), default=1,
        help="4: run only the sharded drivers, across four cards",
    )
    args = parser.parse_args(argv)

    from genjax_tpu.utils.accelerator import (
        gpu_name_and_power_limit,
        require_gpus,
        use_compile_cache,
    )
    from genjax_tpu.utils.profiling import device_memory_stats

    devices = require_gpus(args.chips)
    cache = use_compile_cache(ROOT)
    import jaxlib

    dev = devices[0]
    print(
        f"[device] platform={dev.platform} kind={dev.device_kind} "
        f"count={len(jax.devices())} jax={jax.__version__} "
        f"jaxlib={jaxlib.__version__} compile_cache={cache}",
        flush=True,
    )
    print(gpu_name_and_power_limit(), flush=True)

    failed = []
    for name, phase in ONE_CARD if args.chips == 1 else FOUR_CARDS:
        result = phase()
        peak = max(
            device_memory_stats(d).get("peak_bytes_in_use", 0) for d in devices
        )
        print(phase_line(name, result, peak), flush=True)
        if not result.ok:
            failed.append(name)
    if failed:
        print(f"failed phases: {', '.join(failed)}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
