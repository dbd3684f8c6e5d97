"""`chip_smoke.py`: every phase at a tiny size on the CPU, the refusal to
run without a GPU, the compile-cache path choice, and the row-mover
identity its `pf_t50_1m` phase checks at full width on the card."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from genjax_tpu.core.gather import take_rows
from genjax_tpu.inference.smc import systematic_cum_counts, systematic_resample
from genjax_tpu.ops.expand import expand_rows
from genjax_tpu.utils.accelerator import compile_cache_dir

TINY = {
    "sir_1m": dict(k=20_000),
    "pf_t50_1m": dict(k=2048, t=6, widths=(1, 3)),
    "smc_round_1m": dict(k=8192),
    "hmc_logreg_8k": dict(n_chains=256, n_steps=3, n=64, d=4),
    "svgd_d16": dict(n_particles=128, d=4, n_data=32, n_steps=20),
    "logsumexp_finding": dict(log2_sizes=(10, 14), elements_per_timing=2**16),
    "sharded_smc_4m": dict(k=8192, n_devices=4),
}
PHASES = dict(chip_smoke.ONE_CARD + chip_smoke.FOUR_CARDS)


@pytest.mark.parametrize("name", sorted(TINY))
def test_phase_checks_pass_at_tiny_size(name):
    result = PHASES[name](**TINY[name])
    assert result.checks, name
    assert result.ok, chip_smoke.phase_line(name, result, None)
    assert result.compile_s > 0 and result.steady_s > 0


def test_nan_check_fails():
    assert not chip_smoke.Check("x", float("nan"), 1.0).ok
    assert not chip_smoke.PhaseResult(
        1.0, 1.0, [chip_smoke.Check("x", 2.0, 1.0)]
    ).ok


def test_main_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_exits_nonzero(tmp_path):
    # A directory holding chip_smoke.py and nothing else of the repo.
    shutil.copy(chip_smoke.__file__, tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize(
    "environ, expected",
    [
        ({}, "/checkout/.jax_cache"),
        ({"JAX_COMPILATION_CACHE_DIR": "/shared/cache"}, "/shared/cache"),
    ],
)
def test_compile_cache_dir(environ, expected):
    assert compile_cache_dir("/checkout", environ) == expected


@pytest.mark.parametrize("width", [1, 2, 7, 32])
def test_expand_rows_equals_take_rows(width):
    n = 4099
    for seed in range(3):
        kw, kx, kr = jax.random.split(jax.random.key(seed), 3)
        lw = 2.0 * jax.random.normal(kw, (n,))
        x = jax.random.normal(kx, (n, width))

        @jax.jit
        def both(key, lw, x):
            expanded = expand_rows(x, systematic_cum_counts(key, lw, n), n_rows=n)
            return expanded, take_rows(x, systematic_resample(key, lw, n))

        a, b = both(kr, lw, x)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.gpu
@pytest.mark.parametrize("name", [name for name, _ in chip_smoke.ONE_CARD])
def test_phase_checks_pass_on_gpu(gpu, name):
    result = PHASES[name]()
    assert result.ok, chip_smoke.phase_line(name, result, None)
    assert jnp.zeros(()).devices() == {gpu}
