"""bench.py functional gate.

The benchmark program is itself a deliverable, so a broken diagnostic or
a dropped JSON field must surface before it runs on the card.
BENCH_SMOKE=1 runs the ENTIRE flow with tiny shapes on the CPU; this test
asserts the process exits 0 (a diagnostic that raises fails the run) and
the stdout JSON carries the full metric set (SIR particles/s, HMC
chain-steps/s, ESS/s, PF particle-steps/s).
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(__file__))

REQUIRED_FIELDS = [
    "metric",
    "value",
    "unit",
    "vs_baseline",
    "gfi_overhead",
    "sampler_speedup",
    "hmc_chain_steps_per_s",
    "ess_per_s",
    "pf_particle_steps_per_s",
    "svgd_packed_tflops",
]


@pytest.mark.slow
def test_bench_smoke_json_contract():
    env = dict(os.environ)
    env["BENCH_SMOKE"] = "1"
    env.pop("JAX_PLATFORMS", None)  # bench switches itself in smoke mode
    proc = subprocess.run(
        [sys.executable, "bench.py"],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=560,
    )
    assert proc.returncode == 0, (
        f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    )
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, f"expected ONE JSON line on stdout: {lines}"
    out = json.loads(lines[0])
    missing = [f for f in REQUIRED_FIELDS if f not in out]
    assert not missing, f"JSON missing fields {missing}; stderr:\n{proc.stderr}"
