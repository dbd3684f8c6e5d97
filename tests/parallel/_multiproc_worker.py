"""Worker for the 2-process multihost integration test.

Launched (twice) by tests/parallel/test_multiprocess.py:
    python _multiproc_worker.py <process_id> <num_processes> <port>
with XLA_FLAGS=--xla_force_host_platform_device_count=4 so each process
contributes 4 virtual CPU devices to an 8-device, 2-granule cluster.

Exercises the REAL multi-process branches of parallel/multihost.py —
`jax.distributed.initialize`, `mesh_utils.create_hybrid_device_mesh`,
`jax.make_array_from_process_local_data` — which single-process tests
cannot reach, and certifies island-SMC numbers against the conjugate
oracle. Process 0 prints one machine-readable RESULT line the parent
also checks against a single-process same-PRNG run.
"""

import json
import sys


def main() -> None:
    process_id, num_processes, port = (
        int(sys.argv[1]),
        int(sys.argv[2]),
        sys.argv[3],
    )

    import jax

    # Platform choice must precede jax.distributed.initialize (which
    # initializes the backend): the virtual CPU devices, even where a GPU
    # exists.
    jax.config.update("jax_platforms", "cpu")

    from genjax_tpu.parallel.multihost import initialize_multihost

    assert initialize_multihost(
        f"localhost:{port}", num_processes, process_id
    )
    assert jax.process_count() == num_processes, jax.process_count()
    assert len(jax.local_devices()) == 4, jax.local_devices()
    assert len(jax.devices()) == 4 * num_processes, jax.devices()

    run(jax, process_id)


def run(jax, process_id: int) -> None:
    import numpy as np
    from jax.sharding import PartitionSpec as P

    import genjax_tpu as g
    from genjax_tpu import ChoiceMap, Target
    from genjax_tpu.parallel.multihost import (
        global_from_process_local,
        hybrid_mesh,
        island_smc,
        pooled_lml,
        process_local_rows,
    )

    @g.gen
    def model():
        x = g.normal(0.0, 1.0) @ "x"
        y = g.normal(x, 1.0) @ "y"
        return y

    target = Target(model, (), ChoiceMap.kw(y=1.0))

    # One island per process/granule: the island axis crosses DCN, the
    # particle axis stays inside each granule's ICI tier.
    mesh = hybrid_mesh(island_devices=2, particle_devices=4)
    assert mesh.devices.shape == (2, 4), mesh.devices.shape
    # DCN placement check: each mesh row (one island) must live entirely
    # on one process.
    for row in mesh.devices:
        procs = {d.process_index for d in row}
        assert len(procs) == 1, f"island spans processes: {procs}"

    n_particles = 2048
    islands = island_smc(n_islands=2, n_particles=n_particles, mesh=mesh)
    col = jax.jit(islands.init)(jax.random.key(0), target)
    lmls = jax.jit(islands.per_chain_lml)(col)
    plml = float(np.asarray(jax.jit(pooled_lml)(lmls)))

    # Conjugate oracle: x ~ N(0,1), y ~ N(x,1), y = 1.
    import math

    exact = -0.25 - 0.5 * math.log(2 * math.pi * 2.0)
    tol = 6 * 1.87 / math.sqrt(2 * n_particles)
    assert abs(plml - exact) <= tol, (
        f"pooled LML {plml:.4f} vs oracle {exact:.4f} (tol {tol:.4f})"
    )

    # Cross-host state assembly: every process contributes its local rows,
    # the global array must round-trip through process_local_rows.
    local = np.arange(8, dtype=np.float32) + 100.0 * process_id
    garr = global_from_process_local(
        local.reshape(4, 2), mesh, P("islands", None)
    )
    assert garr.shape == (8, 2), garr.shape
    back = process_local_rows(garr)
    np.testing.assert_array_equal(back, local.reshape(4, 2))

    # `lmls` spans both processes; replicate it before fetching (a plain
    # np.asarray on a non-addressable array raises).
    from jax.experimental import multihost_utils

    per_island = np.asarray(
        multihost_utils.process_allgather(lmls, tiled=True)
    )
    if process_id == 0:
        print(
            "RESULT "
            + json.dumps(
                {
                    "pooled_lml": plml,
                    "per_island": [float(v) for v in per_island],
                }
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()
