"""Multi-host inference: DCN-aware meshes and cross-host state assembly.

The reference is single-host, single-device (SURVEY.md §2.2 P6 — absent).
This module is the multi-host story, designed around two interconnect
tiers:

* **ICI** (fast, intra-slice) carries the particle axis — weight
  collectives and resampling row exchange (`parallel/smc.py`,
  `parallel/grid.py`).
* **DCN** (slow, inter-slice/inter-host) carries only the *island* axis:
  independent SMC runs that never exchange particles, only O(1) scalar
  diagnostics (per-island LML/ESS) — the island-particle-filter
  decomposition (Vergé et al. 2015), which is exactly `GridSMC` with the
  chain axis laid over DCN.

So a multi-host run is: `initialize_multihost()` once per process, build
`hybrid_mesh()`, and hand it to `GridSMC(chain_axis=islands)` /
`ShardedSMC` unchanged — the drivers are mesh-agnostic. LML estimates
pool across islands without bias via `pooled_lml`.

Single-process fallbacks keep every code path exercisable on one host
(and on the CI virtual-device mesh): `hybrid_mesh` degrades to a reshaped
local mesh with identical axis semantics. The multi-process branches are
executed in CI by a real 2-process cluster
(`tests/parallel/test_multiprocess.py`: `jax.distributed.initialize`
over a localhost coordinator, 4 virtual CPU devices per process) and the
island-SMC numbers are certified there against both the conjugate oracle
and a bit-level single-process same-PRNG run.
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from genjax_tpu.core.typing import FloatArray


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize the JAX distributed runtime for a multi-process run.

    Call once per host process before any backend use. Returns True if the distributed runtime was (already) initialized,
    False when running single-process (in which case this is a no-op —
    every `parallel/` API works unchanged on the local mesh).
    """
    if coordinator_address is None and num_processes is None:
        if process_id is not None:
            # A lone process_id is a misconfigured explicit launch, not a
            # query — silently ignoring it would mask the launcher bug.
            raise ValueError(
                "initialize_multihost: process_id was given without "
                "coordinator_address/num_processes. Pass all three for an "
                "explicit setup, or none to query an auto-detected runtime."
            )
        # Nothing requested explicitly: report whether a launcher already
        # set the distributed runtime up. (Safe to query the backend here
        # — there is nothing left for this call to initialize.)
        return jax.process_count() > 1
    # Explicit setup: jax.distributed.initialize MUST run before anything
    # touches the XLA backend, so no backend query may precede it.
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        if "already" in str(e).lower():
            return True  # launcher beat us to it
        raise
    return True


def hybrid_mesh(
    island_devices: int | None = None,
    particle_devices: int | None = None,
    island_axis: str = "islands",
    particle_axis: str = "particles",
) -> Mesh:
    """A 2-D `(islands, particles)` mesh whose island axis follows the
    slow interconnect tier.

    Multi-process: delegates to `mesh_utils.create_hybrid_device_mesh`,
    which groups devices by slice/granule so the first mesh axis crosses
    DCN and the second stays inside ICI. Single-process: a reshaped local
    mesh with the same axis names (default 1 × n — one island), so driver
    code is identical in tests and production.
    """
    n = len(jax.devices())
    if jax.process_count() > 1:
        from jax.experimental import mesh_utils

        # Shapes for create_hybrid_device_mesh are PER-GRANULE (ICI) and
        # ACROSS-GRANULE (DCN); the realized mesh is their elementwise
        # product. Islands ride DCN and may subdivide a granule; particles
        # must never cross DCN.
        granules = jax.process_count()
        per_granule = n // granules
        if island_devices is None:
            island_devices = granules
        if island_devices % granules != 0:
            raise ValueError(
                f"hybrid_mesh: island_devices={island_devices} must be a "
                f"multiple of the process/granule count ({granules}) — "
                f"fewer islands than granules would force the particle "
                f"axis across DCN."
            )
        islands_per_granule = island_devices // granules
        if per_granule % islands_per_granule != 0:
            raise ValueError(
                f"hybrid_mesh: islands-per-granule ({islands_per_granule}) "
                f"must divide the local device count ({per_granule})."
            )
        derived_particles = per_granule // islands_per_granule
        if particle_devices is not None and particle_devices != derived_particles:
            raise ValueError(
                f"hybrid_mesh: particle_devices={particle_devices} is "
                f"inconsistent with island_devices={island_devices} over "
                f"{n} devices in {granules} granules (expected "
                f"{derived_particles})."
            )
        # On GPU (and CPU) clusters each process is one host, so the
        # process is the slow-tier granule.
        devices = mesh_utils.create_hybrid_device_mesh(
            mesh_shape=(islands_per_granule, derived_particles),
            dcn_mesh_shape=(granules, 1),
            devices=jax.devices(),
            process_is_granule=True,
        )
        return Mesh(devices, (island_axis, particle_axis))
    if island_devices is None:
        island_devices = 1
    if particle_devices is None:
        particle_devices = n // island_devices
    used = island_devices * particle_devices
    return jax.make_mesh(
        (island_devices, particle_devices),
        (island_axis, particle_axis),
        devices=jax.devices()[:used],
        axis_types=(jax.sharding.AxisType.Auto,) * 2,
    )


def island_smc(
    n_islands: int,
    n_particles: int,
    mesh: Mesh | None = None,
    island_axis: str = "islands",
    particle_axis: str = "particles",
    ess_threshold: float = 0.5,
):
    """An island particle filter over a (possibly multi-host) mesh:
    `GridSMC` with its chain axis on the island (DCN) tier. Each island
    runs `n_particles`-particle SMC with island-local resampling; DCN
    never carries particle state.

    >>> import jax, jax.numpy as jnp
    >>> import genjax_tpu as gx
    >>> from genjax_tpu.inference import Target
    >>> from genjax_tpu.parallel.multihost import island_smc, pooled_lml
    >>> @gx.gen
    ... def model():
    ...     x = gx.normal(0.0, 1.0) @ "x"
    ...     _ = gx.normal(x, 1.0) @ "y"
    >>> target = Target(model, (), gx.ChoiceMap.kw(y=1.0))
    >>> smc = island_smc(n_islands=2, n_particles=64)
    >>> col = smc.init(jax.random.key(0), target)
    >>> lml = pooled_lml(smc.per_chain_lml(col))
    >>> bool(jnp.isfinite(lml))
    True
    """
    from genjax_tpu.parallel.grid import GridSMC

    if mesh is None:
        mesh = hybrid_mesh(
            island_axis=island_axis, particle_axis=particle_axis
        )
    return GridSMC(
        n_chains=n_islands,
        n_particles=n_particles,
        mesh=mesh,
        chain_axis=island_axis,
        particle_axis=particle_axis,
        ess_threshold=ess_threshold,
    )


def pooled_lml(per_island_lml: FloatArray) -> FloatArray:
    """Pool per-island log-marginal-likelihood estimates without bias.

    Each island's `exp(lml_i)` is an unbiased estimate of Z, so the
    pooled unbiased combination is their arithmetic mean in density
    space: `logsumexp(lml) - log(n)`. (A plain mean of the *log*
    estimates would inherit each island's Jensen bias instead of
    averaging it away.)
    """
    n = per_island_lml.shape[0]
    return jax.scipy.special.logsumexp(per_island_lml) - jnp.log(float(n))


def global_from_process_local(tree, mesh: Mesh, spec: P):
    """Assemble a globally-sharded pytree from per-process local shards.

    Each process passes the rows it owns (its slice of the leading axis);
    the result is a global `jax.Array` sharded by `NamedSharding(mesh,
    spec)`. Single-process this is just a `device_put`. Use to restore a
    checkpointed `ParticleCollection` onto a pod where no host can
    materialize the full particle state.
    """
    sharding = NamedSharding(mesh, spec)

    def place(local):
        if jax.process_count() == 1:
            return jax.device_put(local, sharding)
        global_rows = local.shape[0] * jax.process_count()
        global_shape = (global_rows,) + tuple(local.shape[1:])
        return jax.make_array_from_process_local_data(
            sharding, np.asarray(local), global_shape
        )

    return jax.tree_util.tree_map(place, tree)


def process_local_rows(arr) -> np.ndarray:
    """The rows of a sharded leading-axis array owned by this process,
    gathered to host memory (for per-host checkpointing or logging).

    Replicated copies are deduplicated by shard index: an array sharded
    over one mesh axis but replicated over another (e.g. per-island
    statistics on a hybrid mesh) contributes each distinct row range
    exactly once."""
    seen: set = set()
    shards = []
    for s in arr.addressable_shards:
        key = tuple(
            (sl.start, sl.stop, sl.step) for sl in s.index
        ) if s.index else ()
        if key in seen:
            continue
        seen.add(key)
        start = s.index[0].start or 0 if s.index else 0
        shards.append((start, np.asarray(s.data)))
    shards.sort(key=lambda t: t[0])
    return np.concatenate([d for _, d in shards], axis=0)
