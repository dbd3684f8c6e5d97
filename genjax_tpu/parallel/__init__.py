"""Multi-chip scaling: particle/chain axes sharded over a device mesh.

The reference is single-host single-device (SURVEY.md §2.2: vmap/scan/jit
only). This package is new accelerator-native capability: named meshes, sharded
particle collections with `psum`-based weight reductions, distributed
systematic resampling over ICI, and sharded MCMC chain execution.
"""

from genjax_tpu.parallel.chains import sharded_mh_chains
from genjax_tpu.parallel.grid import GridSMC, grid_mesh
from genjax_tpu.parallel.mesh import particle_mesh, shard_leading_axis
from genjax_tpu.parallel.multihost import (
    global_from_process_local,
    hybrid_mesh,
    initialize_multihost,
    island_smc,
    pooled_lml,
    process_local_rows,
)
from genjax_tpu.parallel.pt import sharded_pt_run
from genjax_tpu.parallel.svgd import sharded_stein_direction, sharded_svgd
from genjax_tpu.parallel.smc import (
    ShardedSMC,
    sharded_ess,
    sharded_lml,
    sharded_systematic_ancestors,
)

__all__ = [
    "GridSMC",
    "ShardedSMC",
    "sharded_stein_direction",
    "sharded_svgd",
    "global_from_process_local",
    "grid_mesh",
    "hybrid_mesh",
    "initialize_multihost",
    "island_smc",
    "particle_mesh",
    "pooled_lml",
    "process_local_rows",
    "shard_leading_axis",
    "sharded_ess",
    "sharded_lml",
    "sharded_mh_chains",
    "sharded_pt_run",
    "sharded_systematic_ancestors",
]
