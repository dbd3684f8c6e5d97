"""Mesh construction and sharding helpers."""

import jax
import jax.tree_util as jtu
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def particle_mesh(
    n_devices: int | None = None, axis_name: str = "particles"
) -> Mesh:
    """A 1-D mesh over the available devices, named for the particle (or
    chain) axis. On one host this axis rides the cards' interconnect."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return jax.make_mesh(
        (len(devices),),
        (axis_name,),
        devices=devices,
        axis_types=(jax.sharding.AxisType.Auto,),
    )


def shard_leading_axis(tree, mesh: Mesh, axis_name: str = "particles"):
    """Place every leaf of `tree` with its leading axis sharded over
    `axis_name` (dense particle/chain state layout)."""

    def place(v):
        ndim = getattr(v, "ndim", 0)
        if ndim == 0:
            return jax.device_put(v, NamedSharding(mesh, P()))
        spec = P(axis_name, *([None] * (ndim - 1)))
        return jax.device_put(v, NamedSharding(mesh, spec))

    return jtu.tree_map(place, tree)


def constrain_leading_axis(
    tree, mesh: Mesh, axis_name: str = "particles", n_rows: int | None = None
):
    """`with_sharding_constraint` version of `shard_leading_axis` for use
    inside jit — keeps XLA's SPMD partitioner honest about the particle
    layout so collectives are inserted where intended.

    With `n_rows` given, leaves whose leading dimension differs are
    SHARED across the particle axis (`mcmc.share_chain_args` layout) and
    are constrained replicated instead of sharded."""

    def constrain(v):
        ndim = getattr(v, "ndim", 0)
        if ndim == 0:
            return v
        if n_rows is not None and v.shape[0] != n_rows:
            return jax.lax.with_sharding_constraint(v, NamedSharding(mesh, P()))
        spec = P(axis_name, *([None] * (ndim - 1)))
        return jax.lax.with_sharding_constraint(v, NamedSharding(mesh, spec))

    return jtu.tree_map(constrain, tree)
