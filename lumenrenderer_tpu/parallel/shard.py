"""Device-mesh sharding for multi-chip/multi-host rendering.

The reference has NO distributed backend (single CUcontext, SURVEY §2.7/5.8);
this is a first-class new component. Design (SURVEY §5.7, BASELINE north
star): shard the PIXEL/TILE axis across chips — rays for a tile stay
chip-local through intersect/shade/compact, the scene+BVH pytree is
replicated per device, and the only cross-chip traffic is image assembly and
gradient reduction, which XLA emits as psum (NCCL on GPUs) from the sharding
annotations (GSPMD). No hand-written collectives needed on this path.

Axis names: 'tiles' (data-parallel pixels). Multi-host extends the same mesh
over DCN via jax.distributed.initialize (mesh creation identical).
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

TILE_AXIS = "tiles"


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over all (or given) devices: pixel-tile data parallelism."""
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.array(devices), (TILE_AXIS,))


def pixel_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (pixel/ray) axis across the mesh."""
    return NamedSharding(mesh, P(TILE_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_pixels(tree: Any, mesh: Mesh) -> Any:
    """Place per-pixel pytree leaves (leading axis = pixels) on the mesh,
    sharded over tiles. Scalars/keys stay replicated."""
    ps = pixel_sharding(mesh)
    rep = replicated(mesh)

    def place(x):
        x = jax.numpy.asarray(x)
        if x.ndim >= 1 and x.shape[0] % mesh.size == 0 and x.shape[0] >= mesh.size:
            return jax.device_put(x, ps)
        return jax.device_put(x, rep)

    return jax.tree_util.tree_map(place, tree)


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Replicate a pytree (scene, BVH, camera) on every device of the mesh."""
    rep = replicated(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(jax.numpy.asarray(x), rep), tree)
