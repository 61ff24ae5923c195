"""The device BVH format shared by all builders.

Explicit-node SoA pytree (vs OptiX's opaque traversable handles,
`Framework/AccelerationStructure.h:24`): node AABBs + child indices, with
leaf triangles reordered into contiguous fixed-size slots so leaf
intersection is a fixed-shape vectorized Möller–Trumbore.

Encoding: child0 >= 0 → internal node with children (child0, child1);
child0 < 0 → leaf index (-child0 - 1), whose triangles occupy slots
[leaf*L, (leaf+1)*L) (padded with tri_id = -1). Node 0 is the root.

`leaf_size` and `max_depth` are static fields (part of the treedef) so the
traversal's stack bound and leaf loop are compile-time constants.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..utils import struct


@struct.dataclass
class BVH:
    node_lo: jnp.ndarray   # (N,3) f32
    node_hi: jnp.ndarray   # (N,3) f32
    child0: jnp.ndarray    # (N,) i32  (>=0 internal child; <0 => leaf -i-1)
    child1: jnp.ndarray    # (N,) i32
    tri_p0: jnp.ndarray    # (S,3) leaf-slot triangle data (MT form)
    tri_e1: jnp.ndarray    # (S,3)
    tri_e2: jnp.ndarray    # (S,3)
    tri_id: jnp.ndarray    # (S,) original tri index, -1 = padding
    leaf_size: int = struct.field(static=True)
    max_depth: int = struct.field(static=True)

    @property
    def num_nodes(self) -> int:
        return self.node_lo.shape[0]

    @property
    def num_leaves(self) -> int:
        return self.tri_p0.shape[0] // self.leaf_size
