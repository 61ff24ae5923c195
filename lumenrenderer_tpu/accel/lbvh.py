"""LBVH build: Morton-sorted implicit binary tree, fully vectorized.

JAX replacement for OptiX GAS builds
(`Framework/OptixWrapper.cpp:46-131`). Design rationale (designed for XLA, not a
CUDA translation):

- Primitives are sorted by the Morton code of their AABB centroid
  (`jax.lax` sort — the XLA analogue of the thrust sorts the reference
  uses elsewhere, `CUDAKernels/ReSTIRKernels.cu:70-89`).
- Consecutive runs of `leaf_size` sorted triangles form leaves; the leaf
  count is padded to a power of two and the tree is a COMPLETE implicit
  binary tree in heap order (children of i are 2i+1 / 2i+2). This trades a
  little SAH quality vs. Karras radix trees for an *entirely static*
  structure: no parent pointers, no atomics, and the interior AABBs are
  built with log2(M) level-wise min/max reductions — each level one
  vectorized pass, perfect for the VPU. (A Karras tree needs per-node
  range finding + atomic bottom-up flags — a GPU idiom that maps badly
  to XLA.)
- Triangle data is gathered into leaf order once at build, so traversal
  reads are contiguous per leaf.

The returned BVH is a frozen pytree → replicable across the device mesh,
donate-able, checkpointable.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import morton
from .format import BVH

#: padded/invalid triangle slot marker
INVALID = jnp.int32(-1)


def _next_pow2(n: int) -> int:
    return 1 << max(int(n - 1).bit_length(), 0) if n > 1 else 1


@partial(jax.jit, static_argnames=("leaf_size",))
def build_lbvh(tri_pos: jnp.ndarray, leaf_size: int = 4) -> BVH:
    """Build the LBVH from (T,3,3) world-space triangles. Jittable; runs on
    device in O(T log T) (sort-dominated)."""
    t = tri_pos.shape[0]
    assert t > 0, "empty scene"
    lo_t = jnp.min(tri_pos, axis=1)  # (T,3)
    hi_t = jnp.max(tri_pos, axis=1)
    centroid = 0.5 * (lo_t + hi_t)
    scene_lo = jnp.min(lo_t, axis=0)
    scene_hi = jnp.max(hi_t, axis=0)
    codes = morton.morton3d(centroid, scene_lo, scene_hi)
    order = jnp.argsort(codes).astype(jnp.int32)

    m = _next_pow2(-(-t // leaf_size))  # padded leaf count
    slots = m * leaf_size
    pad = slots - t
    tri_id = jnp.concatenate([order, jnp.full((pad,), INVALID)])
    gat = jnp.maximum(tri_id, 0)
    p = tri_pos[gat]  # (slots,3,3)
    valid = (tri_id >= 0)[:, None]
    p0 = jnp.where(valid, p[:, 0], jnp.inf)
    e1 = jnp.where(valid, p[:, 1] - p[:, 0], 0.0)
    e2 = jnp.where(valid, p[:, 2] - p[:, 0], 0.0)

    # leaf AABBs: min/max over the leaf's slots (inf boxes for padding)
    slot_lo = jnp.where(valid, jnp.minimum(jnp.minimum(p[:, 0], p[:, 1]), p[:, 2]), jnp.inf)
    slot_hi = jnp.where(valid, jnp.maximum(jnp.maximum(p[:, 0], p[:, 1]), p[:, 2]), -jnp.inf)
    leaf_lo = slot_lo.reshape(m, leaf_size, 3).min(axis=1)
    leaf_hi = slot_hi.reshape(m, leaf_size, 3).max(axis=1)

    # interior AABBs: log2(m) level-wise reductions (vectorized, no atomics)
    levels_lo = [leaf_lo]
    levels_hi = [leaf_hi]
    cur_lo, cur_hi = leaf_lo, leaf_hi
    while cur_lo.shape[0] > 1:
        cur_lo = jnp.minimum(cur_lo[0::2], cur_lo[1::2])
        cur_hi = jnp.maximum(cur_hi[0::2], cur_hi[1::2])
        levels_lo.append(cur_lo)
        levels_hi.append(cur_hi)
    node_lo = jnp.concatenate(levels_lo[::-1], axis=0)  # heap order: root first
    node_hi = jnp.concatenate(levels_hi[::-1], axis=0)

    # explicit children in the shared BVH format: heap layout means
    # internal node i has children 2i+1 / 2i+2; node j >= m-1 is leaf j-(m-1)
    n_nodes = 2 * m - 1
    ids = jnp.arange(n_nodes, dtype=jnp.int32)
    is_leaf = ids >= (m - 1)
    child0 = jnp.where(is_leaf, -(ids - (m - 1)) - 1, 2 * ids + 1)
    child1 = jnp.where(is_leaf, 0, 2 * ids + 2)
    depth = max(int(m - 1).bit_length(), 1) + 1

    return BVH(
        node_lo=node_lo,
        node_hi=node_hi,
        child0=child0,
        child1=child1,
        tri_p0=p0,
        tri_e1=e1,
        tri_e2=e2,
        tri_id=tri_id,
        leaf_size=leaf_size,
        max_depth=depth,
    )
