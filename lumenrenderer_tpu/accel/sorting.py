"""Ray sorting for coherence — stream compaction's second half.

The reference leans on RT-core hardware to absorb incoherent secondary rays;
this pipeline instead *sorts* them (the north star's "compaction via
sort/scan"): group rays by direction octant (major) and origin Morton cell
(minor) so each 128-ray intersector tile becomes a compact cone of nearby
origins — exactly what the tile-frustum culling (`accel/tiled.py`) wants.

Used for bounce and shadow rays (primary rays are already block-swizzled).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import vecmath as vm
from . import morton


def ray_sort_key(o, d, scene_lo, scene_hi) -> jnp.ndarray:
    """uint32 key: [octant(3) | origin morton(21)]."""
    octant = (
        (d[:, 0] >= 0).astype(jnp.uint32)
        | ((d[:, 1] >= 0).astype(jnp.uint32) << 1)
        | ((d[:, 2] >= 0).astype(jnp.uint32) << 2)
    )
    m = morton.morton3d(o, scene_lo, scene_hi) >> 9  # top 21 bits
    return (octant << 29) | m


def capsule_sort_key(o, d, t_max, scene_lo, scene_hi) -> jnp.ndarray:
    """uint32 key for SHADOW rays: [origin morton(12) | endpoint morton(12)].

    The endpoint o + d*t_max is the sampled light point, so sorted tiles
    become origin-region -> light-region capsules. Measured on the bench
    scene: 19.0 vs 34.2 mean admitted clusters/tile against the octant key
    (tools/r4_kernel_lab3.py)."""
    end = o + d * jnp.maximum(t_max, 0.0)[:, None]
    m_o = morton.morton3d(o, scene_lo, scene_hi) >> 18        # top 12 bits
    m_e = morton.morton3d(end, scene_lo, scene_hi) >> 18
    return (m_o << 12) | m_e


def sorted_intersectors(isect, occl, scene_lo, scene_hi):
    """Wrap (intersect_fn, occlude_fn) with sort → query → unsort.

    Closest-hit (bounce) rays sort by [direction octant | origin morton];
    occlusion (shadow) rays sort by the capsule key above."""
    lo = jnp.asarray(scene_lo, jnp.float32)
    hi = jnp.asarray(scene_hi, jnp.float32)

    def _prep(o, d, tn, tx, capsule=False):
        r = o.shape[0]
        tn_b = jnp.broadcast_to(jnp.asarray(tn, jnp.float32), (r,))
        tx_b = jnp.broadcast_to(jnp.asarray(tx, jnp.float32), (r,))
        if capsule:
            key = capsule_sort_key(o, d, tx_b, lo, hi)
        else:
            key = ray_sort_key(o, d, lo, hi)
        # dead rays sort last so live tiles stay pure (tight frusta) AND
        # fully-dead tiles get visit count 0 (the Pallas kernel skips them)
        key = jnp.where(tx_b > tn_b, key, jnp.uint32(0xFFFFFFFF))
        order = jnp.argsort(key)
        # ONE (R,8) row-gather permute instead of four separate permutes
        # (each gather has a fixed per-op cost)
        packed = jnp.concatenate(
            [o, d, tn_b[:, None], tx_b[:, None]], axis=1
        )[order]
        return (order, packed[:, 0:3], packed[:, 3:6], packed[:, 6],
                packed[:, 7])

    def isect_sorted(o, d, tn, tx):
        order, os_, ds_, tns, txs = _prep(o, d, tn, tx)
        res = isect(os_, ds_, tns, txs)
        inv = jnp.argsort(order)
        # unsort per-ray fields with ONE packed gather; pass scalars through.
        # Round 5: "u"/"v" are never consumed downstream — extract_surface_
        # data re-derives exact t/u/v from the winner triangle (surface.py
        # NOTE) — so they skip the unsort gather entirely (the (R,k) unsort
        # costs ~11 ns/row·col at 1440p; halving the width is ~15 ms/pass).
        per_ray = {k2: v for k2, v in res.items()
                   if v.ndim > 0 and k2 not in ("u", "v")}
        passthrough = {k2: jnp.zeros_like(v) for k2, v in res.items()
                       if v.ndim > 0 and k2 in ("u", "v")}
        scalars = {k2: v for k2, v in res.items() if v.ndim == 0}
        names = sorted(per_ray)

        def to_f32(v):  # lossless: int32 rides as raw bits
            if v.dtype == jnp.int32:
                return jax.lax.bitcast_convert_type(v, jnp.float32)
            return v.astype(jnp.float32)

        def from_f32(v, dt):
            if dt == jnp.int32:
                return jax.lax.bitcast_convert_type(v, jnp.int32)
            return v.astype(dt)

        cat = jnp.stack([to_f32(per_ray[k2]) for k2 in names], axis=1)[inv]
        out = {
            k2: from_f32(cat[:, i_], per_ray[k2].dtype)
            for i_, k2 in enumerate(names)
        }
        out.update(passthrough)
        out.update(scalars)
        return out

    def occl_sorted(o, d, tn, tx):
        order, os_, ds_, tns, txs = _prep(o, d, tn, tx, capsule=True)
        res = occl(os_, ds_, tns, txs)
        inv = jnp.argsort(order)
        return res[inv]

    return isect_sorted, occl_sorted


# ---------------------------------------------------------------------------
# Block-local bucket partition — a measured loser on the previous
# accelerator, kept as the recorded experiment: its cumsum/scatter mechanics
# cost more than the global argsort, AND its 2048-ray screen-strip blocks
# span the full screen width, so admission barely improves. The production
# path is `sorted_intersectors` above.
# ---------------------------------------------------------------------------

PARTITION_BLOCK = 2048


def _block_partition_order(buckets: jnp.ndarray, n_buckets: int,
                           block: int) -> jnp.ndarray:
    """Stable block-local counting partition.

    buckets: (R,) int32 in [0, n_buckets); R % block == 0.
    Returns order (R,) int32: source index for each sorted slot (use as
    `arr[order]`; invert with scatter for unsort).
    """
    r = buckets.shape[0]
    blocks = r // block
    bb = buckets.reshape(blocks, block).astype(jnp.int32)
    oh = (bb[:, :, None] == jnp.arange(n_buckets, dtype=jnp.int32)
          ).astype(jnp.int32)                       # (B, block, nb)
    ranks = jnp.cumsum(oh, axis=1) - oh             # exclusive rank in bucket
    counts = ranks[:, -1, :] + oh[:, -1, :]         # (B, nb)
    starts = jnp.cumsum(counts, axis=1) - counts    # exclusive bucket starts
    rank_sel = jnp.take_along_axis(ranks, bb[:, :, None], axis=2)[..., 0]
    start_sel = jnp.take_along_axis(starts, bb, axis=1)
    base = (jnp.arange(blocks, dtype=jnp.int32) * block)[:, None]
    dest = (start_sel + rank_sel + base).reshape(-1)
    order = jnp.zeros((r,), jnp.int32).at[dest].set(
        jnp.arange(r, dtype=jnp.int32))
    return order


def _radix_block_order(buckets: jnp.ndarray, passes: int,
                       block: int) -> jnp.ndarray:
    """LSD base-8 block-local radix: full grouping of `3*passes`-bit keys
    within each block (stability composes the passes)."""
    order = _block_partition_order(buckets & 7, 8, block)
    for p in range(1, passes):
        b = (buckets[order] >> (3 * p)) & 7
        o2 = _block_partition_order(b, 8, block)
        order = order[o2]
    return order


def blocked_sorted_intersectors(isect, occl, scene_lo, scene_hi,
                                block: int = PARTITION_BLOCK):
    """Coherence wrappers for the wavefront's secondary rays (round 4).

    - bounce closest: partition by direction octant (tiles become same-octant
      cones from a screen-local origin set).
    - occlusion: partition by shadow-ray ENDPOINT cell (= the sampled light
      point, o + d*t_max): tiles become origin-region -> light-region
      capsules. Measured on the bench scene: admission 34.2 -> 19.0 mean
      clusters/tile vs the octant key (tools/r4_kernel_lab3.py).
    Dead rays (t_max < t_min) are forced into the last bucket so dead tiles
    cluster and cost nothing in the visit kernel.
    """
    lo = jnp.asarray(scene_lo, jnp.float32)
    hi = jnp.asarray(scene_hi, jnp.float32)

    def _pack(o, d, tn, tx):
        r = o.shape[0]
        tn_b = jnp.broadcast_to(jnp.asarray(tn, jnp.float32), (r,))
        tx_b = jnp.broadcast_to(jnp.asarray(tx, jnp.float32), (r,))
        pad = (-r) % block
        packed = jnp.concatenate(
            [o, d, tn_b[:, None], tx_b[:, None]], axis=1)
        if pad:
            fill = jnp.zeros((pad, 8), packed.dtype)
            fill = fill.at[:, 6].set(1.0)  # t_min=1 > t_max=0: dead
            packed = jnp.concatenate([packed, fill], axis=0)
        return packed, r

    def _apply(packed, order):
        s = packed[order]
        return s[:, 0:3], s[:, 3:6], s[:, 6], s[:, 7]

    def isect_sorted(o, d, tn, tx):
        packed, r = _pack(o, d, tn, tx)
        dd = packed[:, 3:6]
        octant = (
            (dd[:, 0] >= 0).astype(jnp.int32)
            | ((dd[:, 1] >= 0).astype(jnp.int32) << 1)
            | ((dd[:, 2] >= 0).astype(jnp.int32) << 2)
        )
        dead = packed[:, 7] < packed[:, 6]
        octant = jnp.where(dead, 8, octant)
        order = _block_partition_order(octant, 9, block)
        os_, ds_, tns, txs = _apply(packed, order)
        res = isect(os_, ds_, tns, txs)
        inv = jnp.zeros((order.shape[0],), jnp.int32).at[order].set(
            jnp.arange(order.shape[0], dtype=jnp.int32))[:r]
        per_ray = {k2: v for k2, v in res.items() if v.ndim > 0}
        scalars = {k2: v for k2, v in res.items() if v.ndim == 0}
        names = sorted(per_ray)

        def to_f32(v):
            if v.dtype == jnp.int32:
                return jax.lax.bitcast_convert_type(v, jnp.float32)
            return v.astype(jnp.float32)

        def from_f32(v, dt):
            if dt == jnp.int32:
                return jax.lax.bitcast_convert_type(v, jnp.int32)
            return v.astype(dt)

        cat = jnp.stack([to_f32(per_ray[k2]) for k2 in names], axis=1)[inv]
        out = {
            k2: from_f32(cat[:, i_], per_ray[k2].dtype)
            for i_, k2 in enumerate(names)
        }
        out.update(scalars)
        return out

    def occl_sorted(o, d, tn, tx):
        packed, r = _pack(o, d, tn, tx)
        end = packed[:, 0:3] + packed[:, 3:6] * jnp.maximum(
            packed[:, 7], 0.0)[:, None]
        cell = (morton.morton3d(end, lo, hi) >> 24).astype(jnp.int32)  # 6 bit
        dead = packed[:, 7] < packed[:, 6]
        cell = jnp.where(dead, 63, cell)
        order = _radix_block_order(cell, 2, block)
        os_, ds_, tns, txs = _apply(packed, order)
        res = occl(os_, ds_, tns, txs)
        inv = jnp.zeros((order.shape[0],), jnp.int32).at[order].set(
            jnp.arange(order.shape[0], dtype=jnp.int32))[:r]
        return res[inv]

    return isect_sorted, occl_sorted
