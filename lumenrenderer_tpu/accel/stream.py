"""Pair-stream intersector: matmul-batched ray/triangle intersection.

A JAX replacement for OptiX RT-core traversal — designed for the
hardware rather than translated from it (reference: `optixLaunch`,
`OptixWrapper.cpp:543-567`). Per-ray stack traversal is gather-bound and
lockstep-divergent under XLA; this module restructures
intersection as dense, sorted, compacted stream work:

1. Triangles are partitioned into CLUSTERS of K by a binned-SAH cut
   (`accel/sah.py` with leaf_size=K).
2. Möller–Trumbore is *lifted to a bilinear form*: with ray features
   f = [o×d, d, o, 1] (10, computed ONCE per ray) and per-triangle
   coefficient columns [det|u|v|t], all four MT quantities for a
   (rays × tris) block are ONE f32 matmul — systolic-array work instead of
   VPU scalar chains.
3. Ray×cluster candidate pairs come from a dense AABB test, are extracted
   C-major (cluster-sorted for free) via size-bounded compaction, padded so
   every PAIR_TILE-pair tile touches exactly ONE cluster, then intersected
   with a batched einsum; closest hits reduce back per-ray with
   scatter-min. This is the north star's "stream compaction via sort/scan
   instead of persistent-kernel queues" made concrete.

Static shape caps (`max_pairs_per_ray`) bound compaction; overflow is
reported (never silently wrong unless the cap is exceeded, in which case
`overflow` is True and callers should rebuild with a larger cap).
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import struct

PAIR_TILE = 128


@struct.dataclass
class ClusterSet:
    """Device cluster table for the pair-stream intersector, plus a small
    second-level SAH tree over cluster AABBs (the TLAS analogue) used by
    the hierarchical tile-culling path for large scenes."""

    aabb_lo: jnp.ndarray    # (C,3)
    aabb_hi: jnp.ndarray    # (C,3)
    tri_feat: jnp.ndarray   # (C,10,4K) MT coefficient columns [det|u|v|t] blocks
    tri_id: jnp.ndarray     # (C,K) original tri ids (-1 pad)
    tree_lo: jnp.ndarray    # (Nn,3) cluster-tree node AABBs
    tree_hi: jnp.ndarray    # (Nn,3)
    tree_child0: jnp.ndarray  # (Nn,) <0 => leaf -(i+1)
    tree_child1: jnp.ndarray  # (Nn,)
    tree_leaf_cluster: jnp.ndarray  # (Nl,) leaf -> cluster id
    tris_per_cluster: int = struct.field(static=True)
    tree_depth: int = struct.field(static=True)

    @property
    def num_clusters(self) -> int:
        return self.aabb_lo.shape[0]


def ray_features(o: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Per-ray MT feature rows [o×d, d, o, 1] — computed once per batch."""
    m = jnp.cross(o, d)
    return jnp.concatenate(
        [m, d, o, jnp.ones(o.shape[:-1] + (1,), o.dtype)], axis=-1
    )


def build_clusters(tri_pos, cluster_size: int = 64) -> ClusterSet:
    """Partition triangles into SAH clusters and precompute MT features
    (global frame; f32 is ample at rendering precision for scene extents up
    to ~1e3 — cite: RAY_EPS=1e-3 working precision)."""
    tp32 = np.asarray(tri_pos, np.float32)
    from .sah import build_sah_fast

    _, _, child0, _, order, _ = build_sah_fast(tp32, cluster_size)
    tp = tp32.astype(np.float64)
    k = cluster_size
    c = order.shape[0] // k
    tri_id = order.reshape(c, k)

    # fully vectorized feature assembly (scales to millions of triangles)
    ids = tri_id                                   # (C,K)
    valid = ids >= 0                               # (C,K)
    gat = np.maximum(ids, 0)
    tri3 = tp[gat]                                 # (C,K,3,3)
    tlo = np.where(valid[..., None], tri3.min(axis=2), np.inf)
    thi = np.where(valid[..., None], tri3.max(axis=2), -np.inf)
    lo = tlo.min(axis=1)
    hi = thi.max(axis=1)
    lo = np.where(np.isfinite(lo), lo, 1e30)
    hi = np.where(np.isfinite(hi), hi, -1e30)
    p0 = tri3[:, :, 0]                             # (C,K,3)
    e1 = tri3[:, :, 1] - p0
    e2 = tri3[:, :, 2] - p0
    n = np.cross(e1, e2)
    vz = valid[..., None]
    z3 = lambda a: np.where(vz, a, 0.0).transpose(0, 2, 1)  # (C,3,K)
    feat = np.zeros((c, 10, 4 * k), np.float64)
    # blocked layout: columns [det*K | u*K | v*K | t*K] so each quantity is a
    # CONTIGUOUS slice of the matmul result
    feat[:, 3:6, 0 * k : 1 * k] = z3(-n)
    feat[:, 0:3, 1 * k : 2 * k] = z3(e2)
    feat[:, 3:6, 1 * k : 2 * k] = z3(np.cross(p0, e2))
    feat[:, 0:3, 2 * k : 3 * k] = z3(-e1)
    feat[:, 3:6, 2 * k : 3 * k] = z3(-np.cross(p0, e1))
    feat[:, 6:9, 3 * k : 4 * k] = z3(n)
    feat[:, 9, 3 * k : 4 * k] = np.where(valid, -np.einsum("ckj,ckj->ck", p0, n), 0.0)

    # second-level SAH tree over cluster boxes (leaf = 1 cluster)
    from .sah import build_sah_boxes

    tlo, thi, tc0, tc1, torder, tdepth = build_sah_boxes(
        np.where(np.isfinite(lo) & (np.abs(lo) < 1e29), lo, 0.0),
        np.where(np.isfinite(hi) & (np.abs(hi) < 1e29), hi, 0.0),
        leaf_size=1,
    )
    return ClusterSet(
        aabb_lo=jnp.asarray(lo, jnp.float32),
        aabb_hi=jnp.asarray(hi, jnp.float32),
        tri_feat=jnp.asarray(feat, jnp.float32),
        tri_id=jnp.asarray(tri_id.astype(np.int32)),
        tree_lo=jnp.asarray(tlo, jnp.float32),
        tree_hi=jnp.asarray(thi, jnp.float32),
        tree_child0=jnp.asarray(tc0),
        tree_child1=jnp.asarray(tc1),
        tree_leaf_cluster=jnp.asarray(torder.astype(np.int32)),
        tris_per_cluster=k,
        tree_depth=tdepth,
    )


def _ray_cluster_mask(cs: ClusterSet, o, d, t_min, t_max):
    """Dense (R,C) slab test."""
    inv = 1.0 / jnp.where(jnp.abs(d) > 1e-20, d, jnp.where(d >= 0, 1e-20, -1e-20))
    t0 = (cs.aabb_lo[None, :, :] - o[:, None, :]) * inv[:, None, :]
    t1 = (cs.aabb_hi[None, :, :] - o[:, None, :]) * inv[:, None, :]
    tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
    return (tn <= tf) & (tf >= t_min[:, None]) & (tn <= t_max[:, None])


def _extract_pairs(mask_rc, max_pairs: int):
    """C-major compaction of the (R,C) mask into cluster-sorted pair lists.

    Returns (pair_ray (P,), pair_cluster (P,), overflow ()bool), -1-filled.
    """
    r, c = mask_rc.shape
    flat = mask_rc.T.reshape(-1)  # C-major → sorted by cluster
    (idx,) = jnp.nonzero(flat, size=max_pairs, fill_value=-1)
    pair_cluster = jnp.where(idx >= 0, idx // r, -1).astype(jnp.int32)
    pair_ray = jnp.where(idx >= 0, idx % r, -1).astype(jnp.int32)
    overflow = jnp.sum(flat) > max_pairs
    return pair_ray, pair_cluster, overflow


def _pad_runs_to_tiles(pair_ray, pair_cluster, num_clusters: int, out_size: int):
    """Scatter pairs so each cluster's run starts on a PAIR_TILE boundary.

    Returns (padded_ray (S,), tile_cluster (S/T,)) with -1 fills.
    """
    p = pair_ray.shape[0]
    valid = pair_ray >= 0
    pc = jnp.where(valid, pair_cluster, num_clusters)  # park invalid at end
    counts = jnp.bincount(pc, length=num_clusters + 1)[:num_clusters]
    starts = jnp.concatenate([jnp.zeros(1, counts.dtype), jnp.cumsum(counts)])[:-1]
    padded_counts = ((counts + PAIR_TILE - 1) // PAIR_TILE) * PAIR_TILE
    offsets = jnp.concatenate(
        [jnp.zeros(1, counts.dtype), jnp.cumsum(padded_counts)]
    )[:-1]
    rank = jnp.arange(p) - starts[jnp.clip(pc, 0, num_clusters - 1)]
    dest = jnp.where(valid, offsets[jnp.clip(pc, 0, num_clusters - 1)] + rank, out_size)
    padded_ray = jnp.full((out_size + 1,), -1, jnp.int32).at[dest].set(
        jnp.where(valid, pair_ray, -1)
    )[:out_size]
    padded_cluster = jnp.full((out_size + 1,), -1, jnp.int32).at[dest].set(
        jnp.where(valid, pair_cluster, -1)
    )[:out_size]
    tiles = out_size // PAIR_TILE
    tile_cluster = jnp.max(padded_cluster.reshape(tiles, PAIR_TILE), axis=1)
    return padded_ray, tile_cluster


def _intersect_tiles(
    cs: ClusterSet, rf, t_min, t_max, padded_ray, tile_cluster, need_uv: bool
):
    """Batched MT over pair tiles.

    rf: (R,10) precomputed ray features. Returns flat per-pair results:
    (ray (P,), t, u, v, tri_id, hit).
    """
    k = cs.tris_per_cluster
    tiles = tile_cluster.shape[0]
    pr = padded_ray.reshape(tiles, PAIR_TILE)
    prc = jnp.maximum(pr, 0)
    tc = jnp.maximum(tile_cluster, 0)

    f = rf[prc]                                 # (T,P,10) one gather
    feats = cs.tri_feat[tc]                     # (T,10,4K)
    # HIGHEST: a reduced-precision matmul default (bf16 or TF32) is not
    # enough for geometric hit predicates (see accel/tiled.py)
    res = jnp.einsum(
        "tpf,tfk->tpk", f, feats, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    det = res[..., 0 * k : 1 * k]
    ok = jnp.abs(det) > 1e-12
    inv = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    u = res[..., 1 * k : 2 * k] * inv
    v = res[..., 2 * k : 3 * k] * inv
    t = res[..., 3 * k : 4 * k] * inv

    tid = cs.tri_id[tc]                         # (T,K)
    tmin_p = t_min[prc][..., None]
    tmax_p = t_max[prc][..., None]
    hit = (
        ok
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > tmin_p)
        & (t <= tmax_p)
        & (tid[:, None, :] >= 0)
        & (pr >= 0)[..., None]
    )
    t = jnp.where(hit, t, jnp.inf)
    if not need_uv:
        return pr, t, None, None, None, hit
    return pr, t, u, v, jnp.broadcast_to(tid[:, None, :], t.shape), hit


def _sizes(r: int, c: int, max_pairs_per_ray: int):
    max_pairs = ((r * max_pairs_per_ray) // PAIR_TILE + 1) * PAIR_TILE
    out_size = max_pairs + c * PAIR_TILE
    return max_pairs, out_size


@partial(jax.jit, static_argnames=("max_pairs_per_ray",))
def intersect_closest(cs: ClusterSet, origins, dirs, t_min, t_max,
                      max_pairs_per_ray: int = 8):
    """Closest-hit query; contract matches `accel.brute.intersect_closest`,
    plus an 'overflow' bool in the result dict. Rays with t_max <= t_min are
    dead and generate no pair work."""
    r = origins.shape[0]
    t_min_b = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (r,))
    t_max_b = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (r,))
    max_pairs, out_size = _sizes(r, cs.num_clusters, max_pairs_per_ray)

    mask = _ray_cluster_mask(cs, origins, dirs, t_min_b, t_max_b)
    pair_ray, pair_cluster, overflow = _extract_pairs(mask, max_pairs)
    padded_ray, tile_cluster = _pad_runs_to_tiles(
        pair_ray, pair_cluster, cs.num_clusters, out_size
    )
    rf = ray_features(origins, dirs)
    pr, t, u, v, tid, hit = _intersect_tiles(
        cs, rf, t_min_b, t_max_b, padded_ray, tile_cluster, need_uv=True
    )

    # per-pair best over K, then scatter-min per ray
    kbest = jnp.argmin(t, axis=-1)
    take = lambda a: jnp.take_along_axis(a, kbest[..., None], axis=-1)[..., 0]
    t_p = take(t).reshape(-1)
    u_p = take(u).reshape(-1)
    v_p = take(v).reshape(-1)
    id_p = take(tid).reshape(-1)
    ray_p = jnp.where(pr.reshape(-1) >= 0, pr.reshape(-1), r)

    best_t = jnp.full((r + 1,), jnp.inf, jnp.float32).at[ray_p].min(t_p)
    # winner resolution: smallest flat pair index among pairs matching best_t
    is_win = (t_p <= best_t[ray_p]) & jnp.isfinite(t_p)
    pidx = jnp.arange(t_p.shape[0], dtype=jnp.int32)
    win_idx = (
        jnp.full((r + 1,), jnp.iinfo(jnp.int32).max, jnp.int32)
        .at[jnp.where(is_win, ray_p, r)]
        .min(pidx)
    )[:r]
    found = win_idx < jnp.iinfo(jnp.int32).max
    wi = jnp.where(found, win_idx, 0)
    return {
        "t": jnp.where(found, t_p[wi], jnp.inf),
        "tri": jnp.where(found, id_p[wi], -1),
        "u": jnp.where(found, u_p[wi], 0.0),
        "v": jnp.where(found, v_p[wi], 0.0),
        "overflow": overflow,
    }


@partial(jax.jit, static_argnames=("max_pairs_per_ray",))
def intersect_any(cs: ClusterSet, origins, dirs, t_min, t_max,
                  max_pairs_per_ray: int = 8):
    """Occlusion query: True where any triangle blocks [t_min, t_max]."""
    r = origins.shape[0]
    t_min_b = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (r,))
    t_max_b = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (r,))
    max_pairs, out_size = _sizes(r, cs.num_clusters, max_pairs_per_ray)

    mask = _ray_cluster_mask(cs, origins, dirs, t_min_b, t_max_b)
    pair_ray, pair_cluster, _ = _extract_pairs(mask, max_pairs)
    padded_ray, tile_cluster = _pad_runs_to_tiles(
        pair_ray, pair_cluster, cs.num_clusters, out_size
    )
    rf = ray_features(origins, dirs)
    pr, t, _, _, _, hit = _intersect_tiles(
        cs, rf, t_min_b, t_max_b, padded_ray, tile_cluster, need_uv=False
    )
    any_hit = jnp.any(hit, axis=-1).reshape(-1)
    ray_p = jnp.where(pr.reshape(-1) >= 0, pr.reshape(-1), r)
    occ = jnp.zeros((r + 1,), bool).at[ray_p].max(any_hit)
    return occ[:r]


def stream_intersectors(cs: ClusterSet, max_pairs_per_ray: int = 8) -> Tuple:
    """Bind a ClusterSet into (intersect_fn, occlude_fn) for the wavefront
    loop (drops the overflow flag; query it separately when validating)."""

    def isect(o, d, tn, tx):
        res = intersect_closest(cs, o, d, tn, tx, max_pairs_per_ray=max_pairs_per_ray)
        return {k: res[k] for k in ("t", "tri", "u", "v")}

    def occl(o, d, tn, tx):
        return intersect_any(cs, o, d, tn, tx, max_pairs_per_ray=max_pairs_per_ray)

    return isect, occl


def refit_clusters(cs: ClusterSet, tri_pos: jnp.ndarray) -> ClusterSet:
    """Device-side cluster REFIT for dynamic scenes (round 4, ≙ the
    reference's AS update on transform dirt, `PTScene.cpp:77-160` /
    `PTMeshInstance.cpp:74-105` — it rebuilds; we refit, the standard
    BLAS-refit trade: topology/partition stays, boxes + MT features update).

    Pure jnp, jit-safe: cluster membership (tri_id) is static; AABBs and the
    blocked MT coefficient columns are recomputed from the new (T,3,3)
    world-space tri_pos. The second-level tree is refit CONSERVATIVELY (every
    node box = global bounds): sound for the tree-culling path, exact for
    the default frustum/dense culling which only reads cluster AABBs.
    """
    ids = cs.tri_id                                  # (C,K)
    valid = ids >= 0
    k = cs.tris_per_cluster
    c = ids.shape[0]
    tri3 = tri_pos[jnp.maximum(ids, 0)]              # (C,K,3,3)
    big = jnp.float32(1e30)
    tlo = jnp.where(valid[..., None], jnp.min(tri3, axis=2), big)
    thi = jnp.where(valid[..., None], jnp.max(tri3, axis=2), -big)
    lo = jnp.min(tlo, axis=1)
    hi = jnp.max(thi, axis=1)
    lo = jnp.where(jnp.isfinite(lo) & (jnp.abs(lo) < big), lo, big)
    hi = jnp.where(jnp.isfinite(hi) & (jnp.abs(hi) < big), hi, -big)

    p0 = tri3[:, :, 0]
    e1 = tri3[:, :, 1] - p0
    e2 = tri3[:, :, 2] - p0
    n = jnp.cross(e1, e2)
    vz = valid[..., None]
    z3 = lambda a: jnp.where(vz, a, 0.0).transpose(0, 2, 1)  # (C,3,K)
    feat = jnp.zeros((c, 10, 4 * k), jnp.float32)
    feat = feat.at[:, 3:6, 0 * k:1 * k].set(z3(-n))
    feat = feat.at[:, 0:3, 1 * k:2 * k].set(z3(e2))
    feat = feat.at[:, 3:6, 1 * k:2 * k].set(z3(jnp.cross(p0, e2)))
    feat = feat.at[:, 0:3, 2 * k:3 * k].set(z3(-e1))
    feat = feat.at[:, 3:6, 2 * k:3 * k].set(z3(-jnp.cross(p0, e1)))
    feat = feat.at[:, 6:9, 3 * k:4 * k].set(z3(n))
    feat = feat.at[:, 9, 3 * k:4 * k].set(
        jnp.where(valid, -jnp.einsum("ckj,ckj->ck", p0, n), 0.0))

    glo = jnp.min(jnp.where(jnp.abs(lo) < big, lo, big), axis=0)
    ghi = jnp.max(jnp.where(jnp.abs(hi) < big, hi, -big), axis=0)
    return cs.replace(
        aabb_lo=lo, aabb_hi=hi, tri_feat=feat,
        tree_lo=jnp.broadcast_to(glo, cs.tree_lo.shape),
        tree_hi=jnp.broadcast_to(ghi, cs.tree_hi.shape),
    )
