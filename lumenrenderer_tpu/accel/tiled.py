"""Tiled-stream intersector: ray-tile × cluster batched Möller–Trumbore.

Second-generation intersector (evolution of `accel/stream.py`, whose
pair stream was dominated by per-row gathers). This design removes them:

- Rays are processed in TILES of 128 *consecutive* rays. A tile's ray
  features are a contiguous reshape — no gather.
- Per ray-tile, the union of clusters any of its rays hits is computed
  from a (tiles, C) AABB test, ordered by entry distance, and capped at
  `max_visits` (overflow reported, never silent).
- The visit loop runs in the fused Pallas kernel
  (`ops/pallas/intersect.py`): per tile, only its live visits, with an
  ordered early-out. `_scan_keys` is the plain-XLA reference of the same
  loop: a `lax.scan` over every visit slot, one batched
  (tiles, 128, 10) x (tiles, 10, 4K) einsum per step.
- The final per-ray reduction is a packed-key min — no scatter.

Coherence note: consecutive rays = scanline-coherent for primary/shadow
rays; bounce rays benefit from the sort in the integrator. Incoherent
tiles just visit more clusters (overflow flag warns).
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from ..ops.pallas import intersect as pk
from ..ops.pallas.intersect import KEY_MISS
from .stream import ClusterSet, build_clusters, ray_features  # shared build

RAY_TILE = 128


def _ray_cluster_window(cs: ClusterSet, o, d, t_min, t_max):
    """Dense (R,C) slab test → (hit, t_near)."""
    inv = 1.0 / jnp.where(jnp.abs(d) > 1e-20, d, jnp.where(d >= 0, 1e-20, -1e-20))
    t0 = (cs.aabb_lo[None, :, :] - o[:, None, :]) * inv[:, None, :]
    t1 = (cs.aabb_hi[None, :, :] - o[:, None, :]) * inv[:, None, :]
    tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
    hit = (tn <= tf) & (tf >= t_min[:, None]) & (tn <= t_max[:, None])
    return hit, jnp.where(hit, jnp.maximum(tn, 0.0), jnp.inf)


def _pad(a, r_pad, fill):
    return jnp.pad(a, ((0, r_pad),) + ((0, 0),) * (a.ndim - 1), constant_values=fill)


# ---------------------------------------------------------------------------
# hierarchical tile culling (large scenes): conservative interval-ray packet
# traversal of the second-level cluster tree — replaces the dense (R,C) mask
# whose cost is O(R*C). Packet/interval traversal is the classic CPU-SIMD
# idea (Wald et al.) re-expressed per 128-ray tile; soundness = no false
# misses (axis with 0 in the direction interval imposes no constraint).
# ---------------------------------------------------------------------------

def _tile_bounds(o, d, tn, tx, tiles: int, tile: int):
    """Per-tile conservative interval bounds over the live rays."""
    ot = o.reshape(tiles, tile, 3)
    dt = d.reshape(tiles, tile, 3)
    alive = (tx > tn).reshape(tiles, tile)
    big = jnp.float32(3e37)
    olo = jnp.min(jnp.where(alive[..., None], ot, big), axis=1)
    ohi = jnp.max(jnp.where(alive[..., None], ot, -big), axis=1)
    dlo = jnp.min(jnp.where(alive[..., None], dt, big), axis=1)
    dhi = jnp.max(jnp.where(alive[..., None], dt, -big), axis=1)
    t_cap = jnp.max(jnp.where(alive, tx.reshape(tiles, tile), -big), axis=1)
    any_alive = jnp.any(alive, axis=1)
    return olo, ohi, dlo, dhi, t_cap, any_alive


def _frustum_visits(cs: ClusterSet, o, d, tn, tx, tiles: int, mv: int):
    """Tile-granular dense culling: conservative interval-ray (packet) slab
    test of every (tile, cluster) pair — O(T*C) instead of the per-ray dense
    path's O(R*C), at slightly looser bounds (frustum vs exact ray union).
    Returns (order (T,mv), valid (T,mv), tnear (T,mv) sorted asc, overflow)."""
    olo, ohi, dlo, dhi, t_cap, any_alive = _tile_bounds(
        o, d, tn, tx, tiles, RAY_TILE
    )
    eps = 1e-20
    inv_a = 1.0 / jnp.where(jnp.abs(dlo) > eps, dlo, eps)        # (T,3)
    inv_b = 1.0 / jnp.where(jnp.abs(dhi) > eps, dhi, eps)
    zero_in_d = (dlo <= 0.0) & (dhi >= 0.0)                      # (T,3)
    blo = cs.aabb_lo[None, :, :]                                 # (1,C,3)
    bhi = cs.aabb_hi[None, :, :]
    nmin = blo - ohi[:, None, :]                                 # (T,C,3)
    nmax = bhi - olo[:, None, :]
    # interval product corners bound every per-ray slab t
    c1 = nmin * inv_a[:, None, :]
    c2 = nmin * inv_b[:, None, :]
    c3 = nmax * inv_a[:, None, :]
    c4 = nmax * inv_b[:, None, :]
    ent = jnp.minimum(jnp.minimum(c1, c2), jnp.minimum(c3, c4))
    exi = jnp.maximum(jnp.maximum(c1, c2), jnp.maximum(c3, c4))
    ent = jnp.where(zero_in_d[:, None, :], -jnp.inf, ent)
    exi = jnp.where(zero_in_d[:, None, :], jnp.inf, exi)
    tn_lb = jnp.max(ent, axis=-1)                                # (T,C)
    tf_ub = jnp.min(exi, axis=-1)
    hit = (
        (tn_lb <= tf_ub)
        & (tf_ub >= 0.0)
        & (tn_lb <= t_cap[:, None])
        & any_alive[:, None]
    )
    tnear = jnp.where(hit, jnp.maximum(tn_lb, 0.0), jnp.inf)
    neg_t, idx = jax.lax.top_k(-tnear, mv)                       # asc by tnear
    valid = jnp.isfinite(neg_t)
    overflow = jnp.any(jnp.sum(hit, axis=1) > mv)
    return idx.astype(jnp.int32), valid, -neg_t, overflow


def _tile_tree_visits(cs: ClusterSet, o, d, tn, tx, tiles: int, mv: int):
    """Returns (order (T,mv) cluster ids, valid (T,mv), tnear (T,mv) sorted
    ascending, overflow)."""
    olo, ohi, dlo, dhi, t_cap, any_alive = _tile_bounds(
        o, d, tn, tx, tiles, RAY_TILE
    )

    def possible_hit(blo, bhi, olo1, ohi1, dlo1, dhi1, cap):
        # per-axis candidate t products (conservative interval bounds)
        zero_in_d = (dlo1 <= 0.0) & (dhi1 >= 0.0)
        inv_a = 1.0 / jnp.where(jnp.abs(dlo1) > 1e-20, dlo1, 1e-20)
        inv_b = 1.0 / jnp.where(jnp.abs(dhi1) > 1e-20, dhi1, 1e-20)
        n1 = blo - ohi1
        n2 = blo - olo1
        n3 = bhi - ohi1
        n4 = bhi - olo1
        cands = jnp.stack(
            [n1 * inv_a, n1 * inv_b, n2 * inv_a, n2 * inv_b,
             n3 * inv_a, n3 * inv_b, n4 * inv_a, n4 * inv_b], axis=0
        )  # (8, 3)
        ent_lb = jnp.where(zero_in_d, -jnp.inf, jnp.min(cands, axis=0))
        exi_ub = jnp.where(zero_in_d, jnp.inf, jnp.max(cands, axis=0))
        tn_lb = jnp.max(ent_lb)
        tf_ub = jnp.min(exi_ub)
        return (tn_lb <= tf_ub) & (tf_ub >= 0.0) & (tn_lb <= cap), jnp.maximum(
            tn_lb, 0.0
        )

    max_stack = cs.tree_depth + 2

    def traverse_tile(olo1, ohi1, dlo1, dhi1, cap, ok_tile):
        stack = jnp.zeros((max_stack,), jnp.int32)
        tstack = jnp.zeros((max_stack,), jnp.float32)
        root_hit, root_tn = possible_hit(
            cs.tree_lo[0], cs.tree_hi[0], olo1, ohi1, dlo1, dhi1, cap
        )
        sp = jnp.where(root_hit & ok_tile, 1, 0).astype(jnp.int32)
        tstack = tstack.at[0].set(root_tn)
        visits = jnp.zeros((mv,), jnp.int32)
        vtn = jnp.full((mv,), jnp.inf, jnp.float32)
        count = jnp.int32(0)

        def cond(st):
            sp = st[0]
            return sp > 0

        def body(st):
            sp, stack, tstack, visits, vtn, count = st
            node = stack[sp - 1]
            node_tn = tstack[sp - 1]
            sp = sp - 1
            c0 = cs.tree_child0[node]
            c1 = cs.tree_child1[node]
            is_leaf = c0 < 0
            # leaf: append cluster (drop when full -> overflow)
            leaf_idx = jnp.maximum(-c0 - 1, 0)
            cluster = cs.tree_leaf_cluster[leaf_idx]
            slot = jnp.minimum(count, mv - 1)
            take = is_leaf & (count < mv)
            visits = jnp.where(take, visits.at[slot].set(cluster), visits)
            vtn = jnp.where(take, vtn.at[slot].set(node_tn), vtn)
            count = count + is_leaf.astype(jnp.int32)
            # internal: push children that possibly hit, near-first pop
            c0i = jnp.maximum(c0, 0)
            h0, tn0 = possible_hit(
                cs.tree_lo[c0i], cs.tree_hi[c0i], olo1, ohi1, dlo1, dhi1, cap
            )
            h1, tn1 = possible_hit(
                cs.tree_lo[c1], cs.tree_hi[c1], olo1, ohi1, dlo1, dhi1, cap
            )
            h0 = h0 & ~is_leaf
            h1 = h1 & ~is_leaf
            swap = tn1 < tn0
            near = jnp.where(swap, c1, c0i)
            far = jnp.where(swap, c0i, c1)
            t_near = jnp.where(swap, tn1, tn0)
            t_far = jnp.where(swap, tn0, tn1)
            h_near = jnp.where(swap, h1, h0)
            h_far = jnp.where(swap, h0, h1)
            stack = jnp.where(h_far, stack.at[sp].set(far), stack)
            tstack = jnp.where(h_far, tstack.at[sp].set(t_far), tstack)
            sp_f = sp + h_far.astype(jnp.int32)
            stack = jnp.where(h_near, stack.at[sp_f].set(near), stack)
            tstack = jnp.where(h_near, tstack.at[sp_f].set(t_near), tstack)
            sp = sp_f + h_near.astype(jnp.int32)
            return sp, stack, tstack, visits, vtn, count

        _, _, _, visits, vtn, count = jax.lax.while_loop(
            cond, body, (sp, stack, tstack, visits, vtn, count)
        )
        return visits, vtn, count

    visits, vtn, counts = jax.vmap(traverse_tile)(
        olo, ohi, dlo, dhi, t_cap, any_alive
    )
    # near-first pops are only approximately sorted; the packed-key closest
    # reduction is order-independent but the ordered EARLY-OUT requires
    # strictly ascending entry t — sort the (small) visit lists.
    sort_idx = jnp.argsort(vtn, axis=1)
    visits = jnp.take_along_axis(visits, sort_idx, axis=1)
    vtn = jnp.take_along_axis(vtn, sort_idx, axis=1)
    valid = (
        jax.lax.broadcasted_iota(jnp.int32, (tiles, mv), 1) < counts[:, None]
    )
    overflow = jnp.any(counts > mv)
    return visits, valid, jnp.where(valid, vtn, jnp.inf), overflow


def _key_layout(k: int, mv: int):
    """Packed closest-hit key: (bitcast(t) & ~low_mask) | (step << k_bits) | k.

    Positive-float bit patterns are order-preserving, so min(key) is the
    nearest hit up to 2^-(23-low_bits) relative t (ties resolve to any
    co-near triangle); exact t/u/v come from one coefficient gather after.
    """
    k_bits = max((k - 1).bit_length(), 1)
    s_bits = max((mv - 1).bit_length(), 1)
    low_bits = k_bits + s_bits
    # 15 low bits leave 8 mantissa bits => winner unique to ~2^-8 relative t
    assert low_bits <= 15, f"packed-key layout overflow: {k=} {mv=}"
    return k_bits, s_bits, low_bits


def _scan_keys(cs: ClusterSet, rf, tmin_t, tmax_t, order, valid_k, *,
               k_bits: int, low_bits: int, closest: bool):
    """Plain-XLA reference of the visit loop: a `lax.scan` over all `mv`
    visit slots of every tile, one batched (T,128,10)x(T,10,4K) einsum per
    step at Precision.HIGHEST (a float32 einsum's default may round its
    operands: TF32 on the GPU's tensor cores; HIGH and HIGHEST both matched
    brute force on the H100, PERF.md). Returns (best_key (T,128),
    occluded (T,128))."""
    tiles, _, _ = rf.shape
    mv = order.shape[1]
    k = cs.tris_per_cluster
    low_mask = jnp.int32(~((1 << low_bits) - 1))
    k_ids = jax.lax.broadcasted_iota(jnp.int32, (1, 1, k), 2)

    def step(carry, inputs):
        best_key, occ = carry
        sel, ok_k, step_i = inputs                          # (T,), (T,), ()
        feats = cs.tri_feat[sel]                            # (T,10,4K)
        tid = cs.tri_id[sel]                                # (T,K)
        res = jnp.einsum("trf,tfc->trc", rf, feats,
                         preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
        det = res[..., 0 * k : 1 * k]
        okd = jnp.abs(det) > 1e-12
        inv = jnp.where(okd, 1.0 / jnp.where(okd, det, 1.0), 0.0)
        u = res[..., 1 * k : 2 * k] * inv
        v = res[..., 2 * k : 3 * k] * inv
        t = res[..., 3 * k : 4 * k] * inv
        hit = (
            okd
            & (u >= 0.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (t > tmin_t[..., None])
            & (t <= tmax_t[..., None])
            & (tid[:, None, :] >= 0)
            & ok_k[:, None, None]
        )
        if closest:
            tb = jax.lax.bitcast_convert_type(
                jnp.maximum(t, 0.0), jnp.int32
            )
            key = (tb & low_mask) | (step_i << k_bits) | k_ids
            key = jnp.where(hit, key, KEY_MISS)
            best_key = jnp.minimum(best_key, jnp.min(key, axis=-1))
        occ = occ | jnp.any(hit, axis=-1)
        return (best_key, occ), None

    init = (
        jnp.full((tiles, RAY_TILE), KEY_MISS, jnp.int32),
        jnp.zeros((tiles, RAY_TILE), bool),
    )
    (best_key, occ), _ = jax.lax.scan(
        step, init, (order.T, valid_k.T, jnp.arange(mv, dtype=jnp.int32))
    )
    return best_key, occ


def _visit_lists(cs: ClusterSet, origins, dirs, t_min, t_max, mv: int,
                 culling: str):
    """Pad rays to whole tiles and build each tile's visit list.

    Returns (o, d, tn, tx) padded to R' = tiles * RAY_TILE (padded rays dead:
    t_max < t_min) and (order (T,mv) cluster ids, valid (T,mv), tnear (T,mv)
    ascending entry t, overflow)."""
    r = origins.shape[0]
    t_min_b = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (r,))
    t_max_b = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (r,))
    r_pad = (-r) % RAY_TILE
    o = _pad(origins, r_pad, 0.0)
    d = _pad(dirs, r_pad, 1.0)
    tn = _pad(t_min_b, r_pad, 0.0)
    tx = _pad(t_max_b, r_pad, -1.0)
    tiles = (r + r_pad) // RAY_TILE
    c = cs.num_clusters
    if culling == "auto":
        # dense: O(R*C) per-ray slab test, exact per-tile union; big scenes
        # (1M tris -> C~8k: ~1 GB per (R,C) array at 1440p) take the
        # packet-tree walk
        culling = "dense" if c <= 512 else "tree"
    if culling == "dense":
        hit_rc, tnear_rc = _ray_cluster_window(cs, o, d, tn, tx)
        hit_tc = jnp.any(hit_rc.reshape(tiles, RAY_TILE, c), axis=1)      # (T,C)
        tnear_tc = jnp.min(tnear_rc.reshape(tiles, RAY_TILE, c), axis=1)  # (T,C)
        tnear_tc = jnp.where(hit_tc, tnear_tc, jnp.inf)
        order = jnp.argsort(tnear_tc, axis=1)[:, :mv]                     # (T,mv)
        valid_k = jnp.take_along_axis(hit_tc, order, axis=1)              # (T,mv)
        tnear_k = jnp.take_along_axis(tnear_tc, order, axis=1)
        overflow = jnp.any(jnp.sum(hit_tc, axis=1) > mv)
    elif culling == "frustum":
        order, valid_k, tnear_k, overflow = _frustum_visits(
            cs, o, d, tn, tx, tiles, mv
        )
    else:
        # O(T * log C) conservative packet traversal of the cluster tree
        order, valid_k, tnear_k, overflow = _tile_tree_visits(
            cs, o, d, tn, tx, tiles, mv
        )
    return (o, d, tn, tx), (order.astype(jnp.int32), valid_k, tnear_k,
                            overflow)


def _kernel_inputs(o, d, tn, tx, valid_k, tnear_k):
    """(12, R') ray rows, per-tile visit counts and entry-t key bits in the
    layout `ops/pallas/intersect.py::visit_scan` takes."""
    rays = jnp.concatenate(
        [ray_features(o, d), tn[:, None], tx[:, None]], axis=1).T
    nv = jnp.sum(valid_k, axis=1).astype(jnp.int32)
    tn_bits = jax.lax.bitcast_convert_type(
        jnp.maximum(tnear_k, 0.0).astype(jnp.float32), jnp.int32
    )
    tnb = jnp.where(
        valid_k, jnp.minimum(tn_bits, KEY_MISS - 1), jnp.int32(KEY_MISS)
    )
    return rays, nv, tnb


@partial(jax.jit, static_argnames=("max_visits", "culling"))
def kernel_inputs(cs: ClusterSet, origins, dirs, t_min, t_max,
                  max_visits: int, culling: str = "auto"):
    """The visit kernel's inputs for one pass, for timing the kernel alone
    (tools/visit_kernel_bench.py)."""
    mv = min(max_visits, cs.num_clusters)
    (o, d, tn, tx), (order, valid_k, tnear_k, overflow) = _visit_lists(
        cs, origins, dirs, t_min, t_max, mv, culling)
    rays, nv, tnb = _kernel_inputs(o, d, tn, tx, valid_k, tnear_k)
    return dict(rays=rays, sel=order, nv=nv, tnb=tnb, overflow=overflow)


@partial(jax.jit, static_argnames=("max_visits", "closest", "method",
                                   "culling", "decode", "interpret"))
def _query(cs: ClusterSet, origins, dirs, t_min, t_max,
           max_visits: int, closest: bool, method: str = "kernel",
           culling: str = "auto", decode: bool = True,
           interpret: bool = False):
    r = origins.shape[0]
    k = cs.tris_per_cluster
    c = cs.num_clusters
    mv = min(max_visits, c)
    (o, d, tn, tx), (order, valid_k, tnear_k, overflow) = _visit_lists(
        cs, origins, dirs, t_min, t_max, mv, culling)
    tiles = o.shape[0] // RAY_TILE

    k_bits, s_bits, low_bits = _key_layout(k, mv)
    low_mask = jnp.int32(~((1 << low_bits) - 1))

    if method == "kernel":
        rays, nv, tnb = _kernel_inputs(o, d, tn, tx, valid_k, tnear_k)
        best_key = pk.visit_scan(
            rays, cs.tri_feat, order, nv, tnb,
            k=k, tile=RAY_TILE, mv=mv, k_bits=k_bits, low_bits=low_bits,
            closest=closest, interpret=interpret,
        )
        occ = best_key > 0
    elif method == "scan":
        best_key, occ = _scan_keys(
            cs, ray_features(o, d).reshape(tiles, RAY_TILE, 10),
            tn.reshape(tiles, RAY_TILE), tx.reshape(tiles, RAY_TILE), order,
            valid_k, k_bits=k_bits, low_bits=low_bits, closest=closest)
    else:
        raise ValueError(f"unknown method {method!r}")

    if not closest:
        return {
            "t": jnp.full((r,), jnp.inf),
            "tri": jnp.full((r,), -1, jnp.int32),
            "u": jnp.zeros((r,)),
            "v": jnp.zeros((r,)),
            "occluded": occ.reshape(-1)[:r],
            "overflow": overflow,
        }

    # decode the winner key: step/k bits -> global triangle id (ONE small
    # (R,) gather from the (C,K) id table)
    bk = best_key.reshape(-1)[:r]
    found = bk < KEY_MISS
    k_win = bk & ((1 << k_bits) - 1)
    step_win = (bk >> k_bits) & ((1 << s_bits) - 1)
    tile_idx = (jnp.arange(r, dtype=jnp.int32) // RAY_TILE)
    cluster = order[tile_idx, step_win]                     # (R,)
    tri_g = cs.tri_id[jnp.maximum(cluster, 0), k_win]
    if not decode:
        # fast path (the renderer): exact t/u/v are re-derived downstream by
        # `extract_surface_data` via elementwise MT on its fused attr-table
        # gather, which saves a second per-ray gather + einsum here. t is the
        # key's quantized distance (masked low bits), good to
        # ~2^-(23-low_bits).
        t_key = jax.lax.bitcast_convert_type(bk & low_mask, jnp.float32)
        return {
            "t": jnp.where(found, t_key, jnp.inf),
            "tri": jnp.where(found, tri_g, -1),
            "u": jnp.zeros((r,)),
            "v": jnp.zeros((r,)),
            "occluded": found,
            "overflow": overflow,
        }
    # coefficient columns of the winning triangle — ONE (R,10,4) gather
    cols = cs.tri_feat.reshape(c, 10, 4, k)[jnp.maximum(cluster, 0), :, :, k_win]
    rf_r = ray_features(origins, dirs)
    res4 = jnp.einsum("rf,rfc->rc", rf_r, cols,
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
    det = res4[:, 0]
    okd = jnp.abs(det) > 1e-12
    inv = jnp.where(okd, 1.0 / jnp.where(okd, det, 1.0), 0.0)
    u_e = res4[:, 1] * inv
    v_e = res4[:, 2] * inv
    t_e = res4[:, 3] * inv
    found = found & okd
    return {
        "t": jnp.where(found, t_e, jnp.inf),
        "tri": jnp.where(found, tri_g, -1),
        "u": jnp.where(found, u_e, 0.0),
        "v": jnp.where(found, v_e, 0.0),
        "occluded": found,
        "overflow": overflow,
    }


def intersect_closest(cs: ClusterSet, origins, dirs, t_min, t_max,
                      max_visits: int = 12, culling: str = "auto",
                      decode: bool = True, interpret: bool = False,
                      method: str = "kernel"):
    """Closest hit per ray. method="kernel" runs the Pallas visit kernel
    (`interpret=True` runs it on the CPU); method="scan" is the plain-XLA
    reference (`_scan_keys`) that tests and chip_smoke.py compare with."""
    return _query(cs, origins, dirs, t_min, t_max, max_visits, True, method,
                  culling, decode, interpret)


def intersect_any(cs: ClusterSet, origins, dirs, t_min, t_max,
                  max_visits: int = 12, culling: str = "auto",
                  interpret: bool = False, method: str = "kernel"):
    return _query(cs, origins, dirs, t_min, t_max, max_visits, False, method,
                  culling, True, interpret)["occluded"]


def tiled_intersectors(cs: ClusterSet, max_visits: int = 12,
                       culling: str = "auto", decode: bool = True,
                       interpret: bool = False) -> Tuple:
    """(intersect_fn, occlude_fn) on the Pallas visit kernel."""
    def isect(o, d, tn, tx):
        res = intersect_closest(cs, o, d, tn, tx, max_visits=max_visits,
                                culling=culling, decode=decode,
                                interpret=interpret)
        # overflow is surfaced: the wavefront loop ORs it into an AOV so
        # truncated visit lists are never silently dropped
        return {q: res[q] for q in ("t", "tri", "u", "v", "overflow")}

    def occl(o, d, tn, tx):
        return intersect_any(cs, o, d, tn, tx, max_visits=max_visits,
                             culling=culling, interpret=interpret)

    return isect, occl
