"""Host-side binned-SAH BVH builder (numpy; C++ fast path optional).

Design decision: for *static* scenes the BVH is built once on the
host at scene load (like the reference builds its GAS at `CreatePrimitive`
time, `Framework/WaveFrontRenderer.cpp:1148-1252`) — so build cost is off the
frame path and tree *quality* is what matters: batched traversal is a
lockstep loop whose iteration count is the per-batch max, so SAH's lower
worst-case node counts translate directly into frame time. The device-side Morton LBVH
(`accel/lbvh.py`) remains for dynamically deforming geometry.

Binned SAH (16 bins, largest centroid axis, fallback to object median) with
iterative DFS; nodes are emitted in DFS order (child0 = node+1, good for
near-first descent cache locality). If the native extension
(`lumenrenderer_tpu.native`) is built, the hot loop runs in C++.
"""
from __future__ import annotations

import numpy as np

from .format import BVH

_NBINS = 16


def build_sah_arrays(tri_pos: np.ndarray, leaf_size: int = 4):
    """Pure-numpy binned SAH over triangles. Returns (node_lo, node_hi,
    child0, child1, order (S,), max_depth) where order holds original tri
    ids per leaf slot (-1 padding) and child0<0 encodes leaf index."""
    return build_sah_boxes(
        tri_pos.min(axis=1), tri_pos.max(axis=1), leaf_size
    )


def build_sah_boxes(lo_t: np.ndarray, hi_t: np.ndarray, leaf_size: int = 4):
    """Binned SAH over arbitrary AABBs (used for the triangle BVH and for
    the second-level tree over pair-stream clusters)."""
    t = lo_t.shape[0]
    cent = 0.5 * (lo_t + hi_t)

    node_lo, node_hi, child0, child1 = [], [], [], []
    leaf_slots = []  # list of arrays of tri ids (padded later)
    max_depth = [1]

    # iterative DFS; each stack entry: (tri index array, depth, parent slot to fix)
    root_idx = np.arange(t)

    def new_node():
        node_lo.append(None)
        node_hi.append(None)
        child0.append(0)
        child1.append(0)
        return len(child0) - 1

    stack = [(root_idx, 1, None, 0)]  # (idx, depth, parent, which_child)
    while stack:
        idx, depth, parent, which = stack.pop()
        ni = new_node()
        if parent is not None:
            if which == 0:
                child0[parent] = ni
            else:
                child1[parent] = ni
        max_depth[0] = max(max_depth[0], depth)
        blo = lo_t[idx].min(axis=0)
        bhi = hi_t[idx].max(axis=0)
        node_lo[ni] = blo
        node_hi[ni] = bhi
        n = idx.shape[0]
        if n <= leaf_size:
            child0[ni] = -(len(leaf_slots) + 1)
            leaf_slots.append(idx)
            continue
        # --- binned SAH on largest centroid-extent axis ---
        c = cent[idx]
        clo = c.min(axis=0)
        chi = c.max(axis=0)
        ext = chi - clo
        axis = int(np.argmax(ext))
        split_done = False
        if ext[axis] > 1e-12:
            scale = _NBINS * (1.0 - 1e-6) / ext[axis]
            bins = ((c[:, axis] - clo[axis]) * scale).astype(np.int32)
            # bin bounds + counts
            counts = np.bincount(bins, minlength=_NBINS)
            binlo = np.full((_NBINS, 3), np.inf)
            binhi = np.full((_NBINS, 3), -np.inf)
            for b in range(_NBINS):
                m = bins == b
                if counts[b]:
                    binlo[b] = lo_t[idx][m].min(axis=0)
                    binhi[b] = hi_t[idx][m].max(axis=0)
            # prefix/suffix areas
            def areas(los, his):
                d = np.maximum(his - los, 0.0)
                return 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 0] * d[:, 2])

            pl = np.minimum.accumulate(binlo, axis=0)
            ph = np.maximum.accumulate(binhi, axis=0)
            sl = np.minimum.accumulate(binlo[::-1], axis=0)[::-1]
            sh = np.maximum.accumulate(binhi[::-1], axis=0)[::-1]
            cl = np.cumsum(counts)
            cr = n - cl
            cost = np.full(_NBINS - 1, np.inf)
            for b in range(_NBINS - 1):
                if cl[b] > 0 and cr[b] > 0:
                    cost[b] = areas(pl[b : b + 1], ph[b : b + 1])[0] * cl[b] + areas(
                        sl[b + 1 : b + 2], sh[b + 1 : b + 2]
                    )[0] * cr[b]
            best = int(np.argmin(cost))
            if np.isfinite(cost[best]):
                left_mask = bins <= best
                li, ri = idx[left_mask], idx[~left_mask]
                if len(li) and len(ri):
                    split_done = True
        if not split_done:
            # object median fallback
            srt = idx[np.argsort(cent[idx, axis], kind="stable")]
            mid = n // 2
            li, ri = srt[:mid], srt[mid:]
        # push right first so left (= node+1 in DFS order) pops next
        stack.append((ri, depth + 1, ni, 1))
        stack.append((li, depth + 1, ni, 0))

    # pack leaves into fixed slots
    nl = len(leaf_slots)
    order = np.full((nl * leaf_size,), -1, np.int64)
    for i, s in enumerate(leaf_slots):
        order[i * leaf_size : i * leaf_size + len(s)] = s
    return (
        np.asarray(node_lo, np.float32),
        np.asarray(node_hi, np.float32),
        np.asarray(child0, np.int32),
        np.asarray(child1, np.int32),
        order,
        int(max_depth[0]),
    )


_native_missing_logged = False


def build_sah_fast(tri_pos: np.ndarray, leaf_size: int):
    """`build_sah_arrays` through the native builder (`make -C native`) when
    it is built, else the numpy one; logs which ran."""
    global _native_missing_logged
    from ..utils import log as log_mod

    try:
        from ..native import bvh_native

        out = bvh_native.build_sah(tri_pos, leaf_size)
    except (ImportError, OSError) as e:
        if not _native_missing_logged:
            log_mod.core().warning(
                "native SAH builder unavailable (%s); using the numpy "
                "builder", e)
            _native_missing_logged = True
        return build_sah_arrays(tri_pos, leaf_size)
    log_mod.core().info("SAH build: native builder, %d triangles",
                        tri_pos.shape[0])
    return out


def build_sah(tri_pos_jnp, leaf_size: int = 4) -> BVH:
    """Build a binned-SAH BVH from (T,3,3) triangles (device or numpy)."""
    import jax.numpy as jnp

    tri_pos = np.asarray(tri_pos_jnp, np.float32)
    nlo, nhi, c0, c1, order, md = build_sah_fast(tri_pos, leaf_size)
    valid = order >= 0
    gat = np.maximum(order, 0)
    p = tri_pos[gat]
    p0 = np.where(valid[:, None], p[:, 0], np.inf).astype(np.float32)
    e1 = np.where(valid[:, None], p[:, 1] - p[:, 0], 0.0).astype(np.float32)
    e2 = np.where(valid[:, None], p[:, 2] - p[:, 0], 0.0).astype(np.float32)
    return BVH(
        node_lo=jnp.asarray(nlo),
        node_hi=jnp.asarray(nhi),
        child0=jnp.asarray(c0),
        child1=jnp.asarray(c1),
        tri_p0=jnp.asarray(p0),
        tri_e1=jnp.asarray(e1),
        tri_e2=jnp.asarray(e2),
        tri_id=jnp.asarray(order.astype(np.int32)),
        leaf_size=leaf_size,
        max_depth=md,
    )
