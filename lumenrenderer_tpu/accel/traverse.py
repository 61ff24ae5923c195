"""BVH traversal: batched stack-based traversal under vmap + while_loop.

JAX replacement for OptiX ray traversal (`optixLaunch` →
`__raygen__WaveFrontRG`, `Shaders/WaveFrontShaders.cu:42-112`). Instead of
per-thread SIMT traversal on RT cores, rays traverse in lockstep: the scalar
routine is `vmap`-ped over the ray batch and XLA compiles the `while_loop`
into one masked vector loop — every memory access becomes a batched gather.

The lockstep iteration count is the batch *max*, so tree quality (SAH,
`accel/sah.py`) and ordered near-first descent with best-t culling are the
dominant performance levers; leaf work is a fixed-shape vectorized
Möller–Trumbore over `leaf_size` slots.
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from ..core import vecmath as vm
from .format import BVH

BIG = jnp.float32(3.4e38)


def _aabb_t(lo, hi, o, inv_d, t_min, t_cap):
    """Slab test: returns (hit, t_near) for one AABB vs one ray."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tn = jnp.max(jnp.minimum(t0, t1))
    tf = jnp.min(jnp.maximum(t0, t1))
    hit = (tn <= tf) & (tf >= t_min) & (tn <= t_cap)
    return hit, jnp.maximum(tn, t_min)


def _mt_leaf(bvh: BVH, leaf: jnp.ndarray, o, d, t_min):
    """Möller–Trumbore over the leaf's triangles. Returns (t (L,), u, v, id)."""
    L = bvh.leaf_size
    base = leaf * L
    idx = base + jnp.arange(L, dtype=jnp.int32)
    p0 = bvh.tri_p0[idx]
    e1 = bvh.tri_e1[idx]
    e2 = bvh.tri_e2[idx]
    tid = bvh.tri_id[idx]
    pvec = jnp.cross(d[None, :], e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    ok = jnp.abs(det) > 1e-9
    inv = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    tvec = o[None, :] - p0
    u = jnp.sum(tvec * pvec, axis=-1) * inv
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d[None, :] * qvec, axis=-1) * inv
    t = jnp.sum(e2 * qvec, axis=-1) * inv
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min) & (tid >= 0)
    return jnp.where(hit, t, BIG), u, v, tid


def _traverse_scalar(bvh: BVH, o, d, t_min, t_max, any_hit: bool):
    """Single-ray traversal (vmapped by callers)."""
    max_stack = bvh.max_depth + 2
    inv_d = vm.safe_rcp(d)

    root_hit, _ = _aabb_t(bvh.node_lo[0], bvh.node_hi[0], o, inv_d, t_min, t_max)
    stack = jnp.zeros((max_stack,), jnp.int32)
    sp0 = jnp.where(root_hit, 1, 0).astype(jnp.int32)

    init = (
        sp0,
        stack,
        jnp.asarray(t_max, jnp.float32),  # best_t (cap)
        jnp.int32(-1),                    # best original tri id
        jnp.float32(0.0),                 # u
        jnp.float32(0.0),                 # v
    )

    def cond(state):
        sp, _, _, tri, _, _ = state
        alive = sp > 0
        if any_hit:
            alive = alive & (tri < 0)
        return alive

    def body(state):
        sp, stack, best_t, best_tri, bu, bv = state
        node = stack[sp - 1]
        sp = sp - 1
        c0 = bvh.child0[node]
        c1 = bvh.child1[node]
        is_leaf = c0 < 0

        # --- internal: test children, push near-last ---
        c0i = jnp.maximum(c0, 0)
        h0, tn0 = _aabb_t(bvh.node_lo[c0i], bvh.node_hi[c0i], o, inv_d, t_min, best_t)
        h1, tn1 = _aabb_t(bvh.node_lo[c1], bvh.node_hi[c1], o, inv_d, t_min, best_t)
        h0 = h0 & ~is_leaf
        h1 = h1 & ~is_leaf
        # near child should be popped first => push far first
        swap = tn1 < tn0
        near = jnp.where(swap, c1, c0i)
        far = jnp.where(swap, c0i, c1)
        h_near = jnp.where(swap, h1, h0)
        h_far = jnp.where(swap, h0, h1)
        stack = jnp.where(h_far, stack.at[sp].set(far), stack)
        sp_f = sp + h_far.astype(jnp.int32)
        stack = jnp.where(h_near, stack.at[sp_f].set(near), stack)
        sp = sp_f + h_near.astype(jnp.int32)

        # --- leaf: intersect triangles ---
        leaf = jnp.maximum(-c0 - 1, 0)
        t_l, u_l, v_l, id_l = _mt_leaf(bvh, leaf, o, d, t_min)
        t_l = jnp.where(is_leaf, t_l, BIG)
        k = jnp.argmin(t_l)
        t_k = t_l[k]
        better = t_k < best_t
        best_tri = jnp.where(better, id_l[k], best_tri)
        bu = jnp.where(better, u_l[k], bu)
        bv = jnp.where(better, v_l[k], bv)
        best_t = jnp.where(better, t_k, best_t)
        return sp, stack, best_t, best_tri, bu, bv

    sp, stack, t, tri, u, v = jax.lax.while_loop(cond, body, init)
    t = jnp.where(tri >= 0, t, jnp.inf)
    return t, tri, u, v


@jax.jit
def intersect_closest(bvh: BVH, origins, dirs, t_min, t_max):
    """Closest-hit batch query; same contract as `accel.brute.intersect_closest`."""
    r = origins.shape[0]
    t_min_b = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (r,))
    t_max_b = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (r,))
    t, tri, u, v = jax.vmap(
        lambda o, d, tn, tx: _traverse_scalar(bvh, o, d, tn, tx, any_hit=False)
    )(origins, dirs, t_min_b, t_max_b)
    return {"t": t, "tri": tri, "u": u, "v": v}


@jax.jit
def intersect_any(bvh: BVH, origins, dirs, t_min, t_max):
    """Occlusion batch query (early-out on first hit)."""
    r = origins.shape[0]
    t_min_b = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (r,))
    t_max_b = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (r,))
    _, tri, _, _ = jax.vmap(
        lambda o, d, tn, tx: _traverse_scalar(bvh, o, d, tn, tx, any_hit=True)
    )(origins, dirs, t_min_b, t_max_b)
    return tri >= 0


def bvh_intersectors(bvh: BVH) -> Tuple:
    """Bind a BVH into (intersect_fn, occlude_fn) for the wavefront loop."""
    return (
        partial(intersect_closest, bvh),
        partial(intersect_any, bvh),
    )
