"""Two-level TLAS/BLAS instancing for the tiled intersector (round 5).

JAX equivalent of the reference's per-primitive GAS + top-level IAS
(`Framework/WaveFrontRenderer.cpp:1148-1252` builds one GAS per primitive;
`Framework/PTScene.cpp:77-160` + `Framework/OptixWrapper.cpp:80-131` rebuild
the IAS over instances on dirty): geometry lives ONCE per unique mesh in
OBJECT space — SAH clusters + Möller–Trumbore coefficient features — and
instances are a transform table. Device memory scales with unique meshes,
not instances (the flattened path stores instances × triangles
copies).

Mapping to the tiled-stream architecture:

- BLAS ≙ per-mesh `ClusterSet` (object space), concatenated into one global
  cluster table (`cluster_of mesh m` ids are offset by `mesh_cluster_base`).
- TLAS leaf ≙ a (instance, cluster) UNIT: its world-space AABB is the
  instance-transformed object cluster AABB. The tile-granular culling
  (dense/frustum/packet-tree, shared with accel/tiled.py via duck-typed
  `aabb_lo/aabb_hi/tree_*` fields) runs over units.
- "Rays transform into instance space at the TLAS leaf"
  (≙ OptiX transforming rays per IAS instance): each visit applies the
  unit's world→object 3x4 to the ray. The affine preserves the ray's WORLD
  t parameter (X_o = Minv·o + t·Minv·d with d at world unit length), so the
  per-ray [t_min, t_max] window, the packed-key ordering, and the visit
  early-out all work in world t exactly like the single-level kernel.
  (Scaling d by the window span was tried and rejected: it multiplies the
  Möller–Trumbore cancellation error by the span — 45 wrong hits of ~400
  at span ~25 on a 4k-ray test.)

The winner decodes to a VIRTUAL flattened triangle id
(`inst_tri_base[i] + mesh-local id`), which indexes the flattened SceneData
attribute tables directly — instancing changes only the accel, shading is
untouched, and images match the flattened build bit-for-near.

Dynamic scenes: `refit_instances` updates transforms/unit boxes in O(units)
on device — no triangle re-transform (≙ the IAS-only rebuild the reference
does per dirty frame).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import struct
from .stream import ClusterSet, build_clusters
from .tiled import (KEY_MISS, RAY_TILE, _frustum_visits, _pad,
                    _tile_tree_visits)


@struct.dataclass
class InstancedClusterSet:
    """Two-level accel: global cluster table (object space) + instance/unit
    tables. Duck-types the ClusterSet fields the tile-culling reads
    (aabb_lo/aabb_hi = UNIT world boxes; tree_* spans units)."""

    # unit (TLAS leaf) tables — one unit per (instance, cluster)
    aabb_lo: jnp.ndarray        # (V,3) world-space unit AABBs
    aabb_hi: jnp.ndarray        # (V,3)
    unit_inst: jnp.ndarray      # (V,) int32 instance id
    unit_cluster: jnp.ndarray   # (V,) int32 GLOBAL cluster id
    # BLAS: concatenated per-mesh cluster tables (object space)
    tri_feat: jnp.ndarray       # (C,10,4K) MT coefficients, object space
    tri_id: jnp.ndarray         # (C,K) mesh-LOCAL triangle ids (-1 pad)
    obj_lo: jnp.ndarray         # (C,3) object-space cluster AABBs (refit)
    obj_hi: jnp.ndarray         # (C,3)
    # instances
    inst_minv: jnp.ndarray      # (I,3,4) world -> object affine
    inst_tri_base: jnp.ndarray  # (I,) int32 virtual-tri base offset
    inst_cluster_base: jnp.ndarray  # (I,) int32 global-cluster base of mesh
    # unit tree (TLAS internal nodes; same shape contract as ClusterSet)
    tree_lo: jnp.ndarray
    tree_hi: jnp.ndarray
    tree_child0: jnp.ndarray
    tree_child1: jnp.ndarray
    tree_leaf_cluster: jnp.ndarray  # (V,) leaf -> unit id
    tris_per_cluster: int = struct.field(static=True)
    tree_depth: int = struct.field(static=True)

    @property
    def num_clusters(self) -> int:
        # culling-facing count = number of UNITS
        return self.aabb_lo.shape[0]

    @property
    def num_instances(self) -> int:
        return self.inst_minv.shape[0]


def _transform_boxes(lo, hi, mat4):
    """World AABBs of object boxes under an affine (8-corner method)."""
    corners = jnp.stack([
        jnp.stack([
            jnp.where(jnp.asarray([(i >> a) & 1 for a in range(3)], bool),
                      hi, lo) for i in range(8)
        ], axis=0)  # (8, C, 3)
    ], axis=0)[0]
    rot = mat4[:3, :3]
    trn = mat4[:3, 3]
    w = jnp.einsum("ij,kcj->kci", rot, corners,
                   precision=jax.lax.Precision.HIGHEST) + trn
    return jnp.min(w, axis=0), jnp.max(w, axis=0)


def build_instanced(meshes: Sequence[np.ndarray],
                    inst_mesh: Sequence[int],
                    inst_transform: Sequence[np.ndarray],
                    cluster_size: int = 128) -> InstancedClusterSet:
    """meshes: per unique mesh (T_m,3,3) OBJECT-space triangles.
    inst_mesh: per instance mesh index. inst_transform: per instance 4x4
    object->world. Cluster build happens ONCE per unique mesh
    (≙ one GAS per primitive, WaveFrontRenderer.cpp:1148-1252)."""
    sets: List[ClusterSet] = [
        build_clusters(np.asarray(m, np.float32), cluster_size=cluster_size)
        for m in meshes
    ]
    k = cluster_size
    mesh_cluster_base = np.cumsum([0] + [s.num_clusters for s in sets])[:-1]
    mesh_tris = [np.asarray(m).shape[0] for m in meshes]
    feats = jnp.concatenate([s.tri_feat for s in sets], axis=0)
    tri_id = jnp.concatenate([s.tri_id for s in sets], axis=0)
    obj_lo = jnp.concatenate([s.aabb_lo for s in sets], axis=0)
    obj_hi = jnp.concatenate([s.aabb_hi for s in sets], axis=0)

    inst_mesh = np.asarray(inst_mesh, np.int32)
    n_inst = inst_mesh.shape[0]
    mats = np.stack([np.asarray(t, np.float32).reshape(4, 4)
                     for t in inst_transform])
    minv = np.zeros((n_inst, 3, 4), np.float32)
    tri_base = np.zeros((n_inst,), np.int32)
    cl_base = np.zeros((n_inst,), np.int32)
    units_lo, units_hi, u_inst, u_cluster = [], [], [], []
    base = 0
    for i in range(n_inst):
        m = int(inst_mesh[i])
        inv = np.linalg.inv(mats[i])
        minv[i] = inv[:3, :4]
        tri_base[i] = base
        base += mesh_tris[m]
        cl_base[i] = mesh_cluster_base[m]
        s = sets[m]
        lo_w, hi_w = _transform_boxes(s.aabb_lo, s.aabb_hi,
                                      jnp.asarray(mats[i]))
        units_lo.append(np.asarray(lo_w))
        units_hi.append(np.asarray(hi_w))
        c = s.num_clusters
        u_inst.append(np.full((c,), i, np.int32))
        u_cluster.append(
            np.arange(c, dtype=np.int32) + mesh_cluster_base[m])
    v_lo = np.concatenate(units_lo, axis=0)
    v_hi = np.concatenate(units_hi, axis=0)

    from .sah import build_sah_boxes

    tlo, thi, tc0, tc1, torder, tdepth = build_sah_boxes(
        v_lo, v_hi, leaf_size=1)
    return InstancedClusterSet(
        aabb_lo=jnp.asarray(v_lo, jnp.float32),
        aabb_hi=jnp.asarray(v_hi, jnp.float32),
        unit_inst=jnp.asarray(np.concatenate(u_inst)),
        unit_cluster=jnp.asarray(np.concatenate(u_cluster)),
        tri_feat=feats,
        tri_id=tri_id,
        obj_lo=obj_lo,
        obj_hi=obj_hi,
        inst_minv=jnp.asarray(minv),
        inst_tri_base=jnp.asarray(tri_base),
        inst_cluster_base=jnp.asarray(cl_base),
        tree_lo=jnp.asarray(tlo, jnp.float32),
        tree_hi=jnp.asarray(thi, jnp.float32),
        tree_child0=jnp.asarray(tc0),
        tree_child1=jnp.asarray(tc1),
        tree_leaf_cluster=jnp.asarray(torder.astype(np.int32)),
        tris_per_cluster=k,
        tree_depth=tdepth,
    )


def refit_instances(ics: InstancedClusterSet,
                    transforms: jnp.ndarray) -> InstancedClusterSet:
    """Device refit for dynamic scenes: new (I,4,4) object->world transforms
    → new inst_minv + unit world boxes. O(units) — no triangle work
    (≙ PTScene.cpp:77-160 rebuilding only the IAS on dirty). The unit tree
    is refit conservatively (every node = global bounds), like
    stream.refit_clusters."""
    rot = transforms[:, :3, :3]
    minv = jnp.linalg.inv(transforms)[:, :3, :4]
    # unit boxes: transform each unit's object cluster box by its instance
    cl = ics.unit_cluster
    inst = ics.unit_inst
    lo_o = ics.obj_lo[cl]
    hi_o = ics.obj_hi[cl]
    m = transforms[inst]                       # (V,4,4)
    corners = jnp.stack([
        jnp.where(jnp.asarray([(i >> a) & 1 for a in range(3)], bool),
                  hi_o, lo_o) for i in range(8)
    ], axis=0)                                  # (8,V,3)
    w = jnp.einsum("vij,kvj->kvi", m[:, :3, :3], corners,
                   precision=jax.lax.Precision.HIGHEST) + m[:, :3, 3]
    v_lo = jnp.min(w, axis=0)
    v_hi = jnp.max(w, axis=0)
    glo = jnp.min(v_lo, axis=0)
    ghi = jnp.max(v_hi, axis=0)
    return ics.replace(
        aabb_lo=v_lo, aabb_hi=v_hi, inst_minv=minv,
        tree_lo=jnp.broadcast_to(glo, ics.tree_lo.shape),
        tree_hi=jnp.broadcast_to(ghi, ics.tree_hi.shape),
    )


@partial(jax.jit, static_argnames=("max_visits", "closest", "precision",
                                   "culling", "decode"))
def _query(ics: InstancedClusterSet, origins, dirs, t_min, t_max,
           max_visits: int, closest: bool, precision: str = "high",
           culling: str = "auto", decode: bool = True):
    r = origins.shape[0]
    t_min_b = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (r,))
    t_max_b = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (r,))
    r_pad = (-r) % RAY_TILE
    o = _pad(origins, r_pad, 0.0)
    d = _pad(dirs, r_pad, 1.0)
    tn = _pad(t_min_b, r_pad, 0.0)
    tx = _pad(t_max_b, r_pad, -1.0)
    tiles = (r + r_pad) // RAY_TILE
    v = ics.num_clusters                       # units
    k = ics.tris_per_cluster
    mv = min(max_visits, v)

    if culling == "auto":
        culling = "frustum" if v <= 2048 else "tree"
    if culling == "frustum":
        sel, valid_k, tnear_k, overflow = _frustum_visits(
            ics, o, d, tn, tx, tiles, mv)
    else:
        sel, valid_k, tnear_k, overflow = _tile_tree_visits(
            ics, o, d, tn, tx, tiles, mv)
    sel = sel.astype(jnp.int32)

    # The affine world->object map preserves the ray's world t parameter
    # (X_o = Minv·o + t·(Minv·d)), so the object-space hit parameter IS the
    # world t and the per-ray [tn, tx] window applies unchanged. Keep d at
    # world unit length: an earlier segment formulation scaled d by the
    # window span, which multiplied the MT bilinear form's cancellation
    # error by the span (measured 23 missed + 22 phantom hits of ~400).
    o2 = o
    d2 = d

    k_bits = max((k - 1).bit_length(), 1)
    s_bits = max((mv - 1).bit_length(), 1)
    low_bits = k_bits + s_bits
    assert low_bits <= 15, f"packed-key layout overflow: {k=} {mv=}"
    low_mask = jnp.int32(~((1 << low_bits) - 1))

    o2_t = o2.reshape(tiles, RAY_TILE, 3)
    d2_t = d2.reshape(tiles, RAY_TILE, 3)
    tn_t = tn.reshape(tiles, RAY_TILE)
    tx_t = tx.reshape(tiles, RAY_TILE)
    k_ids = jax.lax.broadcasted_iota(jnp.int32, (1, 1, k), 2)
    step_ids = jnp.arange(mv, dtype=jnp.int32)

    def step(carry, inputs):
        best_key, occ = carry
        s_unit, ok_k, step_i = inputs            # (T,), (T,), ()
        inst = ics.unit_inst[s_unit]             # (T,)
        cl = ics.unit_cluster[s_unit]
        mv12 = ics.inst_minv[inst]               # (T,3,4)
        rot = mv12[:, :, :3]
        trn = mv12[:, :, 3]
        # HIGHEST: a reduced-precision matmul default (bf16 or TF32)
        # rounds the ray origin (|Minv·o| ~ 30) enough to move hits by
        # ~0.1 world units (43 wrong hits of ~420 on the instanced soup
        # test at bf16 operand rounding)
        oo = jnp.einsum("tij,trj->tri", rot, o2_t,
                        precision=jax.lax.Precision.HIGHEST
                        ) + trn[:, None, :]
        dd = jnp.einsum("tij,trj->tri", rot, d2_t,
                        precision=jax.lax.Precision.HIGHEST)
        m = jnp.cross(oo, dd)
        rf = jnp.concatenate(
            [m, dd, oo, jnp.ones(oo.shape[:-1] + (1,), jnp.float32)],
            axis=-1)                              # (T,128,10)
        feats = ics.tri_feat[cl]                 # (T,10,4K)
        res = jnp.einsum(
            "trf,tfc->trc", rf, feats, preferred_element_type=jnp.float32,
            precision=(jax.lax.Precision.HIGHEST
                       if precision != "default"
                       else jax.lax.Precision.DEFAULT))
        det = res[..., 0 * k:1 * k]
        okd = jnp.abs(det) > 1e-12
        inv = jnp.where(okd, 1.0 / jnp.where(okd, det, 1.0), 0.0)
        u = res[..., 1 * k:2 * k] * inv
        vv = res[..., 2 * k:3 * k] * inv
        s = res[..., 3 * k:4 * k] * inv
        tid = ics.tri_id[cl]
        hit = (okd & (u >= 0.0) & (vv >= 0.0) & (u + vv <= 1.0)
               & (s > tn_t[..., None]) & (s <= tx_t[..., None])
               & (tid[:, None, :] >= 0) & ok_k[:, None, None])
        if closest:
            sb = jax.lax.bitcast_convert_type(
                jnp.maximum(s, 0.0), jnp.int32)
            key = (sb & low_mask) | (step_i << k_bits) | k_ids
            key = jnp.where(hit, key, jnp.int32(KEY_MISS))
            best_key = jnp.minimum(best_key, jnp.min(key, axis=-1))
        occ = occ | jnp.any(hit, axis=-1)
        return (best_key, occ), None

    init = (jnp.full((tiles, RAY_TILE), KEY_MISS, jnp.int32),
            jnp.zeros((tiles, RAY_TILE), bool))
    (best_key, occ), _ = jax.lax.scan(
        step, init, (sel.T, valid_k.T, step_ids))
    if not closest:
        return {
            "t": jnp.full((r,), jnp.inf),
            "tri": jnp.full((r,), -1, jnp.int32),
            "u": jnp.zeros((r,)),
            "v": jnp.zeros((r,)),
            "occluded": occ.reshape(-1)[:r] & (t_max_b >= t_min_b),
            "overflow": overflow,
        }

    flat = lambda a: a.reshape(-1)[:r]
    bk = flat(best_key)
    found = bk < KEY_MISS
    k_win = bk & ((1 << k_bits) - 1)
    step_win = (bk >> k_bits) & ((1 << s_bits) - 1)
    tile_idx = jnp.arange(r, dtype=jnp.int32) // RAY_TILE
    unit = sel[tile_idx, step_win]
    inst_w = ics.unit_inst[jnp.maximum(unit, 0)]
    cl_w = ics.unit_cluster[jnp.maximum(unit, 0)]
    tri_local = ics.tri_id[cl_w, k_win]
    tri_virtual = ics.inst_tri_base[inst_w] + tri_local
    # the key's high bits ARE the (quantized) world-t float bits
    t_key = jax.lax.bitcast_convert_type(bk & low_mask, jnp.float32)
    return {
        # decode=False contract (production): exact t/u/v re-derived by
        # extract_surface_data from the virtual tri id; t here is the
        # quantized key distance (accel/tiled.py decode=False semantics)
        "t": jnp.where(found, t_key, jnp.inf),
        "tri": jnp.where(found, tri_virtual, -1),
        "u": jnp.zeros((r,)),
        "v": jnp.zeros((r,)),
        "occluded": found,
        "overflow": overflow,
    }


def instanced_intersectors(ics: InstancedClusterSet, max_visits: int = 128,
                           precision: str = "high",
                           culling: str = "auto") -> Tuple:
    """(intersect_fn, occlude_fn) over the two-level structure — same
    contract as accel/tiled.py:tiled_intersectors (decode=False style)."""

    def isect(o, d, tn, tx):
        res = _query(ics, o, d, tn, tx, max_visits, True, precision, culling,
                     decode=False)
        return {q: res[q] for q in ("t", "tri", "u", "v", "overflow")}

    def occl(o, d, tn, tx):
        return _query(ics, o, d, tn, tx, max_visits, False, precision,
                      culling, decode=False)["occluded"]

    return isect, occl
