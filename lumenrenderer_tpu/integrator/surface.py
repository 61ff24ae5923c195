"""Hit → SurfaceData extraction.

JAX equivalent of `ExtractSurfaceDataGpu`
(`CUDAKernels/WaveFrontKernels/GPUExtractSurfaceData.cu:8-228`): barycentric
interpolation of normal/tangent/UV, normal mapping, emissive flags and Disney
parameter texture modulation — as batched gathers + VPU math instead of a
per-ray CUDA kernel. The `SurfaceData` struct mirrors
`Shaders/CppCommon/WaveFrontDataStructs/SurfaceData.h:18-108`.
"""
from __future__ import annotations

import chex
import jax
import jax.numpy as jnp

from ..core import vecmath as vm
from ..scene.scene import SceneData
from ..scene.textures import sample_bilinear, sample_trilinear


@chex.dataclass(frozen=True)
class SurfaceData:
    """Per-ray shading inputs (all (R,...) batched)."""

    position: jnp.ndarray      # (R,3) world hit position
    normal: jnp.ndarray        # (R,3) shading normal (normal-mapped, faceted fallback)
    geo_normal: jnp.ndarray    # (R,3) geometric normal
    uv: jnp.ndarray            # (R,2)
    base_color: jnp.ndarray    # (R,3) textured albedo
    emissive: jnp.ndarray      # (R,3) textured emissive radiance
    metallic: jnp.ndarray      # (R,)
    roughness: jnp.ndarray     # (R,)
    alpha: jnp.ndarray         # (R,) opacity from base-color texture alpha
    mat_idx: jnp.ndarray       # (R,) int32
    mat_rows: jnp.ndarray      # (R,25) packed material params (one gather)
    light_row: jnp.ndarray     # (R,) int32 tri->light row (-1 = not a light)
    tri_idx: jnp.ndarray       # (R,) int32 (-1 = miss)
    tangent: jnp.ndarray       # (R,3) world UV-aligned tangent (anisotropy axis)
    t: jnp.ndarray             # (R,) exact hit distance (inf on miss)
    valid: jnp.ndarray         # (R,) bool hit mask
    is_emissive: jnp.ndarray   # (R,) bool (≙ SurfaceFlags::EMISSIVE)
    front_face: jnp.ndarray    # (R,) bool — ray hit the front side (for IOR)


def _attr_table(scene: SceneData, with_uv: bool = True,
                with_tangent: bool = True):
    """Per-triangle flat attribute table + its column map: geometric normal,
    vertex normals, (optionally) UVs and tangents, packed material row,
    instance emission override, and the triangle vertices for exact-hit
    re-derivation.

    Built from the SoA scene pytree ONCE per frame (pure elementwise ops over
    N + two N-row gathers); the per-RAY access in `extract_surface_data` is
    then ONE row gather. Without this, per-attribute (R,3,3)-shaped gathers
    get (4,128)-tiled layouts — a measured 57x HBM padding expansion (7 GB at
    1440p) plus 4x the fixed gather cost. Differentiable: the material block
    is a gather of `materials.packed()`, so pixel gradients flow to params.

    Round 4: uv/tangent/lod columns (19 of ~68) are skipped when the caller
    can prove them unused (untextured scene, no normal maps, no anisotropy) —
    extract runs every depth, and the per-row gather cost is linear in row
    width (measured 105 ms/depth at 1440p with the full table).

    Returns (table (N, C), cols {name: (start, stop)}).
    """
    n = scene.tri_pos.shape[0]
    p0 = scene.tri_pos[:, 0]
    e1 = scene.tri_pos[:, 1] - p0
    e2 = scene.tri_pos[:, 2] - p0
    geo_n = vm.normalize(jnp.cross(e1, e2))
    mode = scene.inst_emission_mode[scene.tri_inst]
    override = scene.inst_emission_override[scene.tri_inst]
    parts, cols = [], {}
    cursor = 0

    def add(name, arr):
        nonlocal cursor
        parts.append(arr)
        cols[name] = (cursor, cursor + arr.shape[1])
        cursor += arr.shape[1]

    add("geo_n", geo_n)
    add("normals", scene.tri_normal.reshape(n, 9))
    if with_uv:
        add("uv", scene.tri_uv.reshape(n, 6))
    if with_tangent:
        add("tangent", scene.tri_tangent.reshape(n, 12))
    add("material", scene.materials.packed()[scene.tri_mat])
    add("em_mode", mode[:, None].astype(jnp.float32))
    add("em_override", override)
    add("mat_idx", scene.tri_mat[:, None].astype(jnp.float32))  # exact <2^24
    # tri->light inverse row (for MIS light pdf) rides the same gather — a
    # separate (R,) int gather measured 37 ms at 1440p
    add("light_row", scene.lights.tri_to_light[:, None].astype(jnp.float32))
    # triangle vertices (p0,e1,e2): exact t/u/v are re-derived in extract via
    # elementwise Moller-Trumbore instead of a second per-ray (R,10,4)
    # coefficient gather + einsum (measured 59 ms/call + ~590 MB at 1440p)
    add("p0", p0)
    add("e1", e1)
    add("e2", e2)
    if with_uv:
        # mip LOD base: 0.5*log2(A_uv/A_world) per triangle (texels per
        # world length enters at sample time per texture)
        add("lod", _lod_base(scene)[:, None])
    return jnp.concatenate(parts, axis=1), cols


def _lod_base(scene: SceneData) -> jnp.ndarray:
    """Per-triangle 0.5*log2(UV area / world area): the triangle's UV density
    term of the ray-footprint mip LOD (texture W*H enters per texture)."""
    e1 = scene.tri_pos[:, 1] - scene.tri_pos[:, 0]
    e2 = scene.tri_pos[:, 2] - scene.tri_pos[:, 0]
    a_world = 0.5 * jnp.linalg.norm(jnp.cross(e1, e2), axis=-1)
    duv1 = scene.tri_uv[:, 1] - scene.tri_uv[:, 0]
    duv2 = scene.tri_uv[:, 2] - scene.tri_uv[:, 0]
    a_uv = 0.5 * jnp.abs(duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0])
    return 0.5 * jnp.log2(
        jnp.maximum(a_uv, 1e-20) / jnp.maximum(a_world, 1e-20)
    )


def extract_surface_data(
    scene: SceneData,
    ray_o: jnp.ndarray,
    ray_d: jnp.ndarray,
    hit_t: jnp.ndarray,
    hit_tri: jnp.ndarray,
    hit_u: jnp.ndarray,
    hit_v: jnp.ndarray,
    mip_spread=None,
    mip_dist0=None,
    detach_geom: bool = False,
    with_tangent: bool = True,
) -> SurfaceData:
    """mip_spread/mip_dist0: optional ray-footprint mip selection (≙ the
    reference's mipmapped texture sampling, `PTTexture.cpp:64-65`):
    footprint at the hit = mip_spread * (mip_dist0 + t) / sqrt(|cos|), where
    mip_spread is the per-ray angular pixel spread (scalar ok) and mip_dist0
    the path distance accumulated before this segment. When omitted, texture
    lookups are level-0 bilinear (pre-round-4 behavior).

    NOTE: the passed-in hit_t/hit_u/hit_v are intentionally IGNORED — exact
    t/u/v are re-derived below from the winner triangle's vertices (fused into
    the attr-table gather). Intersectors only need to supply a correct
    `hit_tri`; quantized t / zero u,v from the tiled fast path are fine.

    with_tangent: pass False when the caller can prove tangents unused (no
    normal maps, no anisotropy): skips 12 gather columns + the interpolation
    (extract runs every depth; row width is the gather cost)."""
    valid = hit_tri >= 0
    tri = jnp.maximum(hit_tri, 0)

    # static fast path: a trivial atlas (only the builtin white texel) means
    # no material references any texture — skip uv/lod columns + sampling
    has_textures = scene.textures.count > 1
    table, col = _attr_table(scene, with_uv=has_textures,
                             with_tangent=with_tangent)
    att = table[tri]                 # (R, C) — THE per-ray gather
    # Barrier: many downstream fusions consume `att`; without it XLA
    # duplicates the (R,~66) gather into each consumer fusion (measured 4x
    # the gather cost at 1440p). One materialization, then cheap slices.
    att = jax.lax.optimization_barrier(att)

    def c(name, lo=0, hi=None):
        s0, s1 = col[name]
        return att[:, s0 + lo: (s1 if hi is None else s0 + hi)]

    # Exact t/u/v via elementwise Moller-Trumbore on the gathered vertices:
    # the tiled intersector's packed winner key only resolves t to
    # ~2^-(23-low_bits) relative and carries no u/v (≙ the reference gets
    # exact hit attribs from OptiX per-hit registers). Recomputing here is
    # fused VPU math on the already-gathered attr row — no extra gather —
    # and is exact f32 for every accel backend (brute/bvh pass-ins match).
    p0 = c("p0")
    e1 = c("e1")
    e2 = c("e2")
    pvec = jnp.cross(ray_d, e2)
    det = vm.dot(e1, pvec)
    okd = jnp.abs(det) > 1e-14
    inv_det = jnp.where(okd, 1.0 / jnp.where(okd, det, 1.0), 0.0)
    tvec = ray_o - p0
    qvec = jnp.cross(tvec, e1)
    hit_u = vm.dot(tvec, pvec) * inv_det
    hit_v = vm.dot(ray_d, qvec) * inv_det
    t_exact = vm.dot(e2, qvec) * inv_det
    if detach_geom:
        # detached-sampling discipline (ADVICE r3): inv_det reaches ~1e14
        # near the det guard — keep geometry-chain gradients (via uv/lod
        # into texture lookups) out of reverse mode entirely
        hit_u = jax.lax.stop_gradient(hit_u)
        hit_v = jax.lax.stop_gradient(hit_v)
        t_exact = jax.lax.stop_gradient(t_exact)
    valid = valid & okd
    hit_t = jnp.where(valid, t_exact, jnp.inf)
    # miss/dead lanes were clamped to tri 0 for the gather: their recomputed
    # barycentrics are against an unrelated triangle and can reach ~1e17 near
    # the det guard — inf texture weights then 0*inf NaNs that permanently
    # poison the accumulator (ADVICE r3). Mask them like t.
    hit_u = jnp.where(valid, hit_u, 0.0)
    hit_v = jnp.where(valid, hit_v, 0.0)

    w = (1.0 - hit_u - hit_v)[..., None]
    u_ = hit_u[..., None]
    v_ = hit_v[..., None]
    # position from ray equation (more robust than barycentric for grazing t).
    # Sanitize t on miss lanes (t=inf) — inf*0 NaNs would otherwise poison
    # both downstream values and reverse-mode cotangents.
    t_safe = jnp.where(valid, hit_t, 1.0)
    position = ray_o + t_safe[..., None] * ray_d
    # column-sliced barycentric interp: avoids rank-3 (R,3,3) reshapes
    # with tiny minor dims
    normal = vm.normalize(
        w * c("normals", 0, 3) + u_ * c("normals", 3, 6)
        + v_ * c("normals", 6, 9))
    if has_textures:
        uv = w * c("uv", 0, 2) + u_ * c("uv", 2, 4) + v_ * c("uv", 4, 6)
    else:
        uv = jnp.zeros(hit_t.shape + (2,), jnp.float32)
    geo_normal = c("geo_n")
    if with_tangent:
        tangent = vm.normalize(
            w * c("tangent", 0, 3) + u_ * c("tangent", 4, 7)
            + v_ * c("tangent", 8, 11))
        handed = jnp.sign(c("tangent", 3, 4)[:, 0] + 1e-8)
    else:
        # cheap orthonormal frame from the geometric normal (never consumed
        # by shading when with_tangent=False, but keeps shapes/semantics)
        a = jnp.where(jnp.abs(geo_normal[:, 1:2]) < 0.9,
                      jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32),
                      jnp.asarray([[1.0, 0.0, 0.0]], jnp.float32))
        tangent = vm.normalize(jnp.cross(a, geo_normal))
        handed = jnp.ones_like(hit_t)
    # orient shading normal to the geometric side facing the ray
    front_face = vm.dot(geo_normal, -ray_d) >= 0.0
    flip = jnp.where(front_face, 1.0, -1.0)
    geo_normal = geo_normal * flip[..., None]
    normal = jnp.where(vm.dot(normal, geo_normal)[..., None] < 0.0, -normal, normal)

    mats = scene.materials
    from ..scene.materials import GatheredMaterial

    rows = c("material")
    g = GatheredMaterial(rows)
    # mat index rides the attr table as an exact float column — a separate
    # int (R,) gather of tri_mat measured 38 ms at 1440p
    mat_idx = c("mat_idx")[:, 0].astype(jnp.int32)
    light_row = jnp.where(valid, c("light_row")[:, 0].astype(jnp.int32), -1)
    if has_textures:
        if mip_spread is not None:
            cos_d = jnp.abs(vm.dot(geo_normal, ray_d))
            fp = (
                mip_spread
                * (hit_t if mip_dist0 is None else mip_dist0 + hit_t)
                / jnp.sqrt(jnp.maximum(cos_d, 0.02))
            )
            fp = jnp.where(valid, fp, 1.0)
            lod_uv = jnp.log2(jnp.maximum(fp, 1e-20)) + c("lod")[:, 0]
            _sample = lambda tid, u: sample_trilinear(
                scene.textures, tid, u, lod_uv)
        else:
            _sample = lambda tid, u: sample_bilinear(scene.textures, tid, u)
        base_tex = _sample(mats.base_color_tex[mat_idx], uv)
        base_color = g.base_color * base_tex[..., :3]
        # glTF: effective alpha = baseColorFactor.a x baseColorTexture.a
        alpha = base_tex[..., 3] * g.alpha_factor
        em_tex = _sample(mats.emissive_tex[mat_idx], uv)
        emissive = g.emissive * em_tex[..., :3]
    else:
        base_color = g.base_color
        alpha = g.alpha_factor
        emissive = g.emissive
    # instance emission override (≙ DevicePrimitiveInstance override modes)
    mode = c("em_mode")[:, 0]
    override = c("em_override")
    emissive = jnp.where((mode == 2.0)[..., None], override, emissive)
    emissive = jnp.where((mode == 0.0)[..., None], 0.0, emissive)

    if has_textures:
        mr_tex = _sample(mats.metal_rough_tex[mat_idx], uv)
        # glTF convention: G = roughness, B = metallic
        roughness = g.roughness * mr_tex[..., 1]
        metallic = g.metallic * mr_tex[..., 2]

        # normal mapping (≙ GPUExtractSurfaceData tangent-frame perturbation)
        nm_id = mats.normal_tex[mat_idx]
        nm = _sample(nm_id, uv)[..., :3] * 2.0 - 1.0
        bitan = jnp.cross(normal, tangent) * handed[..., None]
        mapped = vm.normalize(
            nm[..., 0:1] * tangent + nm[..., 1:2] * bitan + nm[..., 2:3] * normal
        )
        normal = jnp.where((nm_id >= 0)[..., None], mapped, normal)
    else:
        roughness = g.roughness
        metallic = g.metallic

    return SurfaceData(
        position=position,
        normal=normal,
        geo_normal=geo_normal,
        uv=uv,
        base_color=base_color,
        emissive=emissive,
        metallic=metallic,
        roughness=roughness,
        alpha=alpha,
        mat_idx=mat_idx,
        mat_rows=rows,
        light_row=light_row,
        tri_idx=hit_tri,
        tangent=tangent,
        t=hit_t,
        valid=valid,
        is_emissive=vm.luminance(emissive) > 0.0,
        front_face=front_face,
    )
