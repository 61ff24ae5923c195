"""Triangle-light extraction and the light table.

JAX equivalent of the reference's emissive pipeline:
`FindEmissivesGpu` (`CUDAKernels/WaveFrontKernels/GPUEmissiveLookup.cu:13-110`,
marks emissive triangles per primitive), `LightDataBuffer`
(`Framework/LightDataBuffer.cpp:37-130`, per-frame world-space
`TriangleLight{p0,p1,p2,normal,radiance,area}` expansion with a capacity trim)
and `BuildLightDataBufferGPU` (`GPUDataBufferKernels.cu:10-66`).

Key difference: light *geometry* (positions/areas) is selected on the
host at scene build, but light *radiance* is gathered from the differentiable
MaterialTable at shade time, so pixel gradients w.r.t. emission flow through
NEE and ReSTIR. A capacity cap keeps shapes static like the reference's 1M cap
(`WaveFrontRenderer.cpp:295`).
"""
from __future__ import annotations

from typing import Optional

import chex
import jax.numpy as jnp
import numpy as np

from .geometry import EmissionMode, FlatGeometry
from .materials import MaterialTable


@chex.dataclass(frozen=True)
class TriangleLights:
    """Device SoA of emissive triangles. `count` is the number of valid rows;
    rows beyond it are zero-area padding (static shape)."""

    p0: jnp.ndarray        # (L,3)
    e1: jnp.ndarray        # (L,3) p1-p0
    e2: jnp.ndarray        # (L,3) p2-p0
    normal: jnp.ndarray    # (L,3) geometric normal (unit)
    area: jnp.ndarray      # (L,)
    tri_idx: jnp.ndarray   # (L,) index into the flat triangle arrays
    mat_idx: jnp.ndarray   # (L,) material id for radiance gather
    inst_idx: jnp.ndarray  # (L,) instance id (for emission override)
    count: jnp.ndarray     # () int32 number of valid lights
    tri_to_light: jnp.ndarray  # (T,) int32 inverse map triangle -> light row, -1 if none
    packed: jnp.ndarray    # (L,13) [p0,e1,e2,normal,area] — ONE gather per sample

    @property
    def capacity(self) -> int:
        return self.p0.shape[0]


def radiance(
    lights: TriangleLights,
    materials: MaterialTable,
    inst_emission_mode: jnp.ndarray,
    inst_emission_override: jnp.ndarray,
    idx: jnp.ndarray,
) -> jnp.ndarray:
    """Differentiable radiance of light rows `idx` (...,) -> (...,3).

    Emission modes mirror `Lumen::EmissionMode`: ENABLED uses the material's
    emissive, OVERRIDE uses the per-instance radiance
    (`PTMeshInstance::UpdateRaytracingData`, `PTMeshInstance.cpp:119-180`).
    """
    mat = materials.emissive[lights.mat_idx[idx]]
    mode = inst_emission_mode[lights.inst_idx[idx]]
    override = inst_emission_override[lights.inst_idx[idx]]
    rad = jnp.where((mode == EmissionMode.OVERRIDE)[..., None], override, mat)
    return jnp.where((mode == EmissionMode.DISABLED)[..., None], 0.0, rad)


def extract_lights(
    geom: FlatGeometry,
    materials_emissive: np.ndarray,
    capacity: Optional[int] = None,
) -> TriangleLights:
    """Host-side emissive-triangle scan (≙ FindEmissivesGpu + LightDataBuffer).

    materials_emissive: (M,3) numpy view of the material emissive colors.
    A triangle is a light if its instance mode is OVERRIDE with nonzero
    radiance, or ENABLED with emissive material luminance > 0.
    """
    t = geom.tri_mat.shape[0]
    if t == 0:
        cap = capacity or 1
        z3 = np.zeros((cap, 3), np.float32)
        return TriangleLights(
            p0=jnp.asarray(z3), e1=jnp.asarray(z3), e2=jnp.asarray(z3),
            normal=jnp.asarray(z3), area=jnp.zeros(cap, jnp.float32),
            tri_idx=jnp.zeros(cap, jnp.int32), mat_idx=jnp.zeros(cap, jnp.int32),
            inst_idx=jnp.zeros(cap, jnp.int32), count=jnp.asarray(0, jnp.int32),
            tri_to_light=jnp.full((max(t, 1),), -1, jnp.int32),
            packed=jnp.zeros((cap, 13), jnp.float32),
        )
    mat_em = materials_emissive[geom.tri_mat]  # (T,3)
    mode = geom.inst_emission_mode[geom.tri_inst]  # (T,)
    override = geom.inst_emission_override[geom.tri_inst]  # (T,3)
    lum = mat_em.max(axis=-1)
    olum = override.max(axis=-1)
    is_light = ((mode == EmissionMode.ENABLED) & (lum > 0.0)) | (
        (mode == EmissionMode.OVERRIDE) & (olum > 0.0)
    )
    sel = np.nonzero(is_light)[0].astype(np.int32)
    n = sel.shape[0]
    cap = capacity or max(int(n), 1)
    if n > cap:  # trim like LightDataBuffer.cpp:96-113
        sel = sel[:cap]
        n = cap
    p = geom.tri_pos[sel]  # (n,3,3)
    p0, p1, p2 = p[:, 0], p[:, 1], p[:, 2]
    e1, e2 = p1 - p0, p2 - p0
    cr = np.cross(e1, e2)
    area2 = np.linalg.norm(cr, axis=-1)
    nrm = cr / np.maximum(area2[:, None], 1e-20)
    area = 0.5 * area2

    def pad(a, shape):
        out = np.zeros((cap,) + shape, a.dtype)
        out[:n] = a
        return jnp.asarray(out)

    tri_to_light = np.full((t,), -1, np.int32)
    tri_to_light[sel] = np.arange(n, dtype=np.int32)

    return TriangleLights(
        p0=pad(p0.astype(np.float32), (3,)),
        e1=pad(e1.astype(np.float32), (3,)),
        e2=pad(e2.astype(np.float32), (3,)),
        normal=pad(nrm.astype(np.float32), (3,)),
        area=pad(area.astype(np.float32), ()),
        tri_idx=pad(sel, ()),
        mat_idx=pad(geom.tri_mat[sel], ()),
        inst_idx=pad(geom.tri_inst[sel], ()),
        count=jnp.asarray(n, jnp.int32),
        tri_to_light=jnp.asarray(tri_to_light),
        packed=jnp.concatenate(
            [
                pad(p0.astype(np.float32), (3,)),
                pad(e1.astype(np.float32), (3,)),
                pad(e2.astype(np.float32), (3,)),
                pad(nrm.astype(np.float32), (3,)),
                pad(area.astype(np.float32), ())[:, None],
            ],
            axis=-1,
        ),
    )


def refit_lights(lights: TriangleLights, tri_pos: jnp.ndarray) -> TriangleLights:
    """Device-side light-geometry refit for dynamic scenes (round 4): light
    membership (which triangles are emissive) is static — topology doesn't
    change with transforms — but positions/areas move with their instances
    (≙ the reference's per-frame world-space TriangleLight rebuild,
    `LightDataBuffer.cpp:37-130`). Pure jnp, jit-safe."""
    cap = lights.capacity
    valid = jnp.arange(cap) < lights.count
    tri = tri_pos[jnp.maximum(lights.tri_idx, 0)]    # (L,3,3)
    p0 = jnp.where(valid[:, None], tri[:, 0], 0.0)
    e1 = jnp.where(valid[:, None], tri[:, 1] - tri[:, 0], 0.0)
    e2 = jnp.where(valid[:, None], tri[:, 2] - tri[:, 0], 0.0)
    n = jnp.cross(e1, e2)
    ln = jnp.linalg.norm(n, axis=-1)
    area = 0.5 * ln
    normal = n / jnp.maximum(ln, 1e-12)[:, None]
    packed = jnp.concatenate(
        [p0, e1, e2, normal, area[:, None]], axis=1)
    return lights.replace(
        p0=p0, e1=e1, e2=e2, normal=normal, area=area, packed=packed)
