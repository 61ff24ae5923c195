"""Next-event estimation: light sampling + shadow-ray construction.

JAX equivalent of `ShadeDirect`
(`CUDAKernels/WaveFrontKernels/GPUShadeDirect.cu:42-153`): pick a triangle
light, sample a point on it, evaluate the BSDF and geometry term, and emit a
shadow ray carrying the *unshadowed* contribution; occlusion later zeroes it
(≙ `ShadowRaysRayGen`, `Shaders/WaveFrontShaders.cu:114-179`).

Design: all per-light data — geometry, differentiable
radiance, selection pdf — is packed ONCE per frame into a single (L,17)
`LightTable.aug` matrix. Per-ray selection + data fetch is then ONE one-hot
matmul for L <= ONEHOT_MAX_L lights, replacing a `jnp.searchsorted`
and per-field gathers (both measured slower on the previous accelerator;
not yet re-measured on the GPU). Uniform and
radiance-weighted CDF selection share the same code path — they differ only
in the table's cdf/sel_pdf columns.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import sampling
from ..core import vecmath as vm
from ..scene.scene import SceneData

SHADOW_EPS = 1e-3
# one-hot (R,L) selection matmuls beat gathers up to a few thousand lights
# (beyond that the O(R*L) compare/matmul overtakes the fixed gather cost)
ONEHOT_MAX_L = 2048


class LightTable(NamedTuple):
    """Per-frame packed light table.

    aug: (L,17) = [p0(3), e1(3), e2(3), normal(3), area(1), radiance(3),
                   sel_pdf(1)] — radiance is differentiable; everything a
                   light sample needs in ONE row.
    cdf: (L,) selection CDF (uniform mode: linear ramp over valid lights).
    count: () int32 number of valid lights.
    """

    aug: jnp.ndarray
    cdf: jnp.ndarray
    count: jnp.ndarray


class LightSample(NamedTuple):
    light_idx: jnp.ndarray   # (R,) int32
    point: jnp.ndarray       # (R,3) position on light
    normal: jnp.ndarray      # (R,3) light geometric normal
    radiance: jnp.ndarray    # (R,3)
    pdf_area: jnp.ndarray    # (R,) pdf in area measure (select * point)
    wi: jnp.ndarray          # (R,3) unit dir surface -> light
    dist: jnp.ndarray        # (R,)
    cos_light: jnp.ndarray   # (R,) |cos| at the light (0 if behind)
    valid: jnp.ndarray       # (R,) bool


def all_light_radiance(scene: SceneData) -> jnp.ndarray:
    """Dense (L,3) differentiable radiance of every light row — computed
    once per frame so per-ray light sampling needs no per-field gathers."""
    lights = scene.lights
    return scene.light_radiance(jnp.arange(lights.capacity, dtype=jnp.int32))


def _selection_weights(scene: SceneData, rad, selection: str):
    lights = scene.lights
    idx = jnp.arange(lights.capacity)
    valid = idx < lights.count
    if selection == "cdf":
        # ≙ the reference's per-frame radiance CDF (`ReSTIR::BuildCDF`,
        # `Framework/ReSTIR.cpp:235-262`): weights = luminance * area
        w = vm.luminance(jax.lax.stop_gradient(rad)) * lights.area
        w = jnp.where(valid, jnp.maximum(w, 0.0), 0.0)
        # degenerate all-zero: uniform over valid lights
        w = jnp.where(jnp.sum(w) > 0, w, valid.astype(jnp.float32))
    else:
        w = valid.astype(jnp.float32)
    return w


def build_light_cdf(scene: SceneData, light_rad_all=None):
    """(cdf (L,), sel_pdf (L,)) — kept for ReSTIR's light-bag sampler."""
    rad = light_rad_all if light_rad_all is not None else all_light_radiance(scene)
    w = _selection_weights(scene, rad, "cdf")
    cdf = jnp.cumsum(w)
    total = jnp.maximum(cdf[-1], 1e-20)
    return cdf / total, w / total


def build_light_table(
    scene: SceneData, selection: str = "cdf", light_rad_all=None
) -> LightTable:
    """Build the per-frame packed light table (once per frame, O(L))."""
    lights = scene.lights
    rad = light_rad_all if light_rad_all is not None else all_light_radiance(scene)
    w = _selection_weights(scene, rad, selection)
    cdf = jnp.cumsum(w)
    total = jnp.maximum(cdf[-1], 1e-20)
    aug = jnp.concatenate(
        [lights.packed, rad, (w / total)[:, None]], axis=1
    ).astype(jnp.float32)
    return LightTable(aug=aug, cdf=cdf / total, count=lights.count)


def _rows_by_index(table: LightTable, idx: jnp.ndarray) -> jnp.ndarray:
    """Fetch aug rows for int32 indices: one-hot matmul for small L (a
    (R,L)x(L,17) matmul), row gather otherwise. Gradients flow into the radiance
    columns (one_hot of a detached index is a constant matrix)."""
    L = table.aug.shape[0]
    idx = jnp.clip(idx, 0, L - 1).astype(jnp.int32)
    if L <= ONEHOT_MAX_L:
        oh = jax.nn.one_hot(idx, L, dtype=jnp.float32)
        # HIGHEST: a reduced-precision matmul default would round the
        # gathered light geometry (one-hot entries are exact either way)
        return jnp.matmul(oh, table.aug,
                          precision=jax.lax.Precision.HIGHEST)
    return table.aug[idx]


def select_light(table: LightTable, u0: jnp.ndarray):
    """CDF-invert u0 (R,) -> (idx (R,) int32, aug rows (R,17)).

    Small L: branchless compare-count (vectorized, no searchsorted) fused
    into the one-hot row fetch. Large L: log-step binary search via
    jnp.searchsorted + one row gather.
    """
    L = table.cdf.shape[0]
    if L <= ONEHOT_MAX_L:
        idx = jnp.sum(
            (u0[:, None] > table.cdf[None, :]).astype(jnp.int32), axis=1
        )
    else:
        idx = jnp.searchsorted(table.cdf, u0, side="right").astype(jnp.int32)
    idx = jnp.clip(idx, 0, L - 1)
    return idx, _rows_by_index(table, idx)


def sample_light(
    table: LightTable, u: jnp.ndarray, shading_pos: jnp.ndarray
) -> LightSample:
    """Pick one of the scene's triangle lights and a point on it.

    u: (R,3) uniforms — u[:,0] selects the light (by the table's CDF),
    u[:,1:3] the point. ≙ `GPUShadeDirect.cu:83` CDF sampling.
    """
    idx, row = select_light(table, u[:, 0])
    bary = sampling.sample_triangle(u[:, 1:3])
    p0, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    point = p0 + bary[:, 1:2] * e1 + bary[:, 2:3] * e2
    nrm = row[:, 9:12]
    area = row[:, 12]
    rad = row[:, 13:16]
    sel_pdf = row[:, 16]

    to_light = point - shading_pos
    dist = vm.length(to_light)
    wi = to_light / jnp.maximum(dist[..., None], 1e-8)
    cos_light = vm.dot(nrm, -wi)  # light emits from its front face
    pdf_area = sel_pdf / jnp.maximum(area, 1e-12)
    valid = (
        (table.count > 0)
        & (cos_light > 1e-6)
        & (area > 1e-12)
        & (dist > 1e-5)
        & (sel_pdf > 0.0)
    )
    return LightSample(
        light_idx=idx,
        point=point,
        normal=nrm,
        radiance=rad,
        pdf_area=pdf_area,
        wi=wi,
        dist=dist,
        cos_light=jnp.maximum(cos_light, 0.0),
        valid=valid,
    )


def pdf_solid_angle(ls: LightSample) -> jnp.ndarray:
    """Convert the area pdf to solid-angle measure at the shading point."""
    return ls.pdf_area * ls.dist * ls.dist / jnp.maximum(ls.cos_light, 1e-6)


def light_pdf_solid_angle(
    table: LightTable,
    wi: jnp.ndarray,
    hit_t: jnp.ndarray,
    light_row: jnp.ndarray,
) -> jnp.ndarray:
    """Solid-angle pdf that NEE would have used for direction wi hitting
    light row `light_row` at distance `hit_t` (for MIS weighting of BSDF
    hits). light_row is the tri->light inverse map value carried in the
    surface attribute table (-1 = hit triangle is not a light)."""
    found = light_row >= 0
    prow = _rows_by_index(table, jnp.maximum(light_row, 0))
    area = prow[:, 12]
    nrm = prow[:, 9:12]
    sel = prow[:, 16]
    cos_l = jnp.maximum(vm.dot(nrm, -wi), 0.0)
    pdf_a = sel / jnp.maximum(area, 1e-12)
    pdf_sa = pdf_a * hit_t * hit_t / jnp.maximum(cos_l, 1e-6)
    return jnp.where(found & (cos_l > 1e-6), pdf_sa, 0.0)
