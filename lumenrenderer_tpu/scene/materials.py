"""Material table: structure-of-arrays Disney BSDF parameters.

JAX replacement for the reference's packed `MaterialData`
(`Shaders/CppCommon/MaterialStructs.h:13-263`) and `PTMaterial`
(`Framework/PTMaterial.{h,cpp}`). Instead of byte-packed float4 records,
parameters are plain float32 SoA arrays living in a pytree — indexed with
gathers on device, and *differentiable* (gradients w.r.t. any parameter flow
through the renderer, which the CUDA reference cannot do).
"""
from __future__ import annotations

import dataclasses
from typing import List

import chex
import jax.numpy as jnp
import numpy as np


@chex.dataclass(frozen=True)
class MaterialTable:
    """Device-side SoA of Disney parameters; row i = material id i.

    Texture ids index into the scene's texture atlas; -1 means "no texture"
    (the reference uses default white/normal textures instead,
    `Renderer/LumenRenderer.cpp`; we fold that into the sampler).
    """

    base_color: jnp.ndarray        # (M,3)
    emissive: jnp.ndarray          # (M,3) radiance scale * color
    metallic: jnp.ndarray          # (M,)
    roughness: jnp.ndarray         # (M,)
    subsurface: jnp.ndarray        # (M,)
    specular: jnp.ndarray          # (M,)
    spec_tint: jnp.ndarray         # (M,)
    anisotropic: jnp.ndarray       # (M,)
    sheen: jnp.ndarray             # (M,)
    sheen_tint: jnp.ndarray        # (M,)
    clearcoat: jnp.ndarray         # (M,)
    clearcoat_gloss: jnp.ndarray   # (M,)
    spec_trans: jnp.ndarray        # (M,) transmission weight
    ior: jnp.ndarray               # (M,) index of refraction
    transmittance: jnp.ndarray     # (M,3) Beer's-law per-channel extinction color
    # Per-material alpha pipeline (round 5, ≙ glTF alphaMode/alphaCutoff/
    # doubleSided and SurfaceData.h ALPHA_TRANSPARENT flags): mode
    # 0=OPAQUE (alpha ignored), 1=MASK (cutoff test), 2=BLEND (stochastic)
    alpha_mode: jnp.ndarray        # (M,) float {0,1,2}
    alpha_cutoff: jnp.ndarray      # (M,)
    double_sided: jnp.ndarray     # (M,) float {0,1}; 0 = cull back faces
    alpha_factor: jnp.ndarray      # (M,) baseColorFactor alpha (x texture a)
    # Texture bindings (int32, -1 = none)
    base_color_tex: jnp.ndarray
    emissive_tex: jnp.ndarray
    normal_tex: jnp.ndarray
    metal_rough_tex: jnp.ndarray

    def gather(self, idx: jnp.ndarray) -> "MaterialTable":
        """Gather per-ray material rows (idx: (...,) int32)."""
        import jax

        return jax.tree_util.tree_map(lambda a: a[idx], self)

    @property
    def count(self) -> int:
        return self.base_color.shape[0]

    def packed(self) -> jnp.ndarray:
        """All float params concatenated to an (M, 22) matrix so per-ray
        material access is ONE row gather instead of ~15 (each gather has
        a fixed per-op cost). Differentiable: concat/slice carry
        gradients back to the individual parameter leaves."""
        return jnp.concatenate(
            [
                self.base_color,                     # 0:3
                self.emissive,                       # 3:6
                self.metallic[:, None],              # 6
                self.roughness[:, None],             # 7
                self.subsurface[:, None],            # 8
                self.specular[:, None],              # 9
                self.spec_tint[:, None],             # 10
                self.anisotropic[:, None],           # 11
                self.sheen[:, None],                 # 12
                self.sheen_tint[:, None],            # 13
                self.clearcoat[:, None],             # 14
                self.clearcoat_gloss[:, None],       # 15
                self.spec_trans[:, None],            # 16
                self.ior[:, None],                   # 17
                self.transmittance,                  # 18:21
                self.alpha_mode[:, None],            # 21
                self.alpha_cutoff[:, None],          # 22
                self.double_sided[:, None],          # 23
                self.alpha_factor[:, None],          # 24
            ],
            axis=-1,
        )


class GatheredMaterial:
    """Per-ray view over packed material rows (R, 25): column slices."""

    __slots__ = ("rows",)

    def __init__(self, rows: jnp.ndarray):
        self.rows = rows

    base_color = property(lambda s: s.rows[..., 0:3])
    emissive = property(lambda s: s.rows[..., 3:6])
    metallic = property(lambda s: s.rows[..., 6])
    roughness = property(lambda s: s.rows[..., 7])
    subsurface = property(lambda s: s.rows[..., 8])
    specular = property(lambda s: s.rows[..., 9])
    spec_tint = property(lambda s: s.rows[..., 10])
    anisotropic = property(lambda s: s.rows[..., 11])
    sheen = property(lambda s: s.rows[..., 12])
    sheen_tint = property(lambda s: s.rows[..., 13])
    clearcoat = property(lambda s: s.rows[..., 14])
    clearcoat_gloss = property(lambda s: s.rows[..., 15])
    spec_trans = property(lambda s: s.rows[..., 16])
    ior = property(lambda s: s.rows[..., 17])
    transmittance = property(lambda s: s.rows[..., 18:21])
    alpha_mode = property(lambda s: s.rows[..., 21])
    alpha_cutoff = property(lambda s: s.rows[..., 22])
    double_sided = property(lambda s: s.rows[..., 23])
    alpha_factor = property(lambda s: s.rows[..., 24])


@dataclasses.dataclass
class MaterialSpec:
    """Host-side material description (mirrors `LumenRenderer::MaterialData`,
    `Renderer/LumenRenderer.h:44-141`)."""

    base_color: tuple = (0.8, 0.8, 0.8)
    emissive: tuple = (0.0, 0.0, 0.0)
    metallic: float = 0.0
    roughness: float = 0.5
    subsurface: float = 0.0
    specular: float = 0.5
    spec_tint: float = 0.0
    anisotropic: float = 0.0
    sheen: float = 0.0
    sheen_tint: float = 0.5
    clearcoat: float = 0.0
    clearcoat_gloss: float = 1.0
    spec_trans: float = 0.0
    ior: float = 1.5
    transmittance: tuple = (1.0, 1.0, 1.0)
    # alpha pipeline (glTF alphaMode semantics); double_sided defaults True
    # so hand-built scenes keep omnidirectional visibility (glTF assets set
    # their own per-material value)
    alpha_mode: int = 0            # 0 OPAQUE | 1 MASK | 2 BLEND
    alpha_cutoff: float = 0.5
    double_sided: bool = True
    alpha_factor: float = 1.0
    base_color_tex: int = -1
    emissive_tex: int = -1
    normal_tex: int = -1
    metal_rough_tex: int = -1


def build_material_table(specs: List[MaterialSpec]) -> MaterialTable:
    """Pack host MaterialSpecs into a device MaterialTable."""
    if not specs:
        specs = [MaterialSpec()]

    def f(name):
        return jnp.asarray(
            np.array([getattr(s, name) for s in specs], dtype=np.float32)
        )

    def i(name):
        return jnp.asarray(
            np.array([getattr(s, name) for s in specs], dtype=np.int32)
        )

    return MaterialTable(
        base_color=f("base_color"),
        emissive=f("emissive"),
        metallic=f("metallic"),
        roughness=f("roughness"),
        subsurface=f("subsurface"),
        specular=f("specular"),
        spec_tint=f("spec_tint"),
        anisotropic=f("anisotropic"),
        sheen=f("sheen"),
        sheen_tint=f("sheen_tint"),
        clearcoat=f("clearcoat"),
        clearcoat_gloss=f("clearcoat_gloss"),
        spec_trans=f("spec_trans"),
        ior=f("ior"),
        transmittance=f("transmittance"),
        alpha_mode=f("alpha_mode"),
        alpha_cutoff=f("alpha_cutoff"),
        alpha_factor=f("alpha_factor"),
        double_sided=jnp.asarray(np.array(
            [1.0 if s.double_sided else 0.0 for s in specs], np.float32)),
        base_color_tex=i("base_color_tex"),
        emissive_tex=i("emissive_tex"),
        normal_tex=i("normal_tex"),
        metal_rough_tex=i("metal_rough_tex"),
    )
