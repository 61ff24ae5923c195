"""Serialized scene cache — fast binary reload of built scenes.

JAX replacement for the reference's custom `.ollad` model format
(`Lumen/src/Lumen/Tools/LumenPTModelConverter.{h,cpp}`: glTF → header +
blob, ~10x faster reload). Here the built `SceneData` pytree (already SoA)
serializes losslessly to one .npz — no bespoke format needed; the pytree IS
the format. Hooked the same way (`OpenCustomFileFormat` /
`CreateCustomFileFormat`, `Framework/WaveFrontRenderer.cpp:1135-1146`):
`load_or_build("x.gltf")` uses `x.lumen.npz` when fresh.
"""
from __future__ import annotations

import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..volume.grid import VolumeSet
from .lights import TriangleLights
from .materials import MaterialTable
from .scene import SceneData
from .textures import TextureAtlas

CACHE_EXT = ".lumen.npz"


def save_scene(path: str, scene: SceneData) -> None:
    leaves, treedef = jax.tree_util.tree_flatten(scene)
    arrays = {f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)}
    arrays["__has_volumes__"] = np.asarray(scene.volumes is not None)
    np.savez_compressed(path, **arrays)


def _structure(has_volumes: bool) -> SceneData:
    """A skeleton SceneData with the right treedef for unflattening."""
    z3 = jnp.zeros((1, 3))
    dummy_vol = (
        VolumeSet(
            density=jnp.zeros((1, 1, 1, 1)), aabb_lo=z3, aabb_hi=z3,
            sigma_t=jnp.zeros(1), albedo=jnp.zeros(1),
        )
        if has_volumes
        else None
    )
    return SceneData(
        tri_pos=jnp.zeros((1, 3, 3)), tri_normal=jnp.zeros((1, 3, 3)),
        tri_uv=jnp.zeros((1, 3, 2)), tri_tangent=jnp.zeros((1, 3, 4)),
        tri_mat=jnp.zeros(1, jnp.int32), tri_inst=jnp.zeros(1, jnp.int32),
        materials=MaterialTable(
            base_color=z3, emissive=z3, metallic=jnp.zeros(1),
            roughness=jnp.zeros(1), subsurface=jnp.zeros(1),
            specular=jnp.zeros(1), spec_tint=jnp.zeros(1),
            anisotropic=jnp.zeros(1), sheen=jnp.zeros(1),
            sheen_tint=jnp.zeros(1), clearcoat=jnp.zeros(1),
            clearcoat_gloss=jnp.zeros(1), spec_trans=jnp.zeros(1),
            ior=jnp.zeros(1), transmittance=z3,
            alpha_mode=jnp.zeros(1), alpha_cutoff=jnp.zeros(1),
            double_sided=jnp.zeros(1), alpha_factor=jnp.zeros(1),
            base_color_tex=jnp.zeros(1, jnp.int32),
            emissive_tex=jnp.zeros(1, jnp.int32),
            normal_tex=jnp.zeros(1, jnp.int32),
            metal_rough_tex=jnp.zeros(1, jnp.int32),
        ),
        lights=TriangleLights(
            p0=z3, e1=z3, e2=z3, normal=z3, area=jnp.zeros(1),
            tri_idx=jnp.zeros(1, jnp.int32), mat_idx=jnp.zeros(1, jnp.int32),
            inst_idx=jnp.zeros(1, jnp.int32), count=jnp.zeros((), jnp.int32),
            tri_to_light=jnp.zeros(1, jnp.int32),
            packed=jnp.zeros((1, 13)),
        ),
        textures=TextureAtlas(
            texels=jnp.zeros((1, 4)), offset=jnp.zeros(1, jnp.int32),
            width=jnp.zeros(1, jnp.int32), height=jnp.zeros(1, jnp.int32),
            mip_offset=jnp.zeros((1, 14), jnp.int32),
            n_mips=jnp.zeros(1, jnp.int32),
        ),
        inst_emission_mode=jnp.zeros(1, jnp.int32),
        inst_emission_override=z3,
        env_radiance=jnp.zeros(3),
        volumes=dummy_vol,
    )


def load_scene(path: str) -> SceneData:
    with np.load(path) as z:
        has_vol = bool(z["__has_volumes__"])
        skel = _structure(has_vol)
        treedef = jax.tree_util.tree_structure(skel)
        n = treedef.num_leaves
        leaves = [jnp.asarray(z[f"leaf_{i}"]) for i in range(n)]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def load_or_build(gltf_path: str, cache_path: Optional[str] = None) -> SceneData:
    """Load from cache if newer than the source, else build+cache
    (≙ OpenCustomFileFormat/CreateCustomFileFormat flow)."""
    cache_path = cache_path or gltf_path + CACHE_EXT
    if os.path.exists(cache_path) and os.path.getmtime(cache_path) >= os.path.getmtime(
        gltf_path
    ):
        return load_scene(cache_path)
    from .gltf import load_gltf

    scene = load_gltf(gltf_path).build()
    save_scene(cache_path, scene)
    return scene
