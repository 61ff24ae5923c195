"""The device scene pytree and its host-side builder.

JAX replacement for the reference's scene stack:
`PTScene` + `SceneDataTable` (`Framework/PTScene.cpp`, `SceneDataTable.h:18`) —
instead of a GPU byte-table indexed by OptiX instance id, the scene is a
structure-of-arrays pytree; per-instance records become plain gathers.

The whole scene is a pytree, so it can be jit-closed-over, donated, sharded
(replicated across the device mesh), checkpointed, and differentiated —
materials and emission overrides are first-class gradient leaves.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import chex
import jax.numpy as jnp
import numpy as np

from . import lights as lights_mod
from .geometry import FlatGeometry, InstanceHost, flatten_instances
from .materials import MaterialSpec, MaterialTable, build_material_table
from .textures import TextureAtlas, build_texture_atlas


@chex.dataclass(frozen=True)
class SceneData:
    """Device scene: world-space flattened triangle SoA + materials + lights.

    tri_pos and friends are the baked single-level geometry (≙ the reference's
    IAS-flattened view); accel structures are built separately over tri_pos.
    """

    tri_pos: jnp.ndarray       # (T,3,3)
    tri_normal: jnp.ndarray    # (T,3,3)
    tri_uv: jnp.ndarray        # (T,3,2)
    tri_tangent: jnp.ndarray   # (T,3,4)
    tri_mat: jnp.ndarray       # (T,)
    tri_inst: jnp.ndarray      # (T,)
    materials: MaterialTable
    lights: lights_mod.TriangleLights
    textures: TextureAtlas
    inst_emission_mode: jnp.ndarray      # (I,)
    inst_emission_override: jnp.ndarray  # (I,3) — differentiable
    env_radiance: jnp.ndarray            # (3,) constant environment light
    # (absent in the reference — misses contribute nothing there; used here
    # for furnace tests and outdoor scenes, differentiable)
    volumes: Optional[object] = None     # volume.grid.VolumeSet (M6), or None

    @property
    def num_triangles(self) -> int:
        return self.tri_pos.shape[0]

    def light_radiance(self, light_idx: jnp.ndarray) -> jnp.ndarray:
        return lights_mod.radiance(
            self.lights,
            self.materials,
            self.inst_emission_mode,
            self.inst_emission_override,
            light_idx,
        )


@dataclasses.dataclass
class SceneBuilder:
    """Host-side scene assembly (≙ `ILumenScene` + `SceneManager` factories:
    `ModelLoading/ILumenScene.h`, `SceneManager.h:133`)."""

    instances: List[InstanceHost] = dataclasses.field(default_factory=list)
    materials: List[MaterialSpec] = dataclasses.field(default_factory=list)
    texture_images: List[np.ndarray] = dataclasses.field(default_factory=list)
    light_capacity: Optional[int] = None
    env_radiance: tuple = (0.0, 0.0, 0.0)
    volume_specs: list = dataclasses.field(default_factory=list)

    def add_volume(self, density, aabb_lo, aabb_hi, sigma_t=1.0, albedo=0.9,
                   sparse: bool = False) -> int:
        """Add a dense density-grid volume (≙ `CreateVolume`/`PTVolume`,
        `Framework/WaveFrontRenderer.cpp:388-433`). density: (X,Y,Z) array.
        sparse=True builds a SparseVolumeSet (8³ index + apron bricks,
        memory ∝ occupancy) — all volumes in a scene share one layout, so
        the first spec's flag wins."""
        self.volume_specs.append(
            (density, aabb_lo, aabb_hi, sigma_t, albedo, sparse))
        return len(self.volume_specs) - 1

    def add_material(self, spec: MaterialSpec) -> int:
        self.materials.append(spec)
        return len(self.materials) - 1

    def add_texture(self, image: np.ndarray) -> int:
        """image: (H,W,4) float32 or uint8. Returns texture id."""
        self.texture_images.append(image)
        return len(self.texture_images) - 1

    def add_instance(self, inst: InstanceHost) -> int:
        self.instances.append(inst)
        return len(self.instances) - 1

    def build(self) -> SceneData:
        specs = self.materials or [MaterialSpec()]
        mat_table = build_material_table(specs)
        geom: FlatGeometry = flatten_instances(self.instances)
        emissive_np = np.array(
            [s.emissive for s in specs], np.float32
        ).reshape(-1, 3)
        lights = lights_mod.extract_lights(
            geom, emissive_np, capacity=self.light_capacity
        )
        atlas = build_texture_atlas(self.texture_images)
        volumes = None
        if self.volume_specs:
            from ..volume.grid import build_sparse, make_volume_set

            make = build_sparse if self.volume_specs[0][5] else make_volume_set
            volumes = make(
                [np.asarray(s[0], np.float32) for s in self.volume_specs],
                [s[1] for s in self.volume_specs],
                [s[2] for s in self.volume_specs],
                sigma_t=[s[3] for s in self.volume_specs],
                albedo=[s[4] for s in self.volume_specs],
            )
        return SceneData(
            tri_pos=jnp.asarray(geom.tri_pos),
            tri_normal=jnp.asarray(geom.tri_normal),
            tri_uv=jnp.asarray(geom.tri_uv),
            tri_tangent=jnp.asarray(geom.tri_tangent),
            tri_mat=jnp.asarray(geom.tri_mat),
            tri_inst=jnp.asarray(geom.tri_inst),
            materials=mat_table,
            lights=lights,
            textures=atlas,
            inst_emission_mode=jnp.asarray(geom.inst_emission_mode),
            inst_emission_override=jnp.asarray(geom.inst_emission_override),
            env_radiance=jnp.asarray(self.env_radiance, jnp.float32),
            volumes=volumes,
        )
