"""Per-material alpha pipeline.

≙ glTF 2.0 alphaMode/alphaCutoff/doubleSided semantics and the reference's
ALPHA_TRANSPARENT surface flags (`GPUExtractSurfaceData.cu:8-228`,
`Shaders/CppCommon/SurfaceData.h:18-108`): MASK materials cut deterministic
holes at the cutoff, BLEND materials pass through stochastically, OPAQUE
materials ignore alpha, and single-sided materials cull back faces.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np

from lumenrenderer_tpu.accel import brute
from lumenrenderer_tpu.core.camera import Camera
from lumenrenderer_tpu.integrator.wavefront import (RenderConfig,
                                                    merge_channels,
                                                    render_wavefront)
from lumenrenderer_tpu.scene import presets
from lumenrenderer_tpu.scene.materials import MaterialSpec
from lumenrenderer_tpu.scene.scene import SceneBuilder


def _frame(scene, cam, cfg):
    isect = functools.partial(brute.intersect_closest, scene.tri_pos)
    occl = functools.partial(brute.intersect_any, scene.tri_pos)

    @jax.jit
    def f(key, fi):
        return merge_channels(
            render_wavefront(scene, isect, occl, cam, key, fi, cfg))

    return f


def _uv_quad(corners, mat_id):
    from lumenrenderer_tpu.scene.geometry import MeshHost

    pos = np.array(corners, np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return MeshHost(positions=pos, indices=idx, uvs=uv,
                    material_ids=mat_id)


def _quad_scene(mat_kwargs, env=2.0, tex=None, corners=None):
    b = SceneBuilder(env_radiance=(env, env, env))
    if tex is not None:
        mat_kwargs = dict(mat_kwargs, base_color_tex=b.add_texture(tex))
    m = b.add_material(MaterialSpec(base_color=(0.0, 0.0, 0.0),
                                    roughness=1.0, **mat_kwargs))
    corners = corners or [(-5, -5, 0), (5, -5, 0), (5, 5, 0), (-5, 5, 0)]
    b.add_instance(presets.InstanceHost(mesh=_uv_quad(corners, m)))
    return b.build()


# eye nudged off the quad diagonal: center-jitter rays exactly on the
# shared triangle edge can miss both triangles (f32 MT edge case)
CAM = Camera.look_at(eye=(0.043, 0.017, 3), target=(0.043, 0.017, 0),
                     fov_y_deg=30.0)
CFG = RenderConfig(width=16, height=16, max_depth=2, bsdf="lambert",
                   light_strategy="nee", rr_start_depth=99, jitter="center",
                   alpha_materials=True, mipmaps=False)


def test_mask_material_binary_holes():
    """MASK foliage: two half-screen quads, one below the cutoff (fully
    transparent: env shows through), one above (fully opaque: black) — NO
    stochastic blending, a single deterministic sample decides."""
    env = 2.0
    b = SceneBuilder(env_radiance=(env, env, env))
    lo = b.add_material(MaterialSpec(base_color=(0, 0, 0), roughness=1.0,
                                     alpha_mode=1, alpha_factor=0.1))
    hi = b.add_material(MaterialSpec(base_color=(0, 0, 0), roughness=1.0,
                                     alpha_mode=1, alpha_factor=0.9))
    b.add_instance(presets.InstanceHost(mesh=_uv_quad(
        [(-5, -5, 0), (0, -5, 0), (0, 5, 0), (-5, 5, 0)], lo)))
    b.add_instance(presets.InstanceHost(mesh=_uv_quad(
        [(0, -5, 0), (5, -5, 0), (5, 5, 0), (0, 5, 0)], hi)))
    sc = b.build()
    img = np.asarray(_frame(sc, CAM, CFG)(jax.random.PRNGKey(0),
                                          jnp.uint32(0))).reshape(16, 16, 3)
    lum = img.mean(-1)
    left, right = lum[:, :7], lum[:, 9:]
    np.testing.assert_allclose(left, env, rtol=1e-3)   # masked out -> env
    np.testing.assert_allclose(right, 0.0, atol=1e-4)  # opaque black


def test_opaque_material_ignores_alpha():
    """OPAQUE (glTF default): alpha (factor AND texture) is ignored."""
    tex = np.ones((4, 4, 4), np.float32)
    tex[..., 3] = 0.05
    sc = _quad_scene({"alpha_mode": 0, "alpha_factor": 0.05}, tex=tex)
    img = np.asarray(_frame(sc, CAM, CFG)(jax.random.PRNGKey(0),
                                          jnp.uint32(0))).reshape(16, 16, 3)
    assert np.allclose(img, 0.0, atol=1e-5)


def test_blend_material_stochastic_mean():
    """BLEND: E[pixel] = (1 - alpha) * env behind a black blended quad."""
    env, alpha = 2.0, 0.3
    tex = np.ones((4, 4, 4), np.float32)
    tex[..., 3] = alpha
    sc = _quad_scene({"alpha_mode": 2}, env=env, tex=tex)
    f = _frame(sc, CAM, CFG)
    acc = np.zeros((256, 3))
    for i in range(96):
        acc += np.asarray(f(jax.random.PRNGKey(i), jnp.uint32(i)))
    mean = (acc / 96).mean()
    expect = (1 - alpha) * env
    assert abs(mean - expect) / expect < 0.12, (mean, expect)


def test_alpha_factor_multiplies_texture():
    """Effective alpha = baseColorFactor.a x texture.a (glTF)."""
    env = 2.0
    tex = np.ones((4, 4, 4), np.float32)          # texture alpha 1.0
    sc = _quad_scene({"alpha_mode": 1, "alpha_cutoff": 0.5,
                      "alpha_factor": 0.2}, env=env, tex=tex)
    img = np.asarray(_frame(sc, CAM, CFG)(jax.random.PRNGKey(0),
                                          jnp.uint32(0)))
    # 0.2 < cutoff -> whole quad masked out -> pure env
    assert np.allclose(img.mean(), env, rtol=1e-3)


def test_single_sided_backface_cull():
    """doubleSided=False: back-face hits pass through (glTF culling); the
    front face still renders."""
    env = 2.0
    sc = _quad_scene({"double_sided": False}, env=env)
    # quad winding gives normal +z; camera at +3 sees the FRONT face
    img_f = np.asarray(_frame(sc, CAM, CFG)(jax.random.PRNGKey(0),
                                            jnp.uint32(0)))
    cam_back = Camera.look_at(eye=(0.043, 0.017, -3),
                              target=(0.043, 0.017, 0), fov_y_deg=30.0)
    img_b = np.asarray(_frame(sc, cam_back, CFG)(jax.random.PRNGKey(0),
                                                 jnp.uint32(0)))
    np.testing.assert_allclose(img_f, 0.0, atol=1e-5)       # front: surface
    np.testing.assert_allclose(img_b.mean(), env, rtol=1e-3)  # back: culled


def test_renderer_autoenables_alpha_materials():
    from lumenrenderer_tpu.render.renderer import Renderer

    tex = np.ones((4, 4, 4), np.float32)
    sc = _quad_scene({"alpha_mode": 1}, tex=tex)
    r = Renderer(sc, RenderConfig(width=8, height=8, max_depth=2,
                                  bsdf="lambert", light_strategy="nee"),
                 accel="tiled", cluster_size=32, interpret=True)
    assert r.config.alpha_materials


def test_gltf_parses_alpha_fields(tmp_path):
    import json

    from lumenrenderer_tpu.scene.gltf import load_gltf

    tri = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    idx = np.array([0, 1, 2], np.uint16)
    blob = tri.tobytes() + idx.tobytes() + b"\x00\x00"
    import base64

    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0}, "indices": 1, "material": 0}]}],
        "materials": [{
            "pbrMetallicRoughness": {"baseColorFactor": [1, 1, 1, 0.7]},
            "alphaMode": "MASK", "alphaCutoff": 0.25, "doubleSided": True,
        }],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3,
             "type": "VEC3", "min": [0, 0, 0], "max": [1, 1, 0]},
            {"bufferView": 1, "componentType": 5123, "count": 3,
             "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 36},
            {"buffer": 0, "byteOffset": 36, "byteLength": 6},
        ],
        "buffers": [{
            "byteLength": len(blob),
            "uri": "data:application/octet-stream;base64,"
                   + base64.b64encode(blob).decode(),
        }],
    }
    path = tmp_path / "m.gltf"
    path.write_text(json.dumps(doc))
    b = load_gltf(str(path))
    spec = b.materials[0]
    assert spec.alpha_mode == 1
    assert spec.alpha_cutoff == 0.25
    assert spec.double_sided is True
    assert abs(spec.alpha_factor - 0.7) < 1e-6
