"""Two-level TLAS/BLAS instancing (accel/two_level.py, round 5).

≙ the reference's per-primitive GAS + instance IAS
(`WaveFrontRenderer.cpp:1148-1252`, `PTScene.cpp:77-160`): instanced scenes
must render identically to the flattened build, accel memory must scale with
unique meshes (not instances), and dynamic edits go through an O(units)
TLAS refit.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from lumenrenderer_tpu.accel import brute, two_level
from lumenrenderer_tpu.integrator.wavefront import RenderConfig
from lumenrenderer_tpu.render.renderer import Renderer
from lumenrenderer_tpu.scene.geometry import InstanceHost, MeshHost
from lumenrenderer_tpu.scene.materials import MaterialSpec
from lumenrenderer_tpu.scene.scene import SceneBuilder


def _box_mesh(size=0.5):
    s = size
    v = np.array([[x, y, z] for x in (-s, s) for y in (-s, s)
                  for z in (-s, s)], np.float32)
    f = np.array([
        [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
        [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
        [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],
    ], np.int32)
    return MeshHost(positions=v, indices=f)


def _instanced_builder(n_inst=20, seed=5):
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    white = b.add_material(MaterialSpec(base_color=(0.7, 0.7, 0.7)))
    lightm = b.add_material(MaterialSpec(emissive=(9.0, 9.0, 9.0)))
    box = _box_mesh()
    for i in range(n_inst):
        m4 = np.eye(4, dtype=np.float32)
        ang = rng.uniform(0, 2 * np.pi)
        c, s = np.cos(ang), np.sin(ang)
        m4[:3, :3] = (np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
                      * rng.uniform(0.4, 1.2))
        m4[:3, 3] = rng.uniform(-3, 3, 3)
        b.add_instance(InstanceHost(mesh=box, transform=m4,
                                    material_override=white))
    # area light above
    lm = _box_mesh(0.8)
    m4 = np.eye(4, dtype=np.float32)
    m4[:3, 3] = [0.0, 5.0, 0.0]
    b.add_instance(InstanceHost(mesh=lm, transform=m4,
                                material_override=lightm))
    return b


def _camera():
    from lumenrenderer_tpu.core.camera import Camera

    return Camera.look_at((0.0, 1.0, 9.0), (0.0, 0.0, 0.0),
                          fov_y_deg=50.0, aspect=1.0)


def test_instanced_matches_brute_closest():
    b = _instanced_builder()
    sc = b.build()
    flat = np.asarray(sc.tri_pos)
    mesh_slot, meshes, im, tf = {}, [], [], []
    for inst in b.instances:
        k = id(inst.mesh)
        if k not in mesh_slot:
            mesh_slot[k] = len(meshes)
            meshes.append(inst.mesh.positions[inst.mesh.indices])
        im.append(mesh_slot[k])
        tf.append(inst.transform)
    ics = two_level.build_instanced(meshes, im, tf, cluster_size=32)
    # accel memory ∝ unique meshes: 21 instances, 2 unique meshes
    assert ics.tri_feat.shape[0] <= 2  # one 12-tri cluster per unique mesh
    rng = np.random.default_rng(0)
    r = 1500
    o = rng.uniform(-4, 4, (r, 3)).astype(np.float32)
    d = rng.uniform(-1, 1, (r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ref = brute.intersect_closest(flat, o, d, 1e-3, 1e8)
    isect, occl = two_level.instanced_intersectors(ics, max_visits=128,
                                                   precision="highest")
    got = isect(o, d, 1e-3, jnp.full((r,), 1e8, jnp.float32))
    assert not bool(got["overflow"])
    hr = np.isfinite(np.asarray(ref["t"]))
    hg = np.asarray(got["tri"]) >= 0
    np.testing.assert_array_equal(hr, hg)
    # virtual tri ids index the FLATTENED scene (co-near ties allowed)
    same = np.asarray(ref["tri"]) == np.asarray(got["tri"])
    assert (same | ~hr).mean() > 0.995
    occ_ref = np.asarray(brute.intersect_any(flat, o, d, 1e-3, 4.0))
    occ_got = np.asarray(occl(o, d, 1e-3, jnp.full((r,), 4.0, jnp.float32)))
    assert (occ_ref == occ_got).all()


def test_instanced_render_matches_flattened():
    b = _instanced_builder()
    sc = b.build()
    cfg = RenderConfig(width=64, height=64, max_depth=3, bsdf="lambert",
                       light_strategy="nee", sort_secondary=False)
    cam = _camera()
    r_flat = Renderer(sc, cfg, accel="tiled", cluster_size=32,
                      interpret=True)
    r_inst = Renderer(sc, cfg, accel="two_level", cluster_size=32,
                      builder=b)
    img_a = r_flat.render(cam, spp=4, seed=1)
    img_b = r_inst.render(cam, spp=4, seed=1)
    # identical RNG + geometry: images differ only by co-near winner ties
    diff = np.abs(img_a - img_b).mean()
    scale = np.abs(img_a).mean() + 1e-6
    assert diff / scale < 2e-3, diff / scale


def test_refit_matches_rebuild():
    rng = np.random.default_rng(2)
    meshes = [rng.uniform(-0.5, 0.5, (30, 3, 3)).astype(np.float32)]
    tfs = []
    for i in range(6):
        m4 = np.eye(4, dtype=np.float32)
        m4[:3, 3] = rng.uniform(-2, 2, 3)
        tfs.append(m4)
    ics = two_level.build_instanced(meshes, [0] * 6, tfs, cluster_size=32)
    tfs2 = [t.copy() for t in tfs]
    tfs2[2][:3, 3] += [0.7, -0.3, 0.2]
    refit = two_level.refit_instances(ics, jnp.asarray(np.stack(tfs2)))
    rebuilt = two_level.build_instanced(meshes, [0] * 6, tfs2,
                                        cluster_size=32)
    np.testing.assert_allclose(np.asarray(refit.aabb_lo),
                               np.asarray(rebuilt.aabb_lo), atol=1e-5)
    np.testing.assert_allclose(np.asarray(refit.inst_minv),
                               np.asarray(rebuilt.inst_minv), atol=1e-5)


def test_dynamic_instance_move_via_tlas():
    """≙ test_dynamic's transform-edit flow, but through the two-level path:
    moving an instance refits the TLAS (O(units)) and the image follows."""
    from lumenrenderer_tpu.scene.dynamic import DynamicScene

    b = _instanced_builder(n_inst=8)
    dyn = DynamicScene(b)
    sc = dyn.build()
    cfg = RenderConfig(width=48, height=48, max_depth=2, bsdf="lambert",
                       light_strategy="nee", sort_secondary=False)
    cam = _camera()
    r = Renderer(sc, cfg, accel="two_level", cluster_size=32,
                 builder=b, dynamic=dyn)
    st = r.init_state(0)
    st, _ = r.render_frame(st, cam)
    img0 = np.asarray(st.accum).copy()
    # move instance 0 far out of view -> image must change
    dyn.transform(0).translation = (50.0, 0.0, 0.0)
    assert dyn.dirty
    st = r.init_state(0)
    st, _ = r.render_frame(st, cam)
    img1 = np.asarray(st.accum)
    assert not np.allclose(img0, img1)
    # and match a from-scratch build at the new transforms
    b2 = _instanced_builder(n_inst=8)
    b2.instances[0].transform = (
        np.array([[1, 0, 0, 50], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                 np.float32) @ b2.instances[0].transform)
    sc2 = b2.build()
    r2 = Renderer(sc2, cfg, accel="two_level", cluster_size=32,
                  builder=b2)
    st2 = r2.init_state(0)
    st2, _ = r2.render_frame(st2, cam)
    img2 = np.asarray(st2.accum)
    diff = np.abs(img1 - img2).mean() / (np.abs(img2).mean() + 1e-6)
    assert diff < 2e-3, diff
