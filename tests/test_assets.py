"""Asset pipeline tests: glTF loader, scene cache, transforms, config, CLI."""
import base64
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from lumenrenderer_tpu.core.transform import Transform, quat_from_axis_angle
from lumenrenderer_tpu.scene import cache as cache_mod
from lumenrenderer_tpu.scene import presets
from lumenrenderer_tpu.scene.gltf import load_gltf
from lumenrenderer_tpu.utils.config import AppConfig


def _write_test_gltf(path, emissive=False):
    """Minimal glTF: two triangles (a quad), positions+normals+uv, indexed."""
    pos = np.array(
        [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32
    )
    nrm = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    blob = pos.tobytes() + nrm.tobytes() + uv.tobytes() + idx.tobytes()
    mat = {
        "pbrMetallicRoughness": {
            "baseColorFactor": [0.8, 0.2, 0.1, 1.0],
            "metallicFactor": 0.0,
            "roughnessFactor": 0.7,
        }
    }
    if emissive:
        mat["emissiveFactor"] = [1.0, 2.0, 3.0]
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [
            {
                "uri": "data:application/octet-stream;base64,"
                + base64.b64encode(blob).decode(),
                "byteLength": len(blob),
            }
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 48},
            {"buffer": 0, "byteOffset": 48, "byteLength": 48},
            {"buffer": 0, "byteOffset": 96, "byteLength": 32},
            {"buffer": 0, "byteOffset": 128, "byteLength": 12},
        ],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 2, "componentType": 5126, "count": 4, "type": "VEC2"},
            {"bufferView": 3, "componentType": 5123, "count": 6, "type": "SCALAR"},
        ],
        "materials": [mat],
        "meshes": [
            {
                "primitives": [
                    {
                        "attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
                        "indices": 3,
                        "material": 0,
                    }
                ]
            }
        ],
        "nodes": [
            {"mesh": 0, "translation": [1.0, 0.0, 0.0]},
        ],
        "scenes": [{"nodes": [0]}],
        "scene": 0,
    }
    with open(path, "w") as f:
        json.dump(doc, f)


def test_gltf_load_geometry(tmp_path):
    p = str(tmp_path / "quad.gltf")
    _write_test_gltf(p)
    sc = load_gltf(p).build()
    assert sc.num_triangles == 2
    # node translation applied: x in [1,2]
    tp = np.asarray(sc.tri_pos).reshape(-1, 3)
    assert tp[:, 0].min() >= 1.0 - 1e-6 and tp[:, 0].max() <= 2.0 + 1e-6
    np.testing.assert_allclose(
        np.asarray(sc.materials.base_color)[0], [0.8, 0.2, 0.1], atol=1e-6
    )
    np.testing.assert_allclose(float(np.asarray(sc.materials.roughness)[0]), 0.7)


def test_gltf_emissive_becomes_light(tmp_path):
    p = str(tmp_path / "em.gltf")
    _write_test_gltf(p, emissive=True)
    sc = load_gltf(p).build()
    assert int(sc.lights.count) == 2  # both quad triangles are lights


def test_scene_cache_roundtrip(tmp_path):
    builder, _ = presets.cornell_box()
    sc = builder.build()
    p = str(tmp_path / "scene.npz")
    cache_mod.save_scene(p, sc)
    sc2 = cache_mod.load_scene(p)
    np.testing.assert_allclose(np.asarray(sc.tri_pos), np.asarray(sc2.tri_pos))
    np.testing.assert_allclose(
        np.asarray(sc.materials.emissive), np.asarray(sc2.materials.emissive)
    )
    assert int(sc2.lights.count) == int(sc.lights.count)
    assert sc2.volumes is None


def test_load_or_build_uses_cache(tmp_path):
    p = str(tmp_path / "quad.gltf")
    _write_test_gltf(p)
    sc1 = cache_mod.load_or_build(p)
    assert os.path.exists(p + cache_mod.CACHE_EXT)
    sc2 = cache_mod.load_or_build(p)  # second load from cache
    np.testing.assert_allclose(np.asarray(sc1.tri_pos), np.asarray(sc2.tri_pos))


def test_transform_hierarchy_and_dirty_callbacks():
    parent = Transform(translation=(1, 0, 0))
    child = Transform(translation=(0, 1, 0))
    child.set_parent(parent)
    np.testing.assert_allclose(child.world_matrix[:3, 3], [1, 1, 0], atol=1e-6)
    fired = []
    child.add_dependent(lambda: fired.append(1))
    parent.translation = (2, 0, 0)  # parent edit invalidates child
    np.testing.assert_allclose(child.world_matrix[:3, 3], [2, 1, 0], atol=1e-6)
    assert fired  # dependency callback fired (≙ AS-rebuild trigger)
    # rotation: 90 deg about z maps +y offset to -x
    parent.rotation = quat_from_axis_angle((0, 0, 1), np.pi / 2)
    w = child.world_matrix[:3, 3]
    np.testing.assert_allclose(w, [2 - 1, 0, 0], atol=1e-5)


def test_app_config_roundtrip(tmp_path):
    p = str(tmp_path / "cfg.json")
    cfg = AppConfig.load(p)  # missing -> defaults written
    assert os.path.exists(p)
    cfg.spp = 7
    cfg.save(p)
    cfg2 = AppConfig.load(p)
    assert cfg2.spp == 7
    assert cfg2.render_resolution == (1280, 720)


def test_cli_end_to_end(tmp_path):
    out = str(tmp_path / "cli.png")
    env = dict(os.environ)
    r = subprocess.run(
        [
            sys.executable, "-m", "lumenrenderer_tpu.app.cli",
            "--preset", "cornell", "--spp", "2", "--size", "32x32",
            "--out-size", "64x64", "--depth", "2", "-o", out, "--cpu", "--aovs",
        ],
        capture_output=True, text=True, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        timeout=500,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(out)
    assert os.path.exists(out.replace(".png", ".albedo.png"))
    with open(out, "rb") as f:
        head = f.read(24)
    # IHDR width/height: the upscaled output resolution
    assert struct.unpack(">II", head[16:24]) == (64, 64)
