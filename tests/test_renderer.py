"""High-level Renderer API tests: progressive accumulation, state, AOVs."""
import jax.numpy as jnp
import numpy as np

from lumenrenderer_tpu.integrator.wavefront import RenderConfig
from lumenrenderer_tpu.render import state as state_mod
from lumenrenderer_tpu.render import tonemap
from lumenrenderer_tpu.render.renderer import Renderer
from lumenrenderer_tpu.scene import presets


def small_renderer(accel="bvh", **kw):
    scene, camf = presets.cornell_box()
    sc, cam = scene.build(), camf(1.0)
    cfg = RenderConfig(width=24, height=24, max_depth=3, bsdf="lambert", **kw)
    return Renderer(sc, cfg, accel=accel, donate=False, interpret=True), cam


def test_progressive_accumulation_reduces_variance():
    r, cam = small_renderer()
    st = r.init_state(0)
    st, _ = r.render_frame(st, cam)
    one = np.asarray(st.accum)
    for _ in range(7):
        st, _ = r.render_frame(st, cam)
    many = np.asarray(st.accum)
    assert int(st.blend_count) == 8
    assert int(st.frame_index) == 8
    # variance of the 8-frame average must be lower: compare mean abs
    # deviation from an independent 8-frame render
    r2, _ = small_renderer()
    ref = r2.render(cam, spp=8, seed=99)
    err1 = np.abs(one.reshape(24, 24, 3) - ref).mean()
    err8 = np.abs(many.reshape(24, 24, 3) - ref).mean()
    assert err8 < err1


def test_reset_accumulation():
    r, cam = small_renderer()
    st = r.init_state(0)
    st, _ = r.render_frame(st, cam)
    st = state_mod.reset_accumulation(st)
    assert int(st.blend_count) == 0
    assert float(jnp.abs(st.accum).max()) == 0.0
    # frame index keeps increasing (Halton sequence continues)
    assert int(st.frame_index) == 1


def test_aux_aovs_present():
    r, cam = small_renderer()
    st = r.init_state(0)
    st, aux = r.render_frame(st, cam)
    for k in ("depth", "normal", "albedo", "motion"):
        assert k in aux
    d = np.asarray(aux["depth"])
    assert d.shape == (24 * 24,)
    assert (d > 0).mean() > 0.95  # nearly every pixel hits the box


def test_bvh_matches_brute_render():
    r_b, cam = small_renderer(accel="bvh")
    r_o, _ = small_renderer(accel="brute")
    img_b = r_b.render(cam, spp=12, seed=5)
    img_o = r_o.render(cam, spp=12, seed=5)
    # identical rng seeds + identical intersections -> identical images
    np.testing.assert_allclose(img_b, img_o, rtol=1e-3, atol=5e-3)


def test_tonemap_roundtrip():
    x = jnp.asarray(np.linspace(0, 2, 30, dtype=np.float32).reshape(10, 3))
    g = tonemap.tonemap_gamma(x)
    assert float(g.max()) <= 1.0
    u8 = np.asarray(tonemap.to_uint8(g))
    assert u8.dtype == np.uint8 and u8.max() == 255
    a = tonemap.tonemap_aces(x)
    assert np.all(np.isfinite(np.asarray(a)))


def test_frame_stats():
    r, cam = small_renderer()
    st = r.init_state(0)
    r.render_frame(st, cam)
    stats = r.get_last_frame_stats()
    assert "Total Frame Time" in stats and stats["Total Frame Time"] > 0


def test_profile_stages_fills_frame_stats():
    """Renderer.profile_stages surfaces the per-stage FrameStats map
    (≙ WaveFrontRenderer per-stage time map)."""
    import numpy as np
    from lumenrenderer_tpu.scene import presets
    from lumenrenderer_tpu.integrator.wavefront import RenderConfig
    from lumenrenderer_tpu.render.renderer import Renderer

    builder, camf = presets.cornell_box()
    sc, cam = builder.build(), camf(1.0)
    cfg = RenderConfig(width=32, height=32, max_depth=2)
    r = Renderer(sc, cfg, accel="sah")
    stats = r.profile_stages(cam, reps=1)
    for k in ("GeneratePrimaryRays", "Intersect (primary, coherent)",
              "Occlusion (shadow)", "ExtractSurfaceData",
              "ShadeDirect sample_light", "Total Frame Time"):
        assert k in stats and np.isfinite(stats[k]) and stats[k] >= 0.0, k
    assert r.get_last_frame_stats()["Total Frame Time"] == stats["Total Frame Time"]


def test_blend_resets_on_camera_move():
    """Progressive accumulation restarts when the camera moves (≙ the
    reference's a_FrameCount=0 restart on input, OutputLayer.cpp:519,559);
    a static camera keeps accumulating."""
    from lumenrenderer_tpu.core.camera import Camera
    from lumenrenderer_tpu.scene import presets

    scene, camf = presets.cornell_box()
    sc = scene.build()
    cfg = RenderConfig(width=16, height=16, max_depth=2, bsdf="lambert",
                       light_strategy="nee", rr_start_depth=99,
                       sort_secondary=False)
    r = Renderer(sc, cfg, accel="tiled", interpret=True, donate=False)
    cam = camf(1.0)
    st = r.init_state(0)
    st, _ = r.render_frame(st, cam)
    st, _ = r.render_frame(st, cam)
    assert int(st.blend_count) == 2          # static camera accumulates
    cam2 = Camera.look_at(eye=(0.1, 0.0, 2.5), target=(0, 0, 0),
                          fov_y_deg=60.0)
    st, _ = r.render_frame(st, cam2)
    assert int(st.blend_count) == 1          # moved -> restarted
    r2 = Renderer(sc, cfg, accel="tiled", interpret=True, donate=False,
                  reset_on_camera_move=False)
    st2 = r2.init_state(0)
    st2, _ = r2.render_frame(st2, cam)
    st2, _ = r2.render_frame(st2, cam2)
    assert int(st2.blend_count) == 2         # opt-out keeps accumulating
