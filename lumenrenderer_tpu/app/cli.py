"""Command-line renderer application.

Equivalent of the Sandbox application (`Sandbox/src/
Application.cpp:66-165`): reads a JSON config (≙ Config.json), builds the
scene (glTF or preset), instantiates the renderer, renders progressively,
and writes PNG output + optional AOV snapshots. The interactive GL/ImGui
shell is a non-goal (SURVEY §7); headless progressive rendering with
camera paths replaces it.

Usage:
  python -m lumenrenderer_tpu.app.cli [config.json]
  python -m lumenrenderer_tpu.app.cli --preset cornell --spp 64 -o out.png
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def build_scene(cfg):
    from ..scene import presets

    if cfg.scene_path:
        from ..scene.cache import load_or_build
        from ..core.camera import Camera

        scene = load_or_build(cfg.scene_path)
        # frame the scene: look at bbox center from a corner offset
        import numpy as np

        lo = np.asarray(scene.tri_pos).reshape(-1, 3).min(0)
        hi = np.asarray(scene.tri_pos).reshape(-1, 3).max(0)
        c = (lo + hi) / 2
        ext = float(np.linalg.norm(hi - lo))
        w, h = cfg.render_resolution
        cam = Camera.look_at(
            eye=tuple(c + np.array([0.4, 0.3, 1.0]) * ext),
            target=tuple(c),
            fov_y_deg=45.0,
            aspect=w / h,
        )
        return scene, cam
    w, h = cfg.render_resolution
    maker = {
        "cornell": lambda: presets.cornell_box(bsdf_extras=True),
        "interior": lambda: presets.interior_scene(),
        "furnace": lambda: presets.furnace_scene(),
    }[cfg.preset]
    builder, camf = maker()
    return builder.build(), camf(w / h)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="lumenrenderer_tpu headless renderer")
    p.add_argument("config", nargs="?", help="JSON config path (written with defaults if missing)")
    p.add_argument("--preset", default=None)
    p.add_argument("--scene", default=None, help="glTF/GLB path")
    p.add_argument("--spp", type=int, default=None)
    p.add_argument("--size", default=None, help="WxH render resolution")
    p.add_argument("--out-size", default=None, help="WxH output resolution (upscaled)")
    p.add_argument("--depth", type=int, default=None)
    p.add_argument("--restir", action="store_true")
    p.add_argument("--denoise", action="store_true")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--aovs", action="store_true", help="also dump AOV PNGs")
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend (Pallas kernels interpreted)")
    p.add_argument("--debug-checks", action="store_true",
                   help="NaN/Inf guard: abort naming the first bad stage")
    p.add_argument("--no-mipmaps", action="store_true")
    p.add_argument("--transmittance", choices=("riemann", "ratio"),
                   default=None, help="volume shadow transmittance estimator")
    p.add_argument("--stats-every", type=int, default=0,
                   help="refresh per-stage FrameStats every N frames")
    p.add_argument("--mesh", action="store_true",
                   help="shard the frame over all visible devices")
    p.add_argument("--distributed", action="store_true",
                   help="multi-host: call jax.distributed.initialize first")
    args = p.parse_args(argv)

    if args.distributed:
        from ..parallel import distributed

        distributed.initialize()
        print(f"distributed: {distributed.process_info()}", file=sys.stderr)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from ..utils import compile_cache

    compile_cache.enable()

    from ..utils.config import AppConfig

    cfg = AppConfig.load(args.config) if args.config else AppConfig()
    if args.preset:
        cfg.preset = args.preset
    if args.scene:
        cfg.scene_path = args.scene
    if args.spp:
        cfg.spp = args.spp
    if args.size:
        w, h = args.size.lower().split("x")
        cfg.render_resolution = (int(w), int(h))
    if args.out_size:
        w, h = args.out_size.lower().split("x")
        cfg.output_resolution = (int(w), int(h))
    if args.depth:
        cfg.max_depth = args.depth
    if args.restir:
        cfg.use_restir = True
    if args.denoise:
        cfg.denoise = True
    if args.output:
        cfg.output_path = args.output

    import jax.numpy as jnp

    from ..integrator.wavefront import RenderConfig
    from ..render import tonemap
    from ..render.renderer import Renderer
    from ..utils.profiling import FrameStats, Profiler

    scene, cam = build_scene(cfg)
    w, h = cfg.render_resolution
    rc = RenderConfig(
        width=w, height=h, max_depth=cfg.max_depth, bsdf=cfg.bsdf,
        light_strategy=cfg.light_strategy, use_restir=cfg.use_restir,
        debug_checks=args.debug_checks, mipmaps=not args.no_mipmaps,
        volume_transmittance=args.transmittance or "riemann",
    )
    mesh = None
    if args.mesh:
        import jax

        from ..parallel import shard

        mesh = shard.make_mesh(jax.devices())
        print(f"mesh: {mesh}", file=sys.stderr)
    renderer = Renderer(scene, rc, accel=cfg.accel, mesh=mesh,
                        stats_every=args.stats_every, interpret=args.cpu)
    print(
        f"scene: {scene.num_triangles} tris, {int(scene.lights.count)} lights; "
        f"{w}x{h} depth={cfg.max_depth} spp={cfg.spp} "
        f"restir={cfg.use_restir} accel={cfg.accel}",
        file=sys.stderr,
    )
    st = renderer.init_state(cfg.seed)
    prof = Profiler()
    aux = {}
    for i in range(cfg.spp):
        st, aux = renderer.render_frame(st, cam)
        fs = FrameStats(i)
        fs.times_ms = {
            k: v for k, v in renderer.get_last_frame_stats().items() if k != "Frame"
        }
        prof.add(fs)
        if (i + 1) % 8 == 0 or i == 0:
            print(
                f"frame {i+1}/{cfg.spp}  "
                f"{renderer.get_last_frame_stats()['Total Frame Time']:.1f} ms",
                file=sys.stderr,
            )

    img = st.accum
    if cfg.denoise:
        from ..render.denoise import denoise_frame

        img = denoise_frame(img, aux, w, h)
    hw_img = jnp.asarray(img).reshape(h, w, 3)
    ow, oh = cfg.output_resolution
    if (ow, oh) != (w, h):
        from ..render.upscale import upscale

        hw_img = upscale(hw_img, oh, ow)
    tm = tonemap.tonemap_aces if cfg.tonemap == "aces" else tonemap.tonemap_gamma
    u8 = tonemap.to_uint8(tm(hw_img, exposure=cfg.exposure))
    tonemap.save_png(cfg.output_path, np.asarray(u8))
    print(f"wrote {cfg.output_path}", file=sys.stderr)

    if args.aovs:
        base = cfg.output_path.rsplit(".", 1)[0]
        for name in ("albedo", "normal", "depth"):
            a = np.asarray(aux[name])
            if a.ndim == 1:
                a = a / max(a.max(), 1e-6)
                a = np.stack([a] * 3, -1)
            a = np.abs(a).reshape(h, w, 3)
            tonemap.save_png(
                f"{base}.{name}.png",
                np.asarray(tonemap.to_uint8(jnp.asarray(np.clip(a, 0, 1)))),
            )
        print(f"wrote AOVs {base}.{{albedo,normal,depth}}.png", file=sys.stderr)
    print(f"mean stage times: {prof.summary()}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
