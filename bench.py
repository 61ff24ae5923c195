#!/usr/bin/env python
"""Headline benchmark: ms/frame and rays/s at 1440p 1spp on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Baseline (BASELINE.md): the reference targets 30 fps at 1440p on an RTX 3090
(33.3 ms/frame). vs_baseline = baseline_ms / our_ms (>1 = faster than the
reference's target).

Configurable via env:
  BENCH_W/BENCH_H   resolution         (default 2560x1440)
  BENCH_DEPTH       max path depth     (default 5, ≙ reference Config.json)
  BENCH_FRAMES      timed frames       (default 8)
  BENCH_BOXES       procedural boxes   (default 600 ≈ 7.5k tris)
  BENCH_STAGES      1 = also print the per-stage breakdown (stderr)
  BENCH_GRAD        1 = measure backward/forward ratio instead of ms/frame
"""
from __future__ import annotations

import json
import os
import sys
import time


def main() -> int:
    import jax

    from lumenrenderer_tpu.utils import compile_cache, device

    device.require_gpu()          # no CPU fallback: numbers name their card
    compile_cache.enable()

    w = int(os.environ.get("BENCH_W", 2560))
    h = int(os.environ.get("BENCH_H", 1440))
    depth = int(os.environ.get("BENCH_DEPTH", 5))
    frames = int(os.environ.get("BENCH_FRAMES", 8))
    boxes = int(os.environ.get("BENCH_BOXES", 600))
    accel = os.environ.get("BENCH_ACCEL", "tiled")
    scene_kind = os.environ.get("BENCH_SCENE", "interior")  # interior|mega|restir

    from lumenrenderer_tpu.integrator.wavefront import RenderConfig
    from lumenrenderer_tpu.render.renderer import Renderer
    from lumenrenderer_tpu.scene import presets

    use_restir = scene_kind == "restir"
    if scene_kind == "mega":
        scene, camf = presets.mega_scene(n_tris=int(os.environ.get("BENCH_TRIS", 1_000_000)))
    elif use_restir:
        scene, camf = presets.interior_scene(n_boxes=boxes, n_lights=256)
    else:
        scene, camf = presets.interior_scene(n_boxes=boxes, n_lights=64)
    sc, cam = scene.build(), camf(w / h)
    cfg = RenderConfig(
        width=w, height=h, max_depth=depth, bsdf="disney",
        light_strategy="nee" if use_restir else "mis", use_restir=use_restir,
    )
    cluster = int(os.environ.get("BENCH_CLUSTER", 128))
    mv = os.environ.get("BENCH_MV", "auto")
    mv = int(mv) if mv != "auto" else mv
    r = Renderer(sc, cfg, accel=accel, cluster_size=cluster, max_visits=mv)

    if os.environ.get("BENCH_GRAD") == "1":
        return bench_grad(r, sc, cam, cfg, frames)

    st = r.init_state(0)
    # warmup / compile
    st, aux = r.render_frame(st, cam)
    t0 = time.perf_counter()
    for _ in range(frames):
        st, aux = r.render_frame(st, cam)
    jax.block_until_ready(st.accum)
    dt = (time.perf_counter() - t0) / frames
    ms = dt * 1e3
    rays_per_s = w * h / dt  # primary paths (1spp) per second
    baseline_ms = 1000.0 / 30.0
    # visit-list truncation flag: the headline number must not silently
    # drop hits
    overflow = bool(aux["overflow"]) if "overflow" in aux else None
    result = {
        "metric": (
            f"ms/frame {w}x{h}@1spp depth{depth} ({sc.num_triangles} tris, "
            f"disney+{'ReSTIR' if use_restir else 'MIS'}, {accel})"
        ),
        "value": round(ms, 2),
        "unit": "ms",
        "vs_baseline": round(baseline_ms / ms, 3),
        "rays_per_s": round(rays_per_s),
        "overflow": overflow,
        "device": device.describe(),
    }
    if os.environ.get("BENCH_STAGES") == "1":
        for k, v in r.profile_stages(cam, reps=3).items():
            print(f"  {k:44s} {v:9.2f} ms", file=sys.stderr)
    print(json.dumps(result))
    return 0


def bench_grad(r, sc, cam, cfg, frames: int) -> int:
    from lumenrenderer_tpu.utils import device

    """Backward/forward wall ratio through the full frame (BASELINE's
    differentiable-rendering metric): grad of mean image luminance w.r.t.
    every material's emissive radiance (the differentiable light path)."""
    import jax
    import jax.numpy as jnp

    import dataclasses

    from lumenrenderer_tpu.integrator import wavefront

    key = jax.random.PRNGKey(0)
    # remat: recompute depths >= 1 in backward — 1440p residuals are
    # ~dozens of 56 MB (N,3) temps per depth
    cfg = dataclasses.replace(cfg, remat=True)

    def fwd(em):
        sc2 = sc.replace(materials=sc.materials.replace(emissive=em))
        out = wavefront.render_wavefront(
            sc2, r._isect, r._occl, cam, key, jnp.int32(0), cfg
        )
        return jnp.mean(wavefront.merge_channels(out))

    rad = sc.materials.emissive
    jf = jax.jit(fwd)
    jg = jax.jit(jax.grad(fwd))

    def timed(fn, arg):
        out = jax.block_until_ready(fn(arg))
        t0 = time.perf_counter()
        for _ in range(frames):
            out = fn(arg)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / frames * 1e3, out

    t_f, _ = timed(jf, rad)
    t_g, g = timed(jg, rad)
    finite = bool(jnp.all(jnp.isfinite(g)))
    result = {
        "metric": f"backward/forward ratio {cfg.width}x{cfg.height} depth{cfg.max_depth}",
        "value": round(t_g / t_f, 3),
        "unit": "x",
        "vs_baseline": round(3.0 / (t_g / t_f), 3),  # BASELINE: <=3x target
        "forward_ms": round(t_f, 2),
        "backward_ms": round(t_g, 2),
        "grads_finite": finite,
        "device": device.describe(),
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
