#!/usr/bin/env python
"""Smoke test of the renderer on one GPU (or, with --four-gpus, on four).

Phases, in order; any failure exits non-zero and prints no result:

1. native SAH builder: `make -C native`.
2. device: JAX's first device must be a GPU (no CPU fallback); prints the
   card's name and power limit (nvidia-smi).
3. headline frame through `Renderer.render_frame`: the bench scene
   (`presets.interior_scene(600 boxes, 64 lights)`, 7,338 triangles) at
   2560x1440, depth 5, Disney + MIS, accel="tiled", default max_visits;
   1 warm-up + 3 timed frames. Asserts overflow == False, a finite image and
   mean luminance > 0; prints the median ms/frame and rays/s.
4. CLI: `cli.main` with `--preset interior --restir --size 1280x720 --spp 2`
   must write a PNG of that size.
5. kernel parity at real widths: the primary pass and a sorted bounce pass
   (closest) and a sorted shadow pass (any) at 2560x1440, Pallas visit
   kernel against the plain-XLA scan (uncapped, Precision.HIGHEST), and
   both against `accel/brute.py` on a 65,536-ray subset (TOLERANCES below).
6. gradient: `jax.grad` of the mean image w.r.t. `materials.emissive` at
   2560x1440, depth 5, remat=True, through the production intersector;
   asserts finite gradients, prints forward and backward ms.

With `--four-gpus` only the four-card phase runs: the row-sharded
progressive ReSTIR frame (`Renderer(mesh=...)`) at 2560x1440 against the
same frames on one card, then `dryrun_multichip(4)` on the cards.

The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.

Run: python chip_smoke.py [--four-gpus]
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Kernel vs scan at full width: float32 rounding decides rays that graze a
# triangle edge (u+v within an ulp of 1) differently in the kernel's FMA
# order and the scan's einsum, so a few rays per million may flip between
# hit and miss or between two co-near triangles. Against brute force on a
# 65,536-ray subset the same holds at <= 6 rays. Occlusion: the issue's
# 99.9% bound.
TOLERANCES = {
    "full_hit_set_equal": 1 - 1e-5,
    "full_tri_or_t_equal": 1 - 1e-5,
    "subset_hit_set_equal": 1 - 1e-4,
    "subset_tri_or_t_equal": 1 - 1e-4,
    "occlusion_equal": 0.999,
}
SUBSET = 65536


def say(*parts):
    print(*parts, flush=True)


def build_native():
    subprocess.run(["make", "-C", str(ROOT / "native")], check=True,
                   stdout=subprocess.DEVNULL)


def bench_scene(w, h, n_lights=64):
    from lumenrenderer_tpu.scene import presets

    builder, camf = presets.interior_scene(n_boxes=600, n_lights=n_lights)
    return builder.build(), camf(w / h)


def phase_headline(w=2560, h=1440, frames=3, interpret=False):
    import numpy as np

    from lumenrenderer_tpu.integrator.wavefront import RenderConfig
    from lumenrenderer_tpu.render.renderer import Renderer

    sc, cam = bench_scene(w, h)
    cfg = RenderConfig(width=w, height=h, max_depth=5, bsdf="disney",
                       light_strategy="mis")
    r = Renderer(sc, cfg, accel="tiled", interpret=interpret)
    st = r.init_state(0)
    t0 = time.perf_counter()
    st, aux = r.render_frame(st, cam)
    first = time.perf_counter() - t0
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        st, aux = r.render_frame(st, cam)
        times.append(time.perf_counter() - t0)
    img = np.asarray(st.accum)
    lum = float(np.mean(img @ np.asarray([0.2126, 0.7152, 0.0722])))
    overflow = bool(aux["overflow"])
    assert not overflow, "visit lists overflowed on the headline frame"
    assert np.isfinite(img).all(), "non-finite pixels"
    assert lum > 0.0, f"mean luminance {lum}"
    ms = statistics.median(times) * 1e3
    say(f"[headline] {sc.num_triangles} tris {w}x{h} depth5 disney+MIS "
        f"tiled max_visits={r._tiled_opts['max_visits']}: "
        f"{ms:.2f} ms/frame median of {frames} "
        f"({[round(t * 1e3, 2) for t in times]}), "
        f"{w * h / (ms / 1e3):.4g} rays/s, first frame {first:.1f} s, "
        f"overflow={overflow}, mean luminance {lum:.4f}")
    return ms


def phase_cli(size="1280x720"):
    from lumenrenderer_tpu.app import cli

    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "cli.png")
        t0 = time.perf_counter()
        rc = cli.main(["--preset", "interior", "--restir", "--size", size,
                       "--spp", "2", "-o", out])
        dt = time.perf_counter() - t0
        assert rc == 0, f"cli returned {rc}"
        data = Path(out).read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    w, h = (int(x) for x in size.split("x"))
    assert (int.from_bytes(data[16:20], "big"),
            int.from_bytes(data[20:24], "big")) == (w, h)
    idat = data[41:41 + int.from_bytes(data[33:37], "big")]
    assert len(zlib.decompress(idat)) == h * (1 + 3 * w)
    say(f"[cli] --preset interior --restir --size {size} --spp 2: "
        f"wrote a {w}x{h} PNG ({len(data)} bytes) in {dt:.1f} s")


def phase_parity(w=2560, h=1440, subset=SUBSET, interpret=False):
    import jax
    import numpy as np

    from lumenrenderer_tpu.accel import brute, passes, stream, tiled

    sc, cam = bench_scene(w, h)
    cs = stream.build_clusters(sc.tri_pos, cluster_size=128)
    c = cs.num_clusters
    all_passes = jax.jit(passes.make_passes, static_argnums=(3, 4, 5, 6))(
        sc, cam, cs, w, h, 0, interpret)
    bad = []
    for name in ("primary", "bounce", "shadow"):
        o, d, tn, tx = all_passes[name]
        closest = passes.CLOSEST[name]
        fn = tiled.intersect_closest if closest else tiled.intersect_any
        kern = fn(cs, o, d, tn, tx, max_visits=c, interpret=interpret)
        with jax.default_matmul_precision("highest"):
            scan = fn(cs, o, d, tn, tx, max_visits=c, method="scan")
        full = passes.agreement(kern, scan, closest)
        line = f"[parity] {name}: kernel vs scan {full}"
        if closest:
            bad += [f"{name} {k}" for k, v in full.items()
                    if v < TOLERANCES["full_" + k]]
            idx = np.linspace(0, o.shape[0] - 1, min(subset, o.shape[0]))
            idx = np.unique(idx.astype(np.int64))
            sub = lambda a: a[idx]
            ref = brute.intersect_closest(sc.tri_pos, sub(o), sub(d),
                                          sub(tn), sub(tx))
            for label, res in (("kernel", kern), ("scan", scan)):
                agree = passes.agreement(
                    {q: np.asarray(res[q])[idx] for q in ("tri", "t")},
                    ref, True)
                line += f"; {label} vs brute ({idx.size} rays) {agree}"
                bad += [f"{name} {label} vs brute {k}"
                        for k, v in agree.items()
                        if v < TOLERANCES["subset_" + k]]
        else:
            bad += [f"{name} {k}" for k, v in full.items()
                    if v < TOLERANCES[k]]
        say(line)
    assert not bad, f"parity outside tolerance: {bad}"
    say(f"[parity] within tolerances {TOLERANCES}")


def phase_gradient(w=2560, h=1440, interpret=False):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from lumenrenderer_tpu.integrator import wavefront
    from lumenrenderer_tpu.render.renderer import Renderer

    sc, cam = bench_scene(w, h)
    cfg = wavefront.RenderConfig(width=w, height=h, max_depth=5,
                                 bsdf="disney", light_strategy="mis",
                                 remat=True)
    r = Renderer(sc, cfg, accel="tiled", interpret=interpret)
    key = jax.random.PRNGKey(0)

    def fwd(em):
        sc2 = sc.replace(materials=sc.materials.replace(emissive=em))
        out = wavefront.render_wavefront(sc2, r._isect, r._occl, cam, key,
                                         jnp.int32(0), r.config)
        return jnp.mean(wavefront.merge_channels(out))

    em = sc.materials.emissive
    ms = {}
    for name, fn in (("forward", jax.jit(fwd)),
                     ("backward", jax.jit(jax.grad(fwd)))):
        out = jax.block_until_ready(fn(em))
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(em))
        ms[name] = (time.perf_counter() - t0) * 1e3
    g = np.asarray(out)
    assert np.isfinite(g).all(), "non-finite gradient"
    assert (g > 0).any(), "all-zero emission gradient"
    say(f"[gradient] d mean(image) / d emissive at {w}x{h} depth5 remat: "
        f"finite, {int((g > 0).sum())} positive entries; forward "
        f"{ms['forward']:.2f} ms, backward {ms['backward']:.2f} ms "
        f"(ratio {ms['backward'] / ms['forward']:.3f})")


def phase_four(w=2560, h=1440, frames=3, interpret=False, devices=None):
    import jax
    import numpy as np

    from lumenrenderer_tpu.integrator.wavefront import RenderConfig
    from lumenrenderer_tpu.parallel import shard
    from lumenrenderer_tpu.render.renderer import Renderer

    import __graft_entry__

    devices = devices or jax.devices()
    assert len(devices) >= 4, f"needs 4 devices, found {len(devices)}"
    sc, cam = bench_scene(w, h)
    cfg = RenderConfig(width=w, height=h, max_depth=5, bsdf="disney",
                       light_strategy="nee", use_restir=True)
    images, ms = {}, {}
    for name, mesh in (("one card", None),
                       ("4-card mesh", shard.make_mesh(devices[:4]))):
        r = Renderer(sc, cfg, accel="tiled", mesh=mesh, interpret=interpret)
        st = r.init_state(0)
        st, aux = r.render_frame(st, cam)            # compile + warm
        t0 = time.perf_counter()
        for _ in range(frames - 1):
            st, aux = r.render_frame(st, cam)
        ms[name] = (time.perf_counter() - t0) / (frames - 1) * 1e3
        assert not bool(aux["overflow"]), f"{name}: overflow"
        images[name] = np.asarray(st.accum).reshape(h, w, 3)
    assert np.isfinite(images["4-card mesh"]).all()
    assert images["4-card mesh"].mean() > 0.0
    # Per-shard RNG streams are folded by shard index, and a shard's 360
    # rows do not divide ReSTIR's 16-pixel bag tile, so the mesh takes the
    # per-pixel RIS fallback where one card takes the tile-shared one. The
    # images agree only statistically: compare the global mean and 8 row-band
    # means of the tonemapped (clamped, hence firefly-robust) images at
    # matched spp, at bounds that catch a wrong or missing shard.
    one, four = (np.clip(images[k], 0.0, 1.0) ** (1 / 2.2)
                 for k in ("one card", "4-card mesh"))
    rel = abs(four.mean() / one.mean() - 1.0)
    bands = [abs(b4.mean() / b1.mean() - 1.0) for b1, b4 in
             zip(np.array_split(one, 8), np.array_split(four, 8))]
    say(f"[four] ReSTIR {w}x{h} depth5, {frames} progressive frames: one "
        f"card {ms['one card']:.2f} ms/frame, 4-card mesh "
        f"{ms['4-card mesh']:.2f} ms/frame; mean rel diff {rel:.5f}, "
        f"row-band max rel diff {max(bands):.5f}")
    assert rel < 0.05 and max(bands) < 0.10, (rel, bands)
    __graft_entry__.dryrun_multichip(4, cpu=interpret)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the four-card sharded-frame phase")
    args = ap.parse_args(argv)

    build_native()
    sys.path.insert(0, str(ROOT))
    from lumenrenderer_tpu.utils import compile_cache, device

    devices = device.require_gpu()
    compile_cache.enable()
    say(device.card_line())
    d0 = devices[0]
    say(f"[device] {d0.platform} {d0.device_kind} x{len(devices)}")
    if args.four_gpus:
        phase_four()
    else:
        phase_headline()
        phase_cli()
        phase_parity()
        phase_gradient()
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
