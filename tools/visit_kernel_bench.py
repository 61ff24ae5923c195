#!/usr/bin/env python
"""Visit kernel against the plain-XLA scan, on the GPU, at bench shapes.

Scene and frame are the bench's: `presets.interior_scene(600 boxes, 64
lights)`, 2560x1440, depth 5, Disney + MIS, clusters of 128 triangles.
Measures, for one primary closest pass, one sorted bounce pass and one
sorted shadow pass:

- the whole pass (culling + visit loop + decode) with the Pallas kernel and
  with the scan (`max_visits = C`, so the scan never truncates);
- the kernel alone (`kernel_inputs` prepared beforehand);
- agreement of the two: same hit set, triangle ids equal or t within 2^-8
  relative, occlusion bits equal.

`--sweep` also times the kernel alone over block shapes, warp counts and
culling; `--frame` times the whole frame with each intersector.

Prints one JSON line per measurement and writes them all to
chiprun_out/visit_kernel_bench.json. Run: python tools/visit_kernel_bench.py
[--sweep] [--frame]
"""
from __future__ import annotations

import argparse
import functools
import json
import statistics
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

RESULTS = []
# (rows per program, triangles per chunk, warps)
SWEEP = [(8, 64, 2), (16, 128, 4), (8, 32, 2), (4, 64, 1), (8, 64, 1),
         (8, 128, 2)]


def emit(**rec):
    RESULTS.append(rec)
    print(json.dumps(rec), flush=True)


def timed(fn, *args, reps=5):
    import jax

    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), out


def run_passes(sc, cam, cs, w, h, sweep):
    import jax
    import numpy as np

    from lumenrenderer_tpu.accel import passes as passes_mod
    from lumenrenderer_tpu.accel import tiled
    from lumenrenderer_tpu.ops.pallas import intersect as pk

    agreement = passes_mod.agreement
    c = cs.num_clusters
    passes = jax.jit(passes_mod.make_passes, static_argnums=(3, 4))(
        sc, cam, cs, w, h)
    for name, (o, d, tn, tx) in passes.items():
        closest = passes_mod.CLOSEST[name]
        live = int(np.asarray(tx >= tn).sum())
        fn = tiled.intersect_closest if closest else tiled.intersect_any
        kern = jax.jit(functools.partial(fn, cs, max_visits=c))
        scan = jax.jit(functools.partial(fn, cs, max_visits=c,
                                         method="scan"))
        t_k, r_k = timed(kern, o, d, tn, tx)
        inp = tiled.kernel_inputs(cs, o, d, tn, tx, max_visits=c)
        nv = np.asarray(inp["nv"])
        k_bits, _, low_bits = tiled._key_layout(cs.tris_per_cluster, c)
        call = functools.partial(
            pk.visit_scan, k=cs.tris_per_cluster, tile=tiled.RAY_TILE,
            mv=c, k_bits=k_bits, low_bits=low_bits, closest=closest)
        t_only, _ = timed(call, inp["rays"], cs.tri_feat, inp["sel"],
                          inp["nv"], inp["tnb"])
        t_s, r_s = timed(scan, o, d, tn, tx, reps=2)
        emit(phase="pass", name=name, rays=int(o.shape[0]), live=live,
             kernel_pass_ms=t_k, kernel_only_ms=t_only, scan_pass_ms=t_s,
             mean_visits=float(nv.mean()), max_visits=int(nv.max()),
             overflow=bool(r_k["overflow"]) if closest else None,
             **agreement(r_k, r_s, closest))
        if not sweep:
            continue
        for rb, kb, nw in SWEEP:
            try:
                t, _ = timed(functools.partial(call, rb=rb, kb=kb,
                                               num_warps=nw),
                             inp["rays"], cs.tri_feat, inp["sel"],
                             inp["nv"], inp["tnb"])
                emit(phase="sweep", name=name, rb=rb, kb=kb, num_warps=nw,
                     kernel_only_ms=t)
            except Exception as e:  # a config the compiler refuses
                emit(phase="sweep", name=name, rb=rb, kb=kb, num_warps=nw,
                     error=repr(e)[:300])
        for culling in ("dense", "frustum"):
            inp2 = tiled.kernel_inputs(cs, o, d, tn, tx, max_visits=c,
                                       culling=culling)
            t_c, _ = timed(jax.jit(functools.partial(
                fn, cs, max_visits=c, culling=culling)), o, d, tn, tx)
            t_o, _ = timed(call, inp2["rays"], cs.tri_feat, inp2["sel"],
                           inp2["nv"], inp2["tnb"])
            emit(phase="culling", name=name, culling=culling,
                 kernel_pass_ms=t_c, kernel_only_ms=t_o,
                 mean_visits=float(np.asarray(inp2["nv"]).mean()))
    return passes


def run_frame(sc, cam, cs, w, h, depth):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from lumenrenderer_tpu.accel import tiled
    from lumenrenderer_tpu.integrator import wavefront

    c = cs.num_clusters
    cfg = wavefront.RenderConfig(width=w, height=h, max_depth=depth,
                                 bsdf="disney", light_strategy="mis")
    scan_isect = functools.partial(tiled.intersect_closest, cs, max_visits=c,
                                   method="scan", decode=False)
    scan_occl = functools.partial(tiled.intersect_any, cs, max_visits=c,
                                  method="scan")
    variants = {
        "kernel": tiled.tiled_intersectors(cs, max_visits=min(c, 128),
                                           decode=False),
        "scan": (lambda o, d, tn, tx: {
            q: v for q, v in scan_isect(o, d, tn, tx).items()
            if q in ("t", "tri", "u", "v", "overflow")}, scan_occl),
    }
    for name in ("kernel", "scan", "kernel"):
        isect, occl = variants[name]

        def frame(key, isect=isect, occl=occl):
            out = wavefront.render_wavefront(sc, isect, occl, cam, key,
                                             jnp.int32(0), cfg)
            return wavefront.merge_channels(out), out["overflow"]

        f = jax.jit(frame)
        t0 = time.perf_counter()
        img, ovf = jax.block_until_ready(f(jax.random.PRNGKey(0)))
        first = (time.perf_counter() - t0) * 1e3
        t, (img, ovf) = timed(f, jax.random.PRNGKey(1),
                              reps=3 if name == "kernel" else 1)
        emit(phase="frame", name=name, ms=t, first_call_ms=first,
             overflow=bool(ovf), finite=bool(np.isfinite(np.asarray(img)).all()),
             mean=float(np.asarray(img).mean()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--frame", action="store_true")
    ap.add_argument("--size", default="2560x1440")
    args = ap.parse_args()

    from lumenrenderer_tpu.utils import compile_cache, device

    compile_cache.enable()
    device.require_gpu()
    emit(phase="device", **device.describe())

    from lumenrenderer_tpu.accel import stream
    from lumenrenderer_tpu.scene import presets

    w, h = (int(x) for x in args.size.split("x"))
    builder, camf = presets.interior_scene(n_boxes=600, n_lights=64)
    sc, cam = builder.build(), camf(w / h)
    cs = stream.build_clusters(sc.tri_pos, cluster_size=128)
    emit(phase="scene", tris=int(sc.num_triangles), clusters=cs.num_clusters)
    ok = True
    for phase, fn in [
        ("passes", lambda: run_passes(sc, cam, cs, w, h, args.sweep)),
        ("frame", lambda: args.frame and run_frame(sc, cam, cs, w, h, 5)),
    ]:
        try:
            fn()
        except Exception:  # report the phase, run the next one
            ok = False
            emit(phase=phase, error=traceback.format_exc()[-2000:])
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "visit_kernel_bench.json").write_text(json.dumps(RESULTS, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
