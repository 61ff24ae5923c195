"""Pallas kernel (Triton route): fused, visit-adaptive ray-tile × cluster
intersection for the tiled intersector (`accel/tiled.py`).

Stands in for the reference's `optixLaunch` traversal
(`OptixWrapper.cpp:543-567` + `Shaders/WaveFrontShaders.cu:42-112`): instead
of RT cores walking a BVH per ray, blocks of rays test whole SAH clusters of
K triangles with Möller–Trumbore lifted to a bilinear form. The plain-JAX
version of the same loop (`accel/tiled.py::_scan_keys`) has to run
`max_visits` steps for every tile and writes a (tiles, 128, 4K) candidate
tensor to device memory at every step; this kernel keeps it on chip:

- grid = (ray tiles, rays per tile // RB): one program per RB-ray block.
  Each program reads its tile's visit count and visit list itself and loops
  over exactly those visits (`while_loop`), so dead tiles cost ~nothing.
- per visit it loads the cluster's Möller–Trumbore coefficient rows from
  the (C, 10, 4K) table in KB-triangle chunks. Only the 19 rows that
  `stream.build_clusters` fills are read (det: rows 3-5, u and v: rows 0-5,
  t: rows 6-9); the table is ~2 MB at 7k triangles and stays in L2.
- det/u/v/t are float32 multiply-adds on the SM's FP32 units, not a `dot`:
  exact float32, no TF32 rounding, and no tensor-core shape constraints
  (the contraction is only 10 deep).
- a narrow per-ray accumulator: the packed winner key (closest) or the
  occlusion bit (any), folded with one row reduction per chunk.
- ordered early-out: visits arrive sorted by conservative entry t; once
  every live ray's best hit is nearer than the next cluster's entry, the
  loop stops (closest). For occlusion it stops once every live ray is
  blocked. The check runs after every visit (a reduction over RB rays).

The kernel returns ONLY the packed key per ray (or the occlusion bit);
winner t/u/v are re-derived outside with one coefficient gather (shared with
the scan path in accel/tiled.py).

Packed key layout (shared with accel/tiled.py): positive-float t bits in the
high bits (order-preserving), visit step and intra-cluster triangle id in the
low `low_bits`; min(key) = nearest hit to ~2^-(23-low_bits) relative t.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

KEY_MISS = 0x7F000000  # python int: kernels must not capture traced constants

# Rows of the (10, 4K) cluster feature block that `build_clusters` fills, per
# quantity block [det | u | v | t]; every other row of that block is zero.
# Ray feature rows are [o×d (0-2), d (3-5), o (6-8), 1 (9)].
FEATURE_ROWS = ((3, 4, 5), (0, 1, 2, 3, 4, 5), (0, 1, 2, 3, 4, 5),
                (6, 7, 8, 9))

# Block shape and launch settings, chosen on the card (PERF.md): small
# register tiles win — (RB, KB) = (8, 64) is 8 values per thread per
# quantity at 2 warps.
ROW_BLOCK = 8      # rays per program
K_BLOCK = 64       # triangles per chunk
NUM_WARPS = 2


def _make_kernel(*, k: int, kb: int, rb: int, tile: int, mv: int,
                 k_bits: int, low_bits: int, closest: bool):
    low_mask = ~((1 << low_bits) - 1)

    def kernel(nv_ref, sel_ref, tnb_ref, rays_ref, feats_ref, out_ref):
        t = pl.program_id(0)
        rows = pl.ds(t * tile + pl.program_id(1) * rb, rb)
        ray = [rays_ref[j, rows] for j in range(12)]          # 12 x (RB,)
        rf = [r[:, None] for r in ray[:10]]                    # (RB, 1)
        tmin = ray[10][:, None]
        tmax = ray[11][:, None]
        live = ray[11] >= ray[10]                              # (RB,)
        n = nv_ref[t]
        kid = jax.lax.broadcasted_iota(jnp.int32, (rb, kb), 1)

        def visit(i, acc):
            c = sel_ref[t, i]
            for k0 in range(0, k, kb):
                q = []
                for blk, frows in enumerate(FEATURE_ROWS):
                    cols = pl.ds(blk * k + k0, kb)
                    s = None
                    for j in frows:
                        term = rf[j] * feats_ref[c, j, cols][None, :]
                        s = term if s is None else s + term
                    q.append(s)                                # (RB, KB)
                det, un, vn, tn = q
                sg = jnp.where(det < 0.0, -1.0, 1.0)
                ad = det * sg                                  # |det|
                us = un * sg
                vs = vn * sg
                ts = tn * sg
                hit = ((ad > 1e-12) & (us >= 0.0) & (vs >= 0.0)
                       & (us + vs <= ad) & (ts > tmin * ad)
                       & (ts <= tmax * ad))
                if closest:
                    tval = ts / jnp.where(hit, ad, 1.0)
                    tb = jax.lax.bitcast_convert_type(
                        jnp.maximum(tval, 0.0), jnp.int32)
                    key = (tb & low_mask) | (i << k_bits) | (kid + k0)
                    key = jnp.where(hit, key, KEY_MISS)
                    acc = jnp.minimum(acc, jnp.min(key, axis=1))
                else:
                    acc = jnp.maximum(
                        acc, jnp.max(hit.astype(jnp.int32), axis=1))
            return acc

        def finished(i, acc):
            if closest:
                # dead rays report 0 so they never hold the loop open
                best = jnp.max(jnp.where(live, acc, 0)) >> low_bits
                nxt = tnb_ref[t, jnp.minimum(i + 1, mv - 1)] >> low_bits
                return best < nxt
            return jnp.min(jnp.where(live, acc, 1)) > 0

        def cond(carry):
            i, done, _ = carry
            return (i < n) & (done == 0)

        def body(carry):
            i, _, acc = carry
            acc = visit(i, acc)
            return i + 1, finished(i, acc).astype(jnp.int32), acc

        acc0 = jnp.full((rb,), KEY_MISS if closest else 0, jnp.int32)
        _, _, acc = jax.lax.while_loop(
            cond, body, (jnp.int32(0), jnp.int32(0), acc0))
        if not closest:
            acc = jnp.where(live, acc, 0)
        out_ref[rows] = acc

    return kernel


@partial(jax.jit, static_argnames=("k", "tile", "mv", "k_bits", "low_bits",
                                   "closest", "interpret", "rb", "kb",
                                   "num_warps"))
def visit_scan(rays, feats, sel, nv, tnb, *, k: int, tile: int, mv: int,
               k_bits: int, low_bits: int, closest: bool,
               interpret: bool = False, rb: int = ROW_BLOCK,
               kb: int = K_BLOCK, num_warps: int = NUM_WARPS):
    """Run the fused visit loop.

    rays:  (12, R) f32 — rows 0-9 Möller–Trumbore ray features, row 10 per-ray
           t_min, row 11 per-ray t_max (t_max < t_min = dead ray). R is a
           multiple of `tile`; ray tile t is rays [t*tile, (t+1)*tile).
    feats: (C, 10, 4K) f32 cluster coefficients (ClusterSet.tri_feat).
    sel:   (T, mv) i32 cluster ids per visit (sorted by entry t).
    nv:    (T,) i32 live visit count per tile.
    tnb:   (T, mv) i32 conservative entry-t float bits (KEY_MISS = invalid).

    Returns (R,) i32 — closest: packed winner keys (KEY_MISS = miss, dead rays
    included); any: occlusion 0/1.

    The output is discrete and `pallas_call` has no JVP rule, so a live
    tangent on any input would crash `jax.grad`. A custom_jvp runs the primal
    and emits a symbolic-zero (float0) tangent: traversal is
    non-differentiable by design (hit ids are detached; exact t/u/v are
    re-derived differentiably downstream).
    """
    impl = partial(_visit_call, k=k, tile=tile, mv=mv, k_bits=k_bits,
                   low_bits=low_bits, closest=closest, interpret=interpret,
                   rb=rb, kb=kb, num_warps=num_warps)

    @jax.custom_jvp
    def call(rays, feats, sel, nv, tnb):
        return impl(rays, feats, sel, nv, tnb)

    @call.defjvp
    def _call_jvp(primals, tangents):
        out = call(*primals)
        return out, np.zeros(out.shape, jax.dtypes.float0)

    return call(rays, feats, sel, nv, tnb)


def _visit_call(rays, feats, sel, nv, tnb, *, k, tile, mv, k_bits, low_bits,
                closest, interpret, rb, kb, num_warps):
    r = rays.shape[1]
    tiles = r // tile
    rb = min(rb, tile)
    kb = min(kb, k)
    assert r % tile == 0 and tile % rb == 0 and k % kb == 0, (r, tile, rb, k)
    for size in (rb, kb):
        assert size & (size - 1) == 0, f"block sizes must be powers of 2: {size}"
    kernel = _make_kernel(k=k, kb=kb, rb=rb, tile=tile, mv=mv, k_bits=k_bits,
                          low_bits=low_bits, closest=closest)
    return pl.pallas_call(
        kernel,
        grid=(tiles, tile // rb),
        out_shape=jax.ShapeDtypeStruct((r,), jnp.int32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="visit_closest" if closest else "visit_any",
    )(nv.astype(jnp.int32), sel.astype(jnp.int32), tnb.astype(jnp.int32),
      rays, feats)
