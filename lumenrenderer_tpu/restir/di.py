"""ReSTIR direct illumination — reservoir spatiotemporal resampling.

JAX re-architecture of the reference's ReSTIR stack:
host orchestrator `ReSTIR::Run` (`Framework/ReSTIR.cpp:65-233`) and kernels
(`CUDAKernels/ReSTIRKernels.cu`): CDF build (:49-130), light-bag fill
(:327-370), per-pixel RIS of 32 candidates (:372-522), visibility
(:524-582), reservoir shading (:584-665), temporal reuse with motion-vector
reprojection and 20x M-clamp (:983-1121), spatial reuse 2 iterations x 5
neighbours in 30px with depth/normal similarity gates (:745-980), biased
combine (:1123-1257).

Differences:
- thrust sort + inclusive_scan CDF → `jnp.cumsum` + `searchsorted` (the
  reference's own algorithm, minus the radiance sort which only existed to
  help its binary search).
- The per-SM light-bag cache trick (`__mysmid`, ReSTIRKernels.cu:425-433)
  has no analogue at the XLA level (no SM-local shared memory); bags are
  kept (they bound gather fan-out into the big light table and decorrelate
  candidates exactly like the reference) and assigned per PIXEL TILE so a
  tile's candidate gathers hit one small bag — the locality equivalent.
- All reservoir state is a pytree (checkpointable; SURVEY §5.4) and every
  pass is a dense masked array op — no atomics, no ping-pong buffer pairs
  (functional updates replace `SwapBuffers`, ReSTIR.cpp:264-274).
- Everything is differentiable w.r.t. light radiance: W-weights are
  stop-gradient (sampling machinery) while the shaded contribution stays
  attached — ReSTIR gradients flow to emission parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from ..core import vecmath as vm
from ..scene.scene import SceneData
from ..utils import struct

SHADOW_EPS = 1e-3


@dataclasses.dataclass(frozen=True)
class RestirConfig:
    """Mirror of `ReSTIRSettings` (`Shaders/CppCommon/ReSTIRData.h:25-66`)."""

    candidates: int = 32          # primary samples per reservoir
    num_bags: int = 50
    bag_size: int = 1000
    # ONE candidate set per bag_tile instead of per pixel — candidate
    # light rows broadcast across the tile's pixels in a tile-major layout
    # instead of 8.4M-row gathers. Each pixel still runs its own RIS
    # pick with its own target pdfs, so every reservoir stays a valid RIS
    # estimator (unbiasedness needs candidates ~ bag distribution, not
    # cross-pixel independence); cross-pixel noise inside a tile correlates,
    # which fresh bags + temporal/spatial reuse decorrelate. False = the
    # reference's per-pixel draws (ReSTIRKernels.cu:372-522).
    tile_candidates: bool = True
    spatial_samples: int = 5
    spatial_radius: int = 30
    spatial_iterations: int = 2
    temporal_clamp: int = 20      # max M multiple kept from history
    biased: bool = True           # reference default (ReSTIRKernels.cu:1108)
    bag_tile: int = 16            # pixel tile sharing one light bag
    depth_gate: float = 0.1       # relative depth similarity (reuse gates)
    normal_gate: float = 0.906    # cos(25 deg), reuse normal gate


@struct.dataclass
class Reservoir:
    """Per-pixel reservoir (R=1), ≙ `Reservoir` struct (`ReSTIRData.h`)."""

    light_idx: jnp.ndarray  # (N,) i32 chosen light row
    bary: jnp.ndarray       # (N,2) sample point barycentric (u,v on light tri)
    w_sum: jnp.ndarray      # (N,) sum of RIS weights
    m: jnp.ndarray          # (N,) f32 candidate count
    w_out: jnp.ndarray      # (N,) unbiased contribution weight W
    p_hat: jnp.ndarray      # (N,) target pdf of the chosen sample


@struct.dataclass
class RestirState:
    """Temporal history: previous reservoirs + gbuffer for similarity gates
    and for the unbiased combine's re-evaluation at the history surface
    (≙ the prev-frame pixel data CombineUnbiased reads,
    `ReSTIRKernels.cu:1123-1199`)."""

    reservoir: Reservoir
    prev_depth: jnp.ndarray    # (N,)
    prev_normal: jnp.ndarray   # (N,3)
    prev_position: jnp.ndarray # (N,3) world position (unbiased re-eval)
    prev_albedo: jnp.ndarray   # (N,) albedo luminance (unbiased re-eval)
    valid: jnp.ndarray         # () bool history valid (False on first frame)


def empty_reservoir(n: int) -> Reservoir:
    # NOTE: four distinct zero arrays — sharing one buffer breaks jit
    # donation ("attempt to donate the same buffer twice")
    return Reservoir(
        light_idx=jnp.zeros((n,), jnp.int32),
        bary=jnp.zeros((n, 2), jnp.float32),
        w_sum=jnp.zeros((n,), jnp.float32),
        m=jnp.zeros((n,), jnp.float32),
        w_out=jnp.zeros((n,), jnp.float32),
        p_hat=jnp.zeros((n,), jnp.float32),
    )


def init_state(n: int) -> RestirState:
    return RestirState(
        reservoir=empty_reservoir(n),
        prev_depth=jnp.zeros((n,), jnp.float32),
        prev_normal=jnp.zeros((n, 3), jnp.float32),
        prev_position=jnp.zeros((n, 3), jnp.float32),
        prev_albedo=jnp.zeros((n,), jnp.float32),
        valid=jnp.asarray(False),
    )


# ---------------------------------------------------------------------------
# CDF + light bags
# ---------------------------------------------------------------------------

def build_light_cdf(scene: SceneData, rad_all=None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Power-weighted CDF over lights. ≙ BuildCDF (`ReSTIR.cpp:235-262`):
    weights = luminance * area; cumsum replaces thrust::inclusive_scan.
    (Shared implementation with NEE: integrator.nee.build_light_cdf.)"""
    from ..integrator import nee as nee_mod

    return nee_mod.build_light_cdf(scene, rad_all)


def sample_cdf(cdf: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    return jnp.clip(
        jnp.searchsorted(cdf, u, side="right"), 0, cdf.shape[0] - 1
    ).astype(jnp.int32)


def fill_light_bags(cdf: jnp.ndarray, cfg: RestirConfig, key) -> jnp.ndarray:
    """(num_bags, bag_size) light rows sampled from the CDF.
    ≙ FillLightBags (`ReSTIRKernels.cu:327-370`)."""
    u = jax.random.uniform(key, (cfg.num_bags, cfg.bag_size))
    return sample_cdf(cdf, u)


# ---------------------------------------------------------------------------
# target pdf
# ---------------------------------------------------------------------------

def _target_phat(scene, sd, light_idx, bary, rad_all=None, detach_radiance=True,
                 at_position=None, at_normal=None, at_albedo_lum=None,
                 prow=None):
    """Unshadowed target p-hat in AREA measure at the pixel's surface:
    luminance(albedo/pi * L * cos_s * cos_l / d^2). ≙ the `Resample`
    re-evaluation (`ReSTIRKernels.cu:1259-1325`), with a Lambertian f
    approximation for the resampling target (full BSDF still shades).
    rad_all: optional dense (L,3) radiance table (one gather instead of 4).
    at_*: evaluate at a different surface than sd's (unbiased combine
    re-evaluates the winner at each contributing neighbour's surface,
    ≙ CombineUnbiased `ReSTIRKernels.cu:1123-1199`)."""
    lights = scene.lights
    li = jnp.maximum(light_idx, 0)
    if prow is None:
        prow = lights.packed[li]                   # ONE gather
    # (callers that already gathered the packed rows pass them in — the
    # r5 ReSTIR profile showed this gather was ~45% of ris_primary)
    p = (
        prow[..., 0:3]
        + bary[..., 0:1] * prow[..., 3:6]
        + bary[..., 1:2] * prow[..., 6:9]
    )
    rad = rad_all[li] if rad_all is not None else scene.light_radiance(li)
    if detach_radiance:
        rad = jax.lax.stop_gradient(rad)
    pos = at_position if at_position is not None else sd.position
    nrm = at_normal if at_normal is not None else sd.normal
    alb = (
        at_albedo_lum
        if at_albedo_lum is not None
        else vm.luminance(sd.base_color)
    )
    to_l = p - pos[..., None, :] if p.ndim == pos.ndim + 1 else p - pos
    dist = jnp.maximum(vm.length(to_l), 1e-5)
    wi = to_l / dist[..., None]
    if p.ndim == nrm.ndim + 1:
        cos_s = jnp.maximum(vm.dot(nrm[..., None, :], wi), 0.0)
    else:
        cos_s = jnp.maximum(vm.dot(nrm, wi), 0.0)
    albedo_lum = alb / jnp.pi
    if p.ndim == albedo_lum.ndim + 2:
        albedo_lum = albedo_lum[..., None]
    cos_l = jnp.maximum(vm.dot(prow[..., 9:12], -wi), 0.0)
    g = cos_s * cos_l / (dist * dist)
    return albedo_lum * vm.luminance(rad) * g, wi, dist


# ---------------------------------------------------------------------------
# passes
# ---------------------------------------------------------------------------

def _ris_primary_tiled(scene, sd, bags, bag_pdf, cfg: RestirConfig, width,
                       key, rad_all=None):
    """Tile-candidate RIS (round 5, `RestirConfig.tile_candidates`): ONE
    candidate set per bag_tile, pixels laid out tile-major so candidate
    light rows BROADCAST across the tile instead of being gathered per
    pixel (the per-pixel path's (N,C,16) packed-row gather was ~45% of
    ris_primary at 512²). Every pixel still evaluates its own target pdfs
    and runs its own categorical pick, so each reservoir remains a valid
    per-pixel RIS estimator."""
    n = sd.position.shape[0]
    c = cfg.candidates
    bt = cfg.bag_tile
    height = n // width
    ty, tx = height // bt, width // bt
    t = ty * tx
    p_tile = bt * bt
    kb, kc, kp, kr = jax.random.split(key, 4)
    bag_t = jax.random.randint(kb, (t,), 0, cfg.num_bags)
    slot_t = jax.random.randint(kc, (t, c), 0, cfg.bag_size)
    cand_light = bags[bag_t[:, None], slot_t][:, None, :]       # (T,1,C)
    pdf_sel = bag_pdf[cand_light]                               # (T,1,C)
    bs = jax.random.uniform(kp, (t, 1, c, 2))
    su = jnp.sqrt(bs[..., 0])
    bary = jnp.stack([1.0 - su, bs[..., 1] * su], axis=-1)      # (T,1,C,2)
    prow = scene.lights.packed[jnp.maximum(cand_light, 0)]      # (T,1,C,16)
    area = prow[..., 12]
    p_cand = pdf_sel / jnp.maximum(area, 1e-12)

    def to_tiles(x):
        img = x.reshape((ty, bt, tx, bt) + x.shape[1:])
        return jnp.moveaxis(img, 2, 1).reshape((t, p_tile) + x.shape[1:])

    def from_tiles(x):
        img = x.reshape((ty, tx, bt, bt) + x.shape[2:])
        return jnp.moveaxis(img, 1, 2).reshape((n,) + x.shape[2:])

    pos_t = to_tiles(sd.position)                               # (T,P,3)
    nrm_t = to_tiles(sd.normal)
    alb_t = to_tiles(vm.luminance(sd.base_color))               # (T,P)
    phat, _, _ = _target_phat(
        scene, None, cand_light, bary, rad_all=rad_all, prow=prow,
        at_position=pos_t, at_normal=nrm_t, at_albedo_lum=alb_t,
    )                                                           # (T,P,C)
    w = jnp.where(p_cand > 0, phat / jnp.maximum(p_cand, 1e-20), 0.0)
    w_sum = jnp.sum(w, axis=-1)                                 # (T,P)
    u = jax.random.uniform(kr, (t, p_tile, 1))
    cum = jnp.cumsum(w, axis=-1)
    pick = jnp.sum((cum < u * w_sum[..., None]).astype(jnp.int32), axis=-1)
    pick = jnp.clip(pick, 0, c - 1)

    def take(a):  # a (T,1,C,...) candidate-major -> (T,P,...) per pixel
        ab = jnp.broadcast_to(a, (t, p_tile) + a.shape[2:])
        idx = pick.reshape(t, p_tile, *([1] * (a.ndim - 2)))
        idx = jnp.broadcast_to(idx, (t, p_tile, 1) + a.shape[3:])
        return jnp.take_along_axis(ab, idx, axis=2)[:, :, 0]

    chosen_light = take(cand_light)
    chosen_bary = take(bary)
    chosen_phat = jnp.take_along_axis(phat, pick[..., None], axis=-1)[..., 0]
    w_out = jnp.where(
        chosen_phat > 0, w_sum / (c * jnp.maximum(chosen_phat, 1e-20)), 0.0
    )
    return Reservoir(
        light_idx=from_tiles(chosen_light),
        bary=from_tiles(chosen_bary),
        w_sum=from_tiles(w_sum),
        m=jnp.full((n,), float(c), jnp.float32),
        w_out=from_tiles(w_out),
        p_hat=from_tiles(chosen_phat),
    )


def ris_primary(scene, sd, bags, bag_pdf, cfg: RestirConfig, width, key,
                rad_all=None):
    """Per-pixel RIS of `candidates` bag samples.
    ≙ PickPrimarySamples (`ReSTIRKernels.cu:372-522`)."""
    n = sd.position.shape[0]
    c = cfg.candidates
    height = n // width
    if (cfg.tile_candidates and width % cfg.bag_tile == 0
            and height % cfg.bag_tile == 0 and n == width * height):
        return _ris_primary_tiled(scene, sd, bags, bag_pdf, cfg, width, key,
                                  rad_all=rad_all)
    # tile-coherent bag assignment
    px = jnp.arange(n, dtype=jnp.int32) % width
    py = jnp.arange(n, dtype=jnp.int32) // width
    tile = (py // cfg.bag_tile) * 1024 + (px // cfg.bag_tile)
    kb, kc, kp, kr = jax.random.split(key, 4)
    # all pixels in a tile share a bag (coherent gathers — the analogue
    # of the reference's per-SM bag cache)
    bag_of_tile = jax.random.randint(kb, (1 << 16,), 0, cfg.num_bags)
    bag_idx = bag_of_tile[tile % bag_of_tile.shape[0]]

    slot = jax.random.randint(kc, (n, c), 0, cfg.bag_size)
    cand_light = bags[bag_idx[:, None], slot]            # (N,C)
    cand_pdf_sel = bag_pdf[cand_light]                   # (N,C) CDF pdf
    cand_bary_sqrt = jax.random.uniform(kp, (n, c, 2))
    # uniform triangle warp
    su = jnp.sqrt(cand_bary_sqrt[..., 0])
    b1 = 1.0 - su
    b2 = cand_bary_sqrt[..., 1] * su
    bary = jnp.stack([b1, b2], axis=-1)                  # (N,C,2) e1/e2 coords

    prow_c = scene.lights.packed[jnp.maximum(cand_light, 0)]  # ONE (N,C,16)
    area = prow_c[..., 12]
    p_cand = cand_pdf_sel / jnp.maximum(area, 1e-12)     # area-measure pdf
    phat, _, _ = _target_phat(scene, sd, cand_light, bary, rad_all=rad_all,
                              prow=prow_c)
    w = jnp.where(p_cand > 0, phat / jnp.maximum(p_cand, 1e-20), 0.0)  # (N,C)

    # streaming reservoir update, vectorized over pixels via cumulative trick:
    # choose candidate j with prob w_j / sum_{k<=j} w_k sequentially ==
    # categorical with prob w_j / w_sum — use Gumbel-free direct sampling.
    w_sum = jnp.sum(w, axis=1)
    u = jax.random.uniform(kr, (n, 1))
    cum = jnp.cumsum(w, axis=1)
    pick = jnp.sum((cum < u * w_sum[:, None]).astype(jnp.int32), axis=1)
    pick = jnp.clip(pick, 0, c - 1)
    take = lambda a: jnp.take_along_axis(a, pick[:, None], axis=1)[:, 0]
    chosen_light = take(cand_light)
    chosen_bary = jnp.take_along_axis(
        bary, pick[:, None, None].repeat(2, -1), axis=1
    )[:, 0]
    chosen_phat = take(phat)
    w_out = jnp.where(
        chosen_phat > 0, w_sum / (c * jnp.maximum(chosen_phat, 1e-20)), 0.0
    )
    return Reservoir(
        light_idx=chosen_light,
        bary=chosen_bary,
        w_sum=w_sum,
        m=jnp.full((n,), float(c), jnp.float32),
        w_out=w_out,
        p_hat=chosen_phat,
    )


def visibility_pass(scene, sd, res: Reservoir, occlude_fn, hit_mask,
                    rad_all=None):
    """Zero reservoirs whose chosen sample is occluded (binary visibility
    only — ≙ VisibilityCheck + RESTIR_RAY raygen, `ReSTIR.cpp:291-317`,
    `WaveFrontShaders.cu:181-216`). Participating-media transmittance is NOT
    folded into the stored weight: reservoirs persist through reuse and
    frames, so a multiplicative transmittance would compound each pass —
    it is applied once at shading instead (see `volumetric_transmittance`)."""
    phat, wi, dist = _target_phat(scene, sd, res.light_idx, res.bary,
                                  rad_all=rad_all)
    o = sd.position + sd.geo_normal * SHADOW_EPS
    occluded = occlude_fn(
        o, wi, jnp.asarray(SHADOW_EPS, jnp.float32), dist - 2 * SHADOW_EPS
    )
    kill = occluded | ~hit_mask
    return res.replace(
        w_out=jnp.where(kill, 0.0, res.w_out),
        w_sum=jnp.where(kill, 0.0, res.w_sum),
    )


def volumetric_transmittance(scene, sd, res: Reservoir, volumes, key,
                             hit_mask):
    """Beer-Lambert transmittance along the winner's shadow segment
    (≙ the volumetric shadow rays of `WaveFrontRenderer.cpp:858-871`),
    applied once at shading time."""
    from ..volume import march as vmarch

    _, wi, dist = _target_phat(scene, sd, res.light_idx, res.bary)
    o = sd.position + sd.geo_normal * SHADOW_EPS
    return jax.lax.stop_gradient(
        vmarch.transmittance_only(
            volumes, o, wi, jnp.asarray(SHADOW_EPS, jnp.float32),
            jnp.where(hit_mask, dist - 2 * SHADOW_EPS, 0.0), key=key,
        )
    )


def _combine(scene, sd, res_a: Reservoir, res_b: Reservoir, phat_b_here, key,
             rad_all=None, unbiased_at=None):
    """Combine B into A at A's pixel (target pdfs re-evaluated at A's
    surface). ≙ CombineBiased (`ReSTIRKernels.cu:1201-1257`) when
    `unbiased_at` is None; with `unbiased_at=(pos_b, nrm_b, alb_b)` (stream
    B's own surface) it is CombineUnbiased (`ReSTIRKernels.cu:1123-1199`):
    the M denominator becomes Z = sum of stream M's at whose surface the
    winner has nonzero target pdf."""
    w_a = res_a.p_hat * res_a.w_out * res_a.m
    w_b = phat_b_here * res_b.w_out * res_b.m
    w_sum = w_a + w_b
    u = jax.random.uniform(key, w_sum.shape)
    pick_b = u * jnp.maximum(w_sum, 1e-20) > w_a
    light = jnp.where(pick_b, res_b.light_idx, res_a.light_idx)
    bary = jnp.where(pick_b[:, None], res_b.bary, res_a.bary)
    phat = jnp.where(pick_b, phat_b_here, res_a.p_hat)
    m = res_a.m + res_b.m
    if unbiased_at is None:
        denom_m = m
    else:
        pos_b, nrm_b, alb_b = unbiased_at
        phat_at_b, _, _ = _target_phat(
            scene, sd, light, bary, rad_all=rad_all,
            at_position=pos_b, at_normal=nrm_b, at_albedo_lum=alb_b,
        )
        denom_m = res_a.m * (phat > 0) + res_b.m * (phat_at_b > 0)
    w_out = jnp.where(
        phat > 0,
        w_sum / (jnp.maximum(denom_m, 1e-6) * jnp.maximum(phat, 1e-20)),
        0.0,
    )
    return Reservoir(
        light_idx=light, bary=bary, w_sum=w_sum, m=m, w_out=w_out, p_hat=phat
    )


def temporal_pass(scene, sd, res, state: RestirState, motion, cfg, width,
                  height, key, rad_all=None):
    """Motion-vector reprojected history combine with M clamp + similarity
    gates. ≙ TemporalNeighbourSampling (`ReSTIRKernels.cu:983-1121`).
    cfg.biased=False re-evaluates the winner at the history surface
    (≙ CombineUnbiased)."""
    n = res.m.shape[0]
    px = (jnp.arange(n) % width).astype(jnp.float32)
    py = (jnp.arange(n) // width).astype(jnp.float32)
    prev_x = jnp.round(px + motion[:, 0]).astype(jnp.int32)
    prev_y = jnp.round(py + motion[:, 1]).astype(jnp.int32)
    inside = (
        (prev_x >= 0) & (prev_x < width) & (prev_y >= 0) & (prev_y < height)
    )
    prev_i = jnp.clip(prev_y * width + prev_x, 0, n - 1)

    hist = state.reservoir
    h = jax.tree_util.tree_map(lambda a: a[prev_i], hist)
    # similarity gates
    d_ok = jnp.abs(state.prev_depth[prev_i] - sd_depth(sd)) <= (
        cfg.depth_gate * jnp.maximum(sd_depth(sd), 1e-3)
    )
    n_ok = vm.dot(state.prev_normal[prev_i], sd.normal) >= cfg.normal_gate
    ok = inside & d_ok & n_ok & state.valid
    # clamp history M (20x)
    m_cap = cfg.temporal_clamp * jnp.maximum(res.m, 1.0)
    scale = jnp.minimum(1.0, m_cap / jnp.maximum(h.m, 1e-6))
    h = h.replace(m=h.m * scale, w_sum=h.w_sum * scale)
    h = jax.tree_util.tree_map(
        lambda a: jnp.where(
            ok.reshape(ok.shape + (1,) * (a.ndim - 1)), a, jnp.zeros_like(a)
        ),
        h,
    )
    phat_here, _, _ = _target_phat(scene, sd, h.light_idx, h.bary,
                                   rad_all=rad_all)
    phat_here = jnp.where(ok, phat_here, 0.0)
    unbiased_at = None
    if not cfg.biased:
        unbiased_at = (
            state.prev_position[prev_i],
            state.prev_normal[prev_i],
            state.prev_albedo[prev_i],
        )
    return _combine(scene, sd, res, h, phat_here, key, rad_all=rad_all,
                    unbiased_at=unbiased_at)


def sd_depth(sd):
    return vm.length(sd.position)  # radial depth proxy for similarity


def spatial_pass(scene, sd, res, hit_mask, cfg, width, height, key,
                 rad_all=None, halo=None):
    """`spatial_iterations` rounds of `spatial_samples` random neighbours in
    `spatial_radius`, combine with similarity gates.
    ≙ SpatialNeighbourSampling (`ReSTIRKernels.cu:745-980`) — the ping-pong
    buffer pair becomes a functional fold, and the per-neighbour loop is
    vectorized to ONE (N,S) batch per iteration (all neighbour reservoirs
    gathered at once, all target pdfs in one broadcast evaluation).
    cfg.biased=False re-evaluates the winner at every contributing
    neighbour's surface (≙ CombineUnbiased, `ReSTIRKernels.cu:1123-1199`).

    halo=(axis_name, n_shards): row-sharded execution under shard_map
    (round 5, VERDICT #10). Each iteration exchanges a `spatial_radius`-row
    band of gbuffer + CURRENT reservoirs with the neighbouring shards (two
    `lax.ppermute`s per array) so seam rows see their full two-sided
    neighbourhood instead of clamping at the shard edge; edge shards
    receive zero bands (hit_mask False) which the gates discard — exactly
    the true-image-border behaviour. ≙ spatial reuse radius 30px
    (`ReSTIRKernels.cu:745-980`) which assumes one unpartitioned screen."""
    s = cfg.spatial_samples
    if halo is not None:
        axis, nsh = halo
        band = min(cfg.spatial_radius, height)

        def ext(x):
            img = x.reshape((height, width) + x.shape[1:])
            top = jax.lax.ppermute(
                img[height - band:], axis,
                [(j, j + 1) for j in range(nsh - 1)])
            bot = jax.lax.ppermute(
                img[:band], axis, [(j, j - 1) for j in range(1, nsh)])
            return jnp.concatenate([top, img, bot], axis=0).reshape(
                (-1,) + x.shape[1:])

        def interior(x):
            img = x.reshape((h_ext, width) + x.shape[1:])
            return img[band:band + height].reshape((-1,) + x.shape[1:])

        h_ext = height + 2 * band
        pos = ext(sd.position)
        nrm = ext(sd.normal)
        alb = ext(sd.base_color)
        hit = ext(hit_mask)
    else:
        ext = interior = lambda x: x
        h_ext = height
        pos, nrm, alb, hit = sd.position, sd.normal, sd.base_color, hit_mask
    n = width * h_ext
    px = (jnp.arange(n) % width).astype(jnp.int32)
    py = (jnp.arange(n) // width).astype(jnp.int32)
    depth_here = vm.length(pos)
    alb_lum = vm.luminance(alb)
    import types as _types

    sd_here = _types.SimpleNamespace(position=pos, normal=nrm,
                                     base_color=alb)
    # ONE packed neighbour row per gather (round 5 profile: six separate
    # reservoir-leaf gathers + depth/normal/hit gathers were the pass cost
    # driver): reservoir dynamics repack per iteration, gbuffer cols once
    static_cols = [depth_here[:, None], nrm, hit.astype(jnp.float32)[:, None]]
    if not cfg.biased:
        static_cols += [pos, alb_lum[:, None]]
    static_pack = jnp.concatenate(static_cols, axis=1)

    for it in range(cfg.spatial_iterations):
        kit = jax.random.fold_in(key, it)
        # snapshot: neighbours come from the previous iteration's buffer,
        # matching the reference's ping-pong pair (ReSTIR.cpp:264-274);
        # halo mode refreshes the band from the neighbour shard's UPDATED
        # interior before every iteration
        src = jax.tree_util.tree_map(ext, res)
        packed = jnp.concatenate([
            jax.lax.bitcast_convert_type(
                src.light_idx, jnp.float32)[:, None],
            src.bary,
            src.w_out[:, None],
            src.m[:, None],
            static_pack,
        ], axis=1)
        k1, k2, k3 = jax.random.split(kit, 3)
        ang = jax.random.uniform(k1, (n, s)) * 2 * jnp.pi
        rad = jnp.sqrt(jax.random.uniform(k2, (n, s))) * cfg.spatial_radius
        nx = jnp.clip(px[:, None] + (jnp.cos(ang) * rad).astype(jnp.int32),
                      0, width - 1)
        ny = jnp.clip(py[:, None] + (jnp.sin(ang) * rad).astype(jnp.int32),
                      0, h_ext - 1)
        ni = ny * width + nx                                   # (N,S)
        nbp = packed[ni]                                       # (N,S,K) ONE
        nb = _types.SimpleNamespace(
            light_idx=jax.lax.bitcast_convert_type(nbp[..., 0], jnp.int32),
            bary=nbp[..., 1:3],
            w_out=nbp[..., 3],
            m=nbp[..., 4],
        )
        d_nb = nbp[..., 5]
        nrm_nb = nbp[..., 6:9]
        hit_nb = nbp[..., 9] > 0.5
        d_ok = jnp.abs(d_nb - depth_here[:, None]) <= (
            cfg.depth_gate * jnp.maximum(depth_here[:, None], 1e-3)
        )
        n_ok = vm.dot(nrm_nb, nrm[:, None, :]) >= cfg.normal_gate
        ok = d_ok & n_ok & hit[:, None] & hit_nb               # (N,S)
        phat_nb, _, _ = _target_phat(scene, sd_here, nb.light_idx, nb.bary,
                                     rad_all=rad_all)
        phat_nb = jnp.where(ok, phat_nb, 0.0)
        w_nb = jnp.where(ok, phat_nb * nb.w_out * nb.m, 0.0)   # (N,S)
        m_nb = jnp.where(ok, nb.m, 0.0)

        # categorical pick over {self} + S neighbours in one pass
        w_self = src.p_hat * src.w_out * src.m                 # (N,)
        w_all = jnp.concatenate([w_self[:, None], w_nb], axis=1)  # (N,S+1)
        cum = jnp.cumsum(w_all, axis=1)
        w_sum = cum[:, -1]
        u = jax.random.uniform(k3, (n, 1))
        pick = jnp.sum((cum < u * w_sum[:, None]).astype(jnp.int32), axis=1)
        pick = jnp.clip(pick, 0, s)
        lights_all = jnp.concatenate(
            [src.light_idx[:, None], nb.light_idx], axis=1
        )
        bary_all = jnp.concatenate([src.bary[:, None], nb.bary], axis=1)
        phat_all = jnp.concatenate([src.p_hat[:, None], phat_nb], axis=1)
        take = lambda a: jnp.take_along_axis(a, pick[:, None], axis=1)[:, 0]
        best_light = take(lights_all)
        best_bary = jnp.take_along_axis(
            bary_all, pick[:, None, None].repeat(2, -1), axis=1
        )[:, 0]
        best_phat = take(phat_all)

        m_tot = src.m + jnp.sum(m_nb, axis=1)
        if cfg.biased:
            denom_m = m_tot
        else:
            # CombineUnbiased: Z = sum of stream Ms at whose own surface the
            # winner's target pdf is nonzero — one more broadcast evaluation
            # of the winner at the S neighbour surfaces
            phat_win_at_nb, _, _ = _target_phat(
                scene, sd_here,
                jnp.broadcast_to(best_light[:, None], (n, s)),
                jnp.broadcast_to(best_bary[:, None, :], (n, s, 2)),
                rad_all=rad_all,
                at_position=nbp[..., 10:13],
                at_normal=nrm_nb,
                at_albedo_lum=nbp[..., 13],
            )
            denom_m = src.m * (best_phat > 0) + jnp.sum(
                m_nb * (jnp.where(ok, phat_win_at_nb, 0.0) > 0), axis=1
            )
        w_out = jnp.where(
            best_phat > 0,
            w_sum / (jnp.maximum(denom_m, 1e-6) * jnp.maximum(best_phat, 1e-20)),
            0.0,
        )
        res = jax.tree_util.tree_map(interior, Reservoir(
            light_idx=best_light,
            bary=best_bary,
            w_sum=w_sum,
            m=m_tot,
            w_out=w_out,
            p_hat=best_phat,
        ))
    return res


def shade(scene, sd, wo, res: Reservoir, eval_f, hit_mask, rad_all=None):
    """Final reservoir shading into the DIRECT channel.
    ≙ Shade (`ReSTIRKernels.cu:584-665`): contribution = f * L * G * W.
    Radiance stays differentiable; W is sampling machinery (detached)."""
    lights = scene.lights
    li = jnp.maximum(res.light_idx, 0)
    prow = lights.packed[li]
    p = prow[:, 0:3] + res.bary[:, 0:1] * prow[:, 3:6] + res.bary[:, 1:2] * prow[:, 6:9]
    to_l = p - sd.position
    dist = jnp.maximum(vm.length(to_l), 1e-5)
    wi = to_l / dist[:, None]
    cos_s = jnp.maximum(vm.dot(sd.normal, wi), 0.0)
    cos_l = jnp.maximum(vm.dot(prow[:, 9:12], -wi), 0.0)
    g = cos_s * cos_l / (dist * dist)
    rad = rad_all[li] if rad_all is not None else scene.light_radiance(li)
    f_val, _ = eval_f(sd, wo, wi)
    w = jax.lax.stop_gradient(res.w_out)
    scale = jnp.where(hit_mask & (w > 0), jax.lax.stop_gradient(g) * w, 0.0)
    return f_val * rad * scale[:, None]


# ---------------------------------------------------------------------------
# orchestrator
# ---------------------------------------------------------------------------

class RestirDI:
    """Callable pipeline bound to (occlude_fn, eval_f, cfg, W, H).

    Invoked from the wavefront loop at depth 0 (≙ `Shade`'s depth-0 branch,
    `CPUShadingKernels.cu:128-148`)."""

    def __init__(self, occlude_fn, eval_f, cfg: RestirConfig, width: int,
                 height: int, halo=None):
        """halo=(axis_name, n_shards): under a row-sharded mesh, spatial
        reuse halo-exchanges its seam bands (see spatial_pass)."""
        self.occlude_fn = occlude_fn
        self.eval_f = eval_f
        self.cfg = cfg
        self.width = width
        self.height = height
        self.halo = halo

    def init_state(self, n: int) -> RestirState:
        return init_state(n)

    def __call__(self, scene, sd, wo, hit_mask, motion, state: RestirState,
                 key, occlude_fn=None):
        cfg = self.cfg
        # dynamic scenes thread the CURRENT frame's occluder (rebaked
        # clusters); the bound one is the static-scene default
        occl = occlude_fn if occlude_fn is not None else self.occlude_fn
        k_bag, k_ris, k_t, k_s, k_v1, k_v2 = jax.random.split(key, 6)
        # dense differentiable radiance once per frame: every pass below
        # gathers from it instead of re-deriving per-sample (round-2's
        # dangling rad_all plumbing, now actually wired)
        from ..integrator import nee as nee_mod

        rad_all = nee_mod.all_light_radiance(scene)
        cdf, pdf = build_light_cdf(scene, rad_all)
        bags = fill_light_bags(cdf, cfg, k_bag)
        res = ris_primary(scene, sd, bags, pdf, cfg, self.width, k_ris,
                          rad_all=rad_all)
        if cfg.biased:
            # visibility REUSE (≙ the reference's biased default,
            # ReSTIR.cpp:291-317): occluded reservoirs are zeroed before
            # reuse — their dead M still counts in neighbours' denominators,
            # which is exactly the accepted bias of this mode. Unbiased mode
            # skips it (visibility is applied only at final shading, and the
            # combine's Z-denominator handles stream mismatch).
            res = visibility_pass(scene, sd, res, occl, hit_mask,
                                  rad_all=rad_all)
        if state is not None:
            res = temporal_pass(
                scene, sd, res, state, motion, cfg, self.width, self.height,
                k_t, rad_all=rad_all,
            )
        res = spatial_pass(
            scene, sd, res, hit_mask, cfg, self.width, self.height, k_s,
            rad_all=rad_all, halo=self.halo,
        )
        # final visibility on the post-reuse winner (biased mode shades
        # without it in the reference; we match the reference default but
        # keep it correct for newly-imported samples via one check). The
        # participating-media transmittance rides the same pass
        # (≙ volumetric shadow rays, WaveFrontRenderer.cpp:858-871).
        res_final = visibility_pass(scene, sd, res, occl, hit_mask,
                                    rad_all=rad_all)
        color = shade(scene, sd, wo, res_final, self.eval_f, hit_mask,
                      rad_all=rad_all)
        if scene.volumes is not None:
            # volumetric shadow attenuation at shading time only (never
            # persisted into reservoir weights — it would compound)
            v_tr = volumetric_transmittance(scene, sd, res_final,
                                            scene.volumes, k_v2, hit_mask)
            color = color * v_tr[:, None]
        new_state = RestirState(
            # biased mode feeds the visibility-zeroed reservoirs forward
            # (visibility reuse); unbiased keeps the pre-shading reservoirs —
            # a zeroed winner's M would silently darken the temporal combine
            reservoir=res_final if cfg.biased else res,
            prev_depth=sd_depth(sd),
            prev_normal=sd.normal,
            prev_position=sd.position,
            prev_albedo=vm.luminance(sd.base_color),
            valid=jnp.asarray(True),
        )
        return color, new_state
