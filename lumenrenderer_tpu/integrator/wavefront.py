"""The wavefront path-tracing frame function.

JAX re-architecture of the reference's `WaveFrontRenderer::TraceFrame`
(`Framework/WaveFrontRenderer.cpp:435-1089`) and its per-depth kernel chain
(`CPUShadingKernels.cu:89-253`): instead of a host loop with per-depth
atomic-counter readbacks and separate CUDA launches, the whole frame is ONE
jitted XLA program — a statically unrolled depth loop over fixed-size ray
batches with masked lanes. There is no host↔device traffic inside a frame.

Light-channel semantics mirror `LightChannel` (`ShadowRayData.h:13-64`):
DIRECT gets primary-hit emissive + primary NEE; INDIRECT gets bounce NEE and
(in MIS mode) weighted BSDF-sampled emissive; SPECULAR gets near-delta lobes.

Light transport strategies:
  "nee"  — reference semantics: emissive visible at depth 0 only + NEE at
           every vertex (`GPUShadeDirect.cu` + `ResolveDirectLightHits`).
  "bsdf" — pure BSDF sampling (ground-truth cross-check).
  "mis"  — NEE + BSDF with power-heuristic weights (default; strictly lower
           variance than the reference).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp

from ..bsdf import disney as disney_mod
from ..bsdf import lambert
from ..core import camera as camera_mod
from ..core import sampling
from ..core import vecmath as vm
from ..scene.scene import SceneData
from . import nee as nee_mod
from .surface import SurfaceData, extract_surface_data

RAY_EPS = 1e-3

# stage names for RenderConfig.debug_checks reporting (order matters: the
# encoded index is depth * len(DEBUG_STAGES) + stage + 1)
DEBUG_STAGES = (
    "intersect",
    "extract_surface_data",
    "volumetric",
    "emissive/light channels",
    "nee/shade_direct",
    "bsdf_sample/throughput",
)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static (trace-time) renderer configuration.

    ≙ `WaveFrontSettings` (`Framework/WaveFrontRenderer.h:31-48`): depth,
    render resolution; plus the strategy switches the reference fixes at
    compile time.
    """

    width: int = 128
    height: int = 128
    max_depth: int = 5            # ≙ Config.json depth=5
    bsdf: str = "disney"          # "lambert" | "disney"
    light_strategy: str = "mis"   # "nee" | "bsdf" | "mis"
    # NEE light selection: "cdf" = radiance-weighted per-frame CDF
    # (≙ GPUShadeDirect.cu:83 sampling ReSTIR::BuildCDF), "uniform" = 1/L
    light_selection: str = "cdf"
    rr_start_depth: int = 2       # russian roulette from this bounce on
    rr_min_prob: float = 0.05
    use_restir: bool = False      # M5: ReSTIR DI for primary hits
    jitter: str = "random"        # "halton" | "random" | "center"
    alpha_test: bool = False      # legacy global stochastic alpha (pre-r5)
    # per-material alpha pipeline (glTF alphaMode/alphaCutoff/doubleSided;
    # the Renderer auto-enables this when the scene has any non-OPAQUE or
    # single-sided material)
    alpha_materials: bool = False
    # Differentiability (M4): "detached sampling" discipline — BVH hits,
    # sampled directions, pdfs, MIS and RR weights are stop-gradient'ed so
    # pixel gradients w.r.t. material/emission/volume params are unbiased
    # estimates of the true parameter derivative (north star: detached
    # traversal/hit ids + differentiable shading). Costs nothing at
    # inference; keep True.
    detach_sampling: bool = True
    # Volumetrics (M6, ≙ VolumetricShadeDirect): march steps per segment and
    # how many path depths carry volume scattering (reference marches every
    # wave; depth 1 = primary-only fog, cheaper)
    volume_steps: int = 5
    volume_depths: int = 2
    # shadow-segment transmittance estimator: "riemann" (reference's fixed
    # 5-step jittered march) | "ratio" (unbiased ratio tracking, BASELINE
    # config 4 — correct for strongly heterogeneous grids)
    volume_transmittance: str = "riemann"
    # Ray-order block swizzling: 16x8 pixel blocks per 128-ray intersector
    # tile (compact frusta for hierarchical culling on big scenes). Not
    # compatible with ReSTIR's pixel-grid neighbour logic yet.
    swizzle: bool = False
    # Sort secondary rays for intersector coherence (round 4 default ON):
    # global argsort — bounce rays by [octant|origin morton], shadow rays by
    # origin->light capsule key (accel/sorting.py:sorted_intersectors; the
    # block-local partition was a measured loser, see that file)
    sort_secondary: bool = True
    # Mipmapped texture sampling (≙ PTTexture.cpp:64-65): ray-footprint
    # trilinear LOD; level-0 bilinear when off. No cost for untextured scenes.
    mipmaps: bool = True
    # Gather tangent columns in extract (12 of ~68 table columns + interp).
    # The Renderer flips this off automatically when the scene provably has
    # no normal maps and no anisotropic materials — extract runs every
    # depth and its per-ray gather cost is linear in row width.
    extract_tangent: bool = True
    # Rematerialize depths >= 1 in reverse mode (jax.checkpoint): trades
    # ~1 extra forward of compute for O(depth) less residual memory — the
    # only way 1440p backward fits one chip. Off by default (forward-only
    # rendering never pays it; flip on for training/grad benches).
    remat: bool = False
    # Production NaN/Inf guard (≙ CudaUtilities.h CHECK macros + the device
    # pdf/NaN asserts, ReSTIRKernels.cu:879-899): every stage output is
    # finite-checked; the frame reports the FIRST offending stage in
    # out["debug_first_bad"] (0 = clean, else 1-based stage index into
    # DEBUG_STAGES). Renderer raises with the stage name when enabled.
    debug_checks: bool = False

    @property
    def num_pixels(self) -> int:
        return self.width * self.height


def _bsdf_sample(cfg: RenderConfig, sd: SurfaceData, mats, wo, u, key):
    if cfg.bsdf == "lambert":
        wi, f, pdf = lambert.sample_brdf(sd.base_color, sd.normal, wo, u[..., :2])
        is_specular = jnp.zeros(wo.shape[:-1], bool)
        return wi, f, pdf, is_specular
    return disney_mod.sample(mats, sd, wo, u, key)


def _bsdf_eval(cfg: RenderConfig, sd: SurfaceData, mats, wo, wi):
    if cfg.bsdf == "lambert":
        return lambert.eval_brdf(sd.base_color, sd.normal, wo, wi)
    return disney_mod.evaluate(mats, sd, wo, wi)


def render_wavefront(
    scene: SceneData,
    intersect_fn: Callable,
    occlude_fn: Callable,
    camera: camera_mod.Camera,
    key: jax.Array,
    frame_index: jnp.ndarray,
    cfg: RenderConfig,
    restir_state: Optional[Any] = None,
    restir_fn: Optional[Callable] = None,
    pixel_ids: Optional[jnp.ndarray] = None,
) -> Dict[str, jnp.ndarray]:
    """Trace one 1-spp frame. Returns a dict of AOVs:

    direct/indirect/specular: (N,3) light channels (N = W*H row-major),
    depth: (N,), normal/albedo: (N,3) primary-hit AOVs (denoiser inputs,
    ≙ the reference's denoiser feature buffers), motion: (N,2).

    intersect_fn(o, d, tmin, tmax) -> {"t","tri","u","v"}
    occlude_fn(o, d, tmin, tmax) -> bool occlusion mask

    pixel_ids: optional (N',) global pixel indices — trace a SLICE of the
    frame (mesh sharding: each chip renders its own rows; cfg.width/height
    stay the full-frame values for camera math). Outputs are in pixel_ids
    order; mutually exclusive with cfg.swizzle.
    """
    n = cfg.num_pixels if pixel_ids is None else pixel_ids.shape[0]
    f32 = jnp.float32
    sg = jax.lax.stop_gradient if cfg.detach_sampling else (lambda x: x)

    if cfg.detach_sampling:
        # Detach geometry through the accel structure: reverse-mode AD cannot
        # (and must not) flow through the traversal while_loop; hit ids/t are
        # discrete/geometric and carry no material gradients.
        # NOTE: tn/tx must be detached too — t_max_ray depends on `alive`
        # → throughput → differentiated materials, and a live tangent
        # reaching pallas_call raises NotImplementedError.
        raw_isect, raw_occl = intersect_fn, occlude_fn
        _sg = jax.lax.stop_gradient
        intersect_fn = lambda o, d, tn, tx: jax.tree_util.tree_map(
            _sg, raw_isect(_sg(o), _sg(d), _sg(tn), _sg(tx))
        )
        occlude_fn = lambda o, d, tn, tx: _sg(
            raw_occl(_sg(o), _sg(d), _sg(tn), _sg(tx))
        )

    # ---- primary rays (≙ GeneratePrimaryRays, Halton jitter) ----
    pid = inv_ids = None
    if pixel_ids is not None:
        assert not cfg.swizzle, "pixel_ids and swizzle are exclusive"
        pid = pixel_ids
    elif cfg.swizzle:
        assert not cfg.use_restir, "swizzle+ReSTIR not supported yet"
        perm, inv = camera_mod.block_swizzle_map(cfg.width, cfg.height)
        pid = jnp.asarray(perm)
        inv_ids = jnp.asarray(inv)
    key_j, key = jax.random.split(key)
    ray_o, ray_d = camera_mod.generate_primary_rays(
        camera, cfg.width, cfg.height, frame_index, key=key_j,
        jitter=cfg.jitter, pixel_ids=pid,
    )
    throughput = jnp.ones((n, 3), f32)
    alive = jnp.ones((n,), bool)
    # pdf of the previous BSDF sampling event (for MIS); inf => delta/primary
    prev_pdf = jnp.full((n,), jnp.inf, f32)
    prev_specular = jnp.ones((n,), bool)
    # ≙ LightChannel::SPECULAR (ShadowRayData.h / LightData.h:15): paths whose
    # FIRST bounce was a near-delta lobe route their later contributions here
    first_specular = jnp.zeros((n,), bool)
    # Beer's-law interior absorption (≙ frosted.cuh transmission): per-lane
    # extinction sigma, set on refraction into a medium, cleared on exit
    beer_sigma = jnp.zeros((n, 3), f32)

    direct = jnp.zeros((n, 3), f32)
    indirect = jnp.zeros((n, 3), f32)
    specular_ch = jnp.zeros((n, 3), f32)
    volumetric_ch = jnp.zeros((n, 3), f32)
    overflow_any = jnp.zeros((), bool)

    # ---- production NaN/Inf guard (cfg.debug_checks) ----
    first_bad = jnp.zeros((), jnp.int32)
    if cfg.debug_checks:
        def chk(fb, stage: str, depth_i: int, *arrs):
            idx = depth_i * len(DEBUG_STAGES) + DEBUG_STAGES.index(stage) + 1
            bad = jnp.zeros((), bool)
            for a in arrs:
                if a is None or not jnp.issubdtype(a.dtype, jnp.floating):
                    continue
                bad = bad | ~jnp.all(jnp.isfinite(a))
            return jnp.where((fb == 0) & bad, idx, fb)
    else:
        def chk(fb, stage: str, depth_i: int, *arrs):
            return fb
    aovs: Dict[str, jnp.ndarray] = {}
    new_restir_state = restir_state

    t_min = jnp.asarray(RAY_EPS, f32)
    t_max = camera.t_max
    # ray-footprint mip selection: per-pixel angular spread (the camera's
    # vertical half-screen vector v spans height/2 pixels) + accumulated path
    # distance as the footprint driver (bounce rays keep widening)
    use_mips = cfg.mipmaps and scene.textures.count > 1
    if use_mips:
        mip_spread = 2.0 * jnp.linalg.norm(camera.v) / cfg.height
        path_dist = jnp.zeros((n,), f32)
    else:
        mip_spread = None
        path_dist = None
    # packed per-frame light table: geometry + differentiable radiance +
    # selection pdf in ONE (L,17) matrix; per-ray selection+fetch is a single
    # one-hot matmul (≙ GPUShadeDirect.cu:83 CDF sampling, re-architected
    # as a matmul instead of a searchsorted)
    light_table = nee_mod.build_light_table(scene, cfg.light_selection)

    if cfg.sort_secondary:
        from ..accel import sorting as sorting_mod

        scene_lo = jnp.min(scene.tri_pos.reshape(-1, 3), axis=0)
        scene_hi = jnp.max(scene.tri_pos.reshape(-1, 3), axis=0)
        # global sort (octant|morton for bounce, o->light capsule for
        # shadow). A block-local cumsum partition was tried to avoid the
        # argsort and lost: its scatters cost more than the sort and its
        # screen-strip blocks admit far more clusters.
        s_isect, s_occl = sorting_mod.sorted_intersectors(
            intersect_fn, occlude_fn, scene_lo, scene_hi
        )
        occlude_fn = s_occl  # shadow rays are always incoherent
    else:
        s_isect = intersect_fn

    # The depth-loop body as a PURE carry function so cfg.remat can wrap
    # depths >= 1 in jax.checkpoint: backward at 1440p otherwise OOMs on the
    # per-depth (N,3) residual chains (round 4; grads recompute each depth's
    # forward instead of storing ~dozens of 56 MB temps).
    def trace_depth(depth, carry):
        (ray_o, ray_d, throughput, alive, prev_pdf, prev_specular,
         first_specular, beer_sigma, direct, indirect, specular_ch,
         volumetric_ch, overflow_any, first_bad, path_dist, aovs,
         new_restir_state) = carry
        aovs = dict(aovs)
        dkey = jax.random.fold_in(key, depth)

        # ---- intersect (≙ optixLaunch INTERSECTION) ----
        # dead lanes get t_max < t_min: the intersector skips them AND
        # excludes them from tile-frustum bounds (critical for culling)
        t_max_ray = jnp.where(alive, jnp.broadcast_to(t_max, (n,)), -1.0)
        hits = (s_isect if depth > 0 else intersect_fn)(
            ray_o, ray_d, t_min, t_max_ray
        )
        if "overflow" in hits:
            # surface culling overflow instead of dropping it (visit-list
            # truncation can silently lose hits; see accel/tiled.py)
            overflow_any = overflow_any | hits["overflow"]
        first_bad = chk(first_bad, "intersect", depth,
                        jnp.where(jnp.isinf(hits["t"]), 0.0, hits["t"]))
        sd = extract_surface_data(
            scene, ray_o, ray_d, hits["t"], hits["tri"], hits["u"], hits["v"],
            mip_spread=mip_spread, mip_dist0=path_dist,
            detach_geom=cfg.detach_sampling,
            with_tangent=cfg.extract_tangent,
        )
        if use_mips:
            path_dist = path_dist + jnp.where(sd.valid, sg(sd.t), 0.0)
        if cfg.detach_sampling:
            # geometry is static w.r.t. differentiated params — detach it so
            # no grads are attempted through ray-position chains
            sd = sd.replace(
                position=sg(sd.position),
                normal=sg(sd.normal),
                geo_normal=sg(sd.geo_normal),
                tangent=sg(sd.tangent),
                t=sg(sd.t),
                # uv is recomputed from tri_pos/ray inside extract (ADVICE
                # r3): inv_det can reach 1e14 near the det guard — keep the
                # detached-sampling discipline on texture lookups too
                uv=sg(sd.uv),
            )
        hit_mask = sd.valid & alive
        wo = -ray_d
        first_bad = chk(
            first_bad, "extract_surface_data", depth,
            jnp.where(hit_mask[:, None], sd.position, 0.0),
            jnp.where(hit_mask[:, None], sd.normal, 0.0),
            jnp.where(hit_mask[:, None], sd.base_color, 0.0),
            jnp.where(hit_mask[:, None], sd.emissive, 0.0),
            jnp.where(hit_mask, sd.roughness, 0.0))

        # ---- Beer's-law interior absorption (≙ frosted.cuh / disney.cuh
        # transmission): attenuate by the interior segment just traversed ----
        if cfg.bsdf == "disney" and depth > 0:
            seg = jnp.where(sd.valid, jnp.minimum(sd.t, 1e6), 0.0)
            throughput = throughput * jnp.exp(-beer_sigma * seg[:, None])

        # ---- volumetric segment: in-scatter + transmittance ----
        # (≙ the bounded volumetric trace inside IntersectionRaysRayGen,
        # `WaveFrontShaders.cu:93-108`, + VolumetricShadeDirect)
        if scene.volumes is not None and depth < cfg.volume_depths:
            from ..volume import march as vmarch

            vkey = jax.random.fold_in(dkey, 23)
            seg_max = jnp.where(sd.valid, sd.t, jnp.asarray(1e8, f32))
            v_scatter, v_trans = vmarch.volume_scatter(
                scene.volumes, light_table, ray_o, ray_d, t_min, seg_max, vkey,
                occlude_fn, steps=cfg.volume_steps,
                detach_sampling=cfg.detach_sampling,
            )
            volumetric_ch = volumetric_ch + jnp.where(
                alive[:, None], throughput * v_scatter, 0.0
            )
            throughput = throughput * jnp.where(
                alive[:, None], v_trans[:, None], 1.0
            )
            first_bad = chk(first_bad, "volumetric", depth,
                            volumetric_ch, throughput)

        # ---- miss: environment contribution ----
        env_contrib = jnp.where(
            (alive & ~sd.valid)[:, None], throughput * scene.env_radiance[None, :], 0.0
        )
        if depth == 0:
            direct = direct + env_contrib
        else:
            # specular-path contributions ride the SPECULAR channel
            # (≙ LightChannel::SPECULAR routing in ShadeIndirect)
            specular_ch = specular_ch + jnp.where(
                first_specular[:, None], env_contrib, 0.0
            )
            indirect = indirect + jnp.where(
                first_specular[:, None], 0.0, env_contrib
            )

        # ---- primary-hit AOVs (denoiser inputs / motion vectors) ----
        if depth == 0:
            aovs["depth"] = jnp.where(hit_mask, sd.t, 0.0)
            aovs["normal"] = jnp.where(hit_mask[:, None], sd.normal, 0.0)
            aovs["albedo"] = jnp.where(hit_mask[:, None], sd.base_color, 0.0)
            aovs["motion"] = camera_mod.motion_vectors(
                sd.position, hit_mask, camera, cfg.width, cfg.height,
                pixel_ids=pid,
            )

        # ---- emissive surface hit (≙ ResolveDirectLightHits at depth 0) ----
        em = throughput * sd.emissive
        if depth == 0:
            direct = direct + jnp.where(hit_mask[:, None], em, 0.0)
        elif cfg.light_strategy == "bsdf":
            indirect = indirect + jnp.where(hit_mask[:, None], em, 0.0)
        elif cfg.light_strategy == "mis":
            lpdf = nee_mod.light_pdf_solid_angle(
                light_table, ray_d, sd.t, sd.light_row
            )
            w = jnp.where(
                prev_specular, 1.0, sg(sampling.power_heuristic(prev_pdf, lpdf))
            )
            w = jnp.where(hit_mask, w, 0.0)  # mask in the scalar (NaN-safe bwd)
            em_w = em * w[:, None]
            specular_ch = specular_ch + jnp.where(
                first_specular[:, None], em_w, 0.0
            )
            indirect = indirect + jnp.where(first_specular[:, None], 0.0, em_w)
        # "nee": bounce emissive dropped, matching the reference.

        first_bad = chk(first_bad, "emissive/light channels", depth,
                        direct, indirect, specular_ch)

        # ---- per-material alpha / sidedness (round 5, VERDICT #6) ----
        # ≙ GPUExtractSurfaceData.cu:8-228 alpha-discard +
        # SurfaceData.h:18-108 ALPHA_TRANSPARENT flags. Per-material glTF
        # semantics: MASK = deterministic cutoff test, BLEND = stochastic
        # passthrough with P(1-alpha), OPAQUE ignores alpha; single-sided
        # materials cull (pass through) back-face hits. cfg.alpha_test
        # additionally treats OPAQUE materials as BLEND (pre-r5 global
        # stochastic semantics, kept for hand-built scenes).
        if cfg.alpha_test or cfg.alpha_materials:
            from ..scene.materials import GatheredMaterial as _GM

            akey = jax.random.fold_in(dkey, 17)
            a_u = jax.random.uniform(akey, (n,))
            gm = _GM(sd.mat_rows)
            mode = sg(gm.alpha_mode)
            stochastic = (mode == 2.0)
            if cfg.alpha_test:
                stochastic = stochastic | (mode == 0.0)
            passthrough = hit_mask & (
                ((mode == 1.0) & (sd.alpha < sg(gm.alpha_cutoff)))
                | (stochastic & (sd.alpha < a_u))
                | ((sg(gm.double_sided) < 0.5) & ~sd.front_face)
            )
            # continue the ray through the surface without shading
            hit_mask = hit_mask & ~passthrough
        else:
            passthrough = jnp.zeros((n,), bool)

        # ---- NEE / ReSTIR direct lighting ----
        do_nee = cfg.light_strategy in ("nee", "mis")
        use_restir_here = (
            cfg.use_restir and depth == 0 and restir_fn is not None
        )
        if use_restir_here:
            # ≙ ReSTIR::Run at depth 0 → DIRECT channel
            restir_out, new_restir_state = restir_fn(
                scene, sd, wo, hit_mask, aovs["motion"], restir_state, dkey,
                occlude_fn=occlude_fn,
            )
            direct = direct + throughput * restir_out
        elif do_nee:
            nkey = jax.random.fold_in(dkey, 1)
            u3 = jax.random.uniform(nkey, (n, 3))
            ls = nee_mod.sample_light(light_table, u3, sd.position)
            cos_s = vm.dot(sd.normal, ls.wi)
            f_val, bsdf_pdf = _bsdf_eval(cfg, sd, scene.materials, wo, ls.wi)
            pdf_sa = nee_mod.pdf_solid_angle(ls)
            contrib_valid = (
                hit_mask & ls.valid & (cos_s > 0.0) & (pdf_sa > 1e-12)
            )
            if cfg.light_strategy == "mis":
                mis_w = sg(sampling.power_heuristic(pdf_sa, bsdf_pdf))
            else:
                mis_w = jnp.ones((n,), f32)
            # shadow ray (≙ ShadowRaysRayGen): offset along geometric normal;
            # lanes with no candidate contribution are marked dead (t_max<0)
            so = sd.position + sd.geo_normal * RAY_EPS
            contrib_valid = contrib_valid & (
                vm.luminance(jax.lax.stop_gradient(ls.radiance)) > 0.0
            )
            occluded = occlude_fn(
                so, ls.wi, jnp.asarray(RAY_EPS, f32),
                jnp.where(contrib_valid, ls.dist - 2.0 * RAY_EPS, -1.0),
            )
            # fold validity+occlusion into the detached scalar BEFORE the
            # product so no NaN/inf value ever multiplies a live cotangent
            scale = jnp.where(
                contrib_valid & ~occluded,
                jnp.maximum(sg(cos_s), 0.0)
                * mis_w
                / jnp.maximum(sg(pdf_sa), 1e-12),
                0.0,
            )
            # volumetric shadow attenuation (≙ volumetric shadow rays,
            # WaveFrontRenderer.cpp:858-871): Beer-Lambert transmittance of
            # participating media along the shadow segment
            if scene.volumes is not None:
                from ..volume import march as vmarch

                v_tr = vmarch.transmittance_only(
                    scene.volumes, so, ls.wi, jnp.asarray(RAY_EPS, f32),
                    jnp.where(contrib_valid, ls.dist - 2.0 * RAY_EPS, 0.0),
                    key=jax.random.fold_in(nkey, 9),
                    estimator=cfg.volume_transmittance,
                )
                scale = scale * sg(v_tr)
            shadowed = throughput * f_val * ls.radiance * scale[:, None]
            first_bad = chk(first_bad, "nee/shade_direct", depth, shadowed)
            if depth == 0:
                direct = direct + shadowed
            else:
                specular_ch = specular_ch + jnp.where(
                    first_specular[:, None], shadowed, 0.0
                )
                indirect = indirect + jnp.where(
                    first_specular[:, None], 0.0, shadowed
                )

        # ---- BSDF sampling for the next bounce (≙ ShadeIndirect) ----
        if depth + 1 < cfg.max_depth:
            skey = jax.random.fold_in(dkey, 2)
            u_b = jax.random.uniform(skey, (n, 4))
            wi, f_val, pdf, is_spec = _bsdf_sample(
                cfg, sd, scene.materials, wo, u_b, skey
            )
            # detached-sampling discipline: the direction and its density are
            # sampling machinery, not integrand — detach them; f stays live.
            wi = sg(wi)
            cos_i = jnp.abs(vm.dot(sd.normal, wi))
            valid_bounce = hit_mask & (pdf > 1e-9) & jnp.all(
                jnp.isfinite(wi), axis=-1
            )
            new_tp = (
                throughput * f_val * (sg(cos_i) / jnp.maximum(sg(pdf), 1e-9))[:, None]
            )
            new_tp = jnp.where(valid_bounce[:, None], new_tp, 0.0)

            # russian roulette (≙ ShadeIndirect RR on max channel)
            if depth >= cfg.rr_start_depth:
                rkey = jax.random.fold_in(dkey, 3)
                p_survive = sg(
                    jnp.clip(jnp.max(new_tp, axis=-1), cfg.rr_min_prob, 1.0)
                )
                u_rr = jax.random.uniform(rkey, (n,))
                survive = u_rr < p_survive
                new_tp = jnp.where(
                    survive[:, None], new_tp / p_survive[:, None], 0.0
                )
                valid_bounce = valid_bounce & survive

            # offset origin on the outgoing side of the geometric normal
            side = jnp.sign(vm.dot(sd.geo_normal, wi))[..., None]
            bounce_o = sd.position + sd.geo_normal * side * RAY_EPS
            # alpha passthrough continues straight (keeps throughput & pdf)
            next_o = jnp.where(
                passthrough[:, None],
                sd.position + ray_d * RAY_EPS,
                bounce_o,
            )
            next_d = jnp.where(passthrough[:, None], ray_d, wi)
            next_alive = valid_bounce | passthrough

            ray_o = jnp.where(next_alive[:, None], next_o, ray_o)
            ray_d = jnp.where(next_alive[:, None], next_d, ray_d)
            throughput = jnp.where(passthrough[:, None], throughput, new_tp)
            prev_pdf = jnp.where(passthrough, prev_pdf, pdf)
            prev_specular = jnp.where(passthrough, prev_specular, is_spec)
            if depth == 0:
                # paths whose first interaction bounced off a near-delta lobe
                # feed the SPECULAR channel from now on (≙ LightData.h:15)
                first_specular = is_spec & valid_bounce & ~passthrough
            # Beer's law: a refraction crossing the geometric surface toggles
            # the interior medium; sigma from the material's transmittance
            # color per unit distance (≙ frosted.cuh absorption)
            if cfg.bsdf == "disney":
                from ..scene.materials import GatheredMaterial

                g_rows = GatheredMaterial(sd.mat_rows)
                crossing = valid_bounce & (vm.dot(sd.geo_normal, wi) < 0.0)
                sigma_mat = -jnp.log(
                    jnp.clip(g_rows.transmittance, 1e-6, 1.0)
                )
                enter = crossing & sd.front_face
                exit_ = crossing & ~sd.front_face
                beer_sigma = jnp.where(
                    enter[:, None], sg(sigma_mat), beer_sigma
                )
                beer_sigma = jnp.where(exit_[:, None], 0.0, beer_sigma)
            alive = next_alive & (jnp.max(throughput, axis=-1) > 0.0)
            first_bad = chk(
                first_bad, "bsdf_sample/throughput", depth,
                jnp.where(alive[:, None], throughput, 0.0),
                jnp.where(alive[:, None], ray_d, 0.0))
        elif cfg.alpha_test or cfg.alpha_materials:
            # alpha passthrough at the depth horizon: the continuation ray is
            # never traced, so at least credit the environment (otherwise
            # thin-alpha silhouettes bias dark — VERDICT r1 weak #8)
            env_tail = jnp.where(
                passthrough[:, None], throughput * scene.env_radiance[None, :], 0.0
            )
            indirect = indirect + env_tail

        return (ray_o, ray_d, throughput, alive, prev_pdf, prev_specular,
                first_specular, beer_sigma, direct, indirect, specular_ch,
                volumetric_ch, overflow_any, first_bad, path_dist, aovs,
                new_restir_state)

    carry = (ray_o, ray_d, throughput, alive, prev_pdf, prev_specular,
             first_specular, beer_sigma, direct, indirect, specular_ch,
             volumetric_ch, overflow_any, first_bad, path_dist, aovs,
             new_restir_state)
    import functools as _ft

    for depth in range(cfg.max_depth):
        fn = _ft.partial(trace_depth, depth)
        if cfg.remat and depth > 0:
            # depth 0 stays live (it produces the AOVs / ReSTIR state and
            # its residuals amortize); deeper bounces recompute in backward
            fn = jax.checkpoint(fn)
        carry = fn(carry)
    (ray_o, ray_d, throughput, alive, prev_pdf, prev_specular,
     first_specular, beer_sigma, direct, indirect, specular_ch,
     volumetric_ch, overflow_any, first_bad, path_dist, aovs,
     new_restir_state) = carry

    out = {
        "direct": direct,
        "indirect": indirect,
        "specular": specular_ch,
        "volumetric": volumetric_ch,
        **aovs,
    }
    if inv_ids is not None:
        # de-swizzle every per-ray output back to row-major pixel order
        out = {k2: v[inv_ids] for k2, v in out.items()}
    out["overflow"] = overflow_any
    out["restir_state"] = new_restir_state
    if cfg.debug_checks:
        out["debug_first_bad"] = first_bad
    return out


def decode_debug_stage(first_bad: int) -> Optional[str]:
    """Map out["debug_first_bad"] to "stage (depth d)"; None when clean."""
    if first_bad == 0:
        return None
    i = int(first_bad) - 1
    return f"{DEBUG_STAGES[i % len(DEBUG_STAGES)]} (depth {i // len(DEBUG_STAGES)})"


def merge_channels(out: Dict[str, jnp.ndarray]) -> jnp.ndarray:
    """≙ MergeOutputChannels (`CPUShadingKernels.cu:253-271`): sum the light
    channels into the combined radiance image (N,3)."""
    img = out["direct"] + out["indirect"] + out["specular"]
    if "volumetric" in out and out["volumetric"] is not None:
        img = img + out["volumetric"][..., :3]
    return img
