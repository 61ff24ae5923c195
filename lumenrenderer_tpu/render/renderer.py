"""High-level renderer: owns the scene, accel structure, and jitted frame step.

JAX equivalent of `WaveFront::WaveFrontRenderer`
(`Framework/WaveFrontRenderer.h:50-126`): where the reference owns dozens of
CUDA buffers and launches ~15 kernels per frame from a render thread, this
class binds scene+BVH into ONE jitted, state-donating XLA program per frame
and exposes progressive accumulation, AOV snapshots, and frame stats.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..accel import brute, lbvh, sah, stream, traverse
from ..core.camera import Camera
from ..integrator import wavefront
from ..scene.scene import SceneData
from . import state as state_mod
from . import tonemap


class Renderer:
    """Progressive wavefront renderer over a static scene.

    accel: "tiled" (tiled-stream + Pallas visit kernel, default) | "stream"
    | "two_level" (instancing) | "sah"/"bvh" (host SAH + lockstep
    traversal) | "lbvh" (device build) | "brute" (oracle).

    interpret: run the Pallas visit kernel in interpret mode (the CPU).
    """

    def __init__(
        self,
        scene: SceneData,
        config: wavefront.RenderConfig,
        accel: str = "tiled",
        leaf_size: int = 4,
        cluster_size: int = 128,
        max_pairs_per_ray: int = 24,
        max_visits: int | str = "auto",
        culling: str = "auto",
        interpret: bool = False,
        restir_config=None,
        restir_fn: Optional[Callable] = None,
        donate: bool = True,
        dynamic=None,
        mesh=None,
        stats_every: int = 0,
        builder=None,
        reset_on_camera_move: bool = True,
    ):
        """dynamic: optional `scene.dynamic.DynamicScene` — threads the scene
        AND cluster set through the jitted step as arguments so instance-
        transform edits rebake on device with no retrace (≙ PTScene.cpp:77-160
        dirty-IAS rebuild).

        mesh: optional `jax.sharding.Mesh` — run the PROGRESSIVE renderer
        under a device mesh: the frame state (accum,
        ReSTIR reservoirs, AOVs) shards over the pixel axis, scene/BVH
        replicate, and GSPMD propagates the shardings through the jitted
        step. Same step code, any mesh size.

        stats_every: N > 0 keeps per-stage times in `frame_stats` EVERY
        frame (≙ the reference's always-on FrameStats map filled across
        TraceFrame, `WaveFrontRenderer.cpp:453-1081`): the production frame
        stays ONE fused XLA program (in-frame timers can't exist), so the
        per-stage map is refreshed by a sampling probe (`profile_stages`
        with reps=1) every N frames and merged into every frame's stats."""
        self.scene = scene
        # static scene facts the jitted frame can exploit (values are
        # concrete HERE, traced inside the step): tangents are only consumed
        # by normal mapping and anisotropic specular
        if config.extract_tangent:
            import dataclasses as _dc

            needs_tangent = bool(
                np.any(np.asarray(scene.materials.anisotropic) != 0.0)
                or np.any(np.asarray(scene.materials.normal_tex) >= 0)
            )
            if not needs_tangent:
                config = _dc.replace(config, extract_tangent=False)
        if not config.alpha_materials:
            import dataclasses as _dc2

            # auto-enable the per-material alpha/sidedness path when the
            # scene statically carries non-OPAQUE or single-sided materials
            # (≙ the reference always extracting ALPHA_TRANSPARENT flags)
            if bool(np.any(np.asarray(scene.materials.alpha_mode) != 0.0)
                    or np.any(np.asarray(scene.materials.double_sided) < 0.5)):
                config = _dc2.replace(config, alpha_materials=True)
        self.config = config
        self.accel_kind = accel
        self.frame_stats: Dict[str, float] = {}
        self._dynamic = dynamic
        self._mesh = mesh
        self._stats_every = int(stats_every)
        self._stage_stats: Dict[str, float] = {}
        self._reset_on_camera_move = bool(reset_on_camera_move)
        self._prev_cam_sig = None
        if mesh is not None:
            from ..parallel import shard as shard_mod

            assert dynamic is None or accel == "tiled", (
                "dynamic+mesh needs accel='tiled'")
            assert config.height % mesh.size == 0, (
                f"height {config.height} must divide the mesh ({mesh.size})")
            # scene/BVH replicated on every device; per-pixel state shards
            # over rows; the step runs under shard_map so each chip traces
            # its own rows chip-locally (sorting, culling, kernels all
            # local — zero cross-chip traffic inside the frame, SURVEY §5.7)
            self.scene = shard_mod.replicate(scene, mesh)
            scene = self.scene
        if dynamic is not None:
            assert accel in ("tiled", "two_level"), (
                "dynamic scenes require accel='tiled' or 'two_level'")
            # dynamic+ReSTIR works since round 5: the reservoir visibility
            # passes thread the CURRENT frame's occluder (RestirDI.__call__
            # occlude_fn override) so reuse tests against rebaked geometry,
            # exactly like the reference re-tracing against the rebuilt IAS
            # every dirty frame (PTScene.cpp:77-160)
        if accel == "tiled":
            # tiled-stream intersector (default): ray-tile x cluster
            # Moller-Trumbore in the fused Pallas visit kernel
            from ..accel import tiled

            self.bvh = None
            self.clusters = stream.build_clusters(
                scene.tri_pos, cluster_size=cluster_size
            )
            if max_visits == "auto":
                # allow the FULL admission set: the kernel's visit loop is
                # early-out bounded, so a big cap costs ~nothing and the
                # overflow flag stays False
                max_visits = min(self.clusters.num_clusters, 128)
            # decode=False: exact t/u/v are re-derived inside
            # extract_surface_data from its fused attr-table gather (the
            # in-intersector decode costs a second per-ray gather + einsum)
            self._tiled_opts = dict(
                max_visits=max_visits, culling=culling, decode=False,
                interpret=interpret,
            )
            isect, occl = tiled.tiled_intersectors(
                self.clusters, **self._tiled_opts,
            )
        elif accel == "two_level":
            # TLAS/BLAS instancing (round 5, ≙ per-primitive GAS + IAS,
            # WaveFrontRenderer.cpp:1148-1252 / PTScene.cpp:77-160): geometry
            # clustered ONCE per unique mesh in object space; rays transform
            # into instance space at the TLAS leaf. Needs the SceneBuilder
            # (instances + meshes); the flattened SceneData still provides
            # the shading attributes, indexed by the decoded virtual tri id.
            from ..accel import two_level as two_level_mod

            assert builder is not None, (
                "accel='two_level' needs builder=<SceneBuilder> for the "
                "instance/mesh tables")
            mesh_slot: Dict[int, int] = {}
            meshes_np, inst_mesh, inst_tf = [], [], []
            for inst in builder.instances:
                mkey = id(inst.mesh)
                if mkey not in mesh_slot:
                    mesh_slot[mkey] = len(meshes_np)
                    meshes_np.append(
                        inst.mesh.positions[inst.mesh.indices])
                inst_mesh.append(mesh_slot[mkey])
                inst_tf.append(inst.transform)
            self.bvh = None
            self.clusters = None
            self.instanced = two_level_mod.build_instanced(
                meshes_np, inst_mesh, inst_tf, cluster_size=cluster_size)
            v = self.instanced.num_clusters
            if max_visits == "auto":
                max_visits = min(v, 64)
            self._twolevel_opts = dict(max_visits=max_visits, culling=culling)
            isect, occl = two_level_mod.instanced_intersectors(
                self.instanced, **self._twolevel_opts)
        elif accel == "stream":
            # first-generation pair-stream intersector (kept for comparison)
            self.bvh = None
            self.clusters = stream.build_clusters(
                scene.tri_pos, cluster_size=cluster_size
            )
            isect, occl = stream.stream_intersectors(
                self.clusters, max_pairs_per_ray=max_pairs_per_ray
            )
        elif accel in ("bvh", "sah"):
            # static scene: host binned-SAH build, best traversal quality
            self.bvh = sah.build_sah(scene.tri_pos, leaf_size=leaf_size)
            isect, occl = traverse.bvh_intersectors(self.bvh)
        elif accel == "lbvh":
            # device Morton LBVH: lower quality, rebuildable on-device per
            # frame for deforming geometry
            self.bvh = lbvh.build_lbvh(scene.tri_pos, leaf_size=leaf_size)
            isect, occl = traverse.bvh_intersectors(self.bvh)
        elif accel == "brute":
            self.bvh = None
            import functools

            isect = functools.partial(brute.intersect_closest, scene.tri_pos)
            occl = functools.partial(brute.intersect_any, scene.tri_pos)
        else:
            raise ValueError(f"unknown accel {accel!r}")
        self._isect = isect
        self._occl = occl
        if restir_fn is None and config.use_restir:
            from ..integrator import wavefront as wf
            from ..restir.di import RestirConfig, RestirDI

            restir_fn = RestirDI(
                occl,
                lambda sd, wo, wi: wf._bsdf_eval(
                    config, sd, scene.materials, wo, wi
                ),
                restir_config or RestirConfig(),
                config.width,
                # under a mesh each shard owns height/mesh.size rows; the
                # reservoir grid is that local slice, and spatial reuse
                # halo-exchanges a spatial_radius band with the neighbour
                # shards each iteration (round 5, no seam clamping)
                config.height // (mesh.size if mesh is not None else 1),
                halo=((shard_mod.TILE_AXIS, mesh.size)
                      if mesh is not None else None),
            )
        self._restir_fn = restir_fn

        cfg = config

        def run(st: state_mod.FrameState, camera: Camera, scene_: SceneData,
                isect_, occl_):
            key, sub = jax.random.split(st.key)
            out = wavefront.render_wavefront(
                scene_,
                isect_,
                occl_,
                camera,
                sub,
                st.frame_index,
                cfg,
                restir_state=st.restir,
                restir_fn=restir_fn,
            )
            frame = wavefront.merge_channels(out)
            accum = tonemap.blend_accumulate(st.accum, frame, st.blend_count)
            new_st = st.replace(
                accum=accum,
                blend_count=st.blend_count + 1,
                frame_index=st.frame_index + 1,
                key=key,
                restir=out.pop("restir_state"),
            )
            aux = {
                k: out[k]
                for k in ("depth", "normal", "albedo", "motion", "overflow",
                          "debug_first_bad")
                if k in out
            }
            return new_st, aux

        if mesh is not None:
            from jax.sharding import PartitionSpec as P

            from ..parallel.shard import TILE_AXIS

            nsh = mesh.size
            n_local = cfg.num_pixels // nsh

            def step_local(st, camera, scene_, clusters_=None):
                shard_i = jax.lax.axis_index(TILE_AXIS)
                pix = shard_i * n_local + jnp.arange(n_local, dtype=jnp.int32)
                key, sub = jax.random.split(st.key)
                # decorrelate shards (key itself stays replicated)
                sub = jax.random.fold_in(sub, shard_i)
                if clusters_ is not None:
                    # dynamic+mesh: rebaked clusters ride as a replicated
                    # arg; the accel refreshes without retrace on any chip
                    from ..accel import tiled as tiled_mod

                    isect_, occl_ = tiled_mod.tiled_intersectors(
                        clusters_, **self._tiled_opts)
                else:
                    isect_, occl_ = isect, occl
                out = wavefront.render_wavefront(
                    scene_, isect_, occl_, camera, sub, st.frame_index, cfg,
                    restir_state=st.restir, restir_fn=restir_fn,
                    pixel_ids=pix,
                )
                frame = wavefront.merge_channels(out)
                accum = tonemap.blend_accumulate(
                    st.accum, frame, st.blend_count)
                new_st = st.replace(
                    accum=accum, blend_count=st.blend_count + 1,
                    frame_index=st.frame_index + 1, key=key,
                    restir=out.pop("restir_state"),
                )
                aux = {
                    k: out[k]
                    for k in ("depth", "normal", "albedo", "motion")
                    if k in out
                }
                # scalars must leave the shard replicated: reduce
                if "overflow" in out:
                    aux["overflow"] = jax.lax.pmax(
                        out["overflow"].astype(jnp.int32), TILE_AXIS) > 0
                if "debug_first_bad" in out:
                    aux["debug_first_bad"] = jax.lax.pmax(
                        out["debug_first_bad"], TILE_AXIS)
                return new_st, aux

            def _pix_spec(template):
                def pick(x):
                    x = jnp.asarray(x)
                    if x.ndim >= 1 and x.shape[0] == cfg.num_pixels:
                        return P(TILE_AXIS)
                    return P()
                return jax.tree_util.tree_map(pick, template)

            state_spec = _pix_spec(state_mod.init_state(
                cfg.num_pixels, 0,
                restir=(self._restir_fn.init_state(cfg.num_pixels)
                        if self._restir_fn is not None
                        and hasattr(self._restir_fn, "init_state") else None),
            ))
            # per-pixel aux leaves shard, scalars replicate (pmax'd above)
            aux_spec = {
                k: P(TILE_AXIS) for k in ("depth", "normal", "albedo",
                                          "motion")
            }
            aux_spec["overflow"] = P()
            if cfg.debug_checks:
                aux_spec["debug_first_bad"] = P()

            if dynamic is None:
                def step(st, camera, scene_):
                    cam_sp = jax.tree_util.tree_map(lambda _: P(), camera)
                    scn_sp = jax.tree_util.tree_map(lambda _: P(), scene_)
                    return jax.shard_map(
                        step_local, mesh=mesh,
                        in_specs=(state_spec, cam_sp, scn_sp),
                        out_specs=(state_spec, aux_spec),
                        check_vma=False,
                    )(st, camera, scene_)
            else:
                def step(st, camera, scene_, clusters_):
                    cam_sp = jax.tree_util.tree_map(lambda _: P(), camera)
                    scn_sp = jax.tree_util.tree_map(lambda _: P(), scene_)
                    cls_sp = jax.tree_util.tree_map(lambda _: P(), clusters_)
                    return jax.shard_map(
                        step_local, mesh=mesh,
                        in_specs=(state_spec, cam_sp, scn_sp, cls_sp),
                        out_specs=(state_spec, aux_spec),
                        check_vma=False,
                    )(st, camera, scene_, clusters_)

            self._step = jax.jit(step, donate_argnums=(0,) if donate else ())
        elif dynamic is None:
            def step(st, camera, scene_):
                return run(st, camera, scene_, isect, occl)

            self._step = jax.jit(
                step, donate_argnums=(0,) if donate else ())
        elif accel == "two_level":
            from ..accel import two_level as two_level_mod

            def step(st, camera, scene_, ics_):
                # the instanced accel rides as a pytree ARG: transform edits
                # refit O(units) on device, never retrace
                isect_, occl_ = two_level_mod.instanced_intersectors(
                    ics_, **self._twolevel_opts)
                return run(st, camera, scene_, isect_, occl_)

            self._step = jax.jit(
                step, donate_argnums=(0,) if donate else ())
        else:
            from ..accel import tiled as tiled_mod

            def step(st, camera, scene_, clusters_):
                # clusters ride as a pytree ARG: transform edits never
                # retrace (values change, shapes don't)
                isect_, occl_ = tiled_mod.tiled_intersectors(
                    clusters_, **self._tiled_opts)
                return run(st, camera, scene_, isect_, occl_)

            self._step = jax.jit(
                step, donate_argnums=(0,) if donate else ())

        # drift baseline for dynamic refits (cheap: one host reduce at init)
        self._cluster_area0 = (
            self._cluster_area(self.clusters)
            if getattr(self, "clusters", None) is not None
            and dynamic is not None else 0.0)

    # -- cluster drift (dynamic scenes) -------------------------------------

    @staticmethod
    def _cluster_area(cs) -> float:
        import numpy as _np

        ext = _np.maximum(
            _np.asarray(cs.aabb_hi) - _np.asarray(cs.aabb_lo), 0.0)
        return float((ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
                      + ext[:, 0] * ext[:, 2]).sum())

    def cluster_drift(self) -> float:
        """Refit-quality metric for dynamic scenes: total cluster-AABB
        surface area now / at build. Membership is frozen at build, so
        instances travelling far inflate their clusters' boxes — admission
        (and frame time) degrades in proportion. ~1.0 = pristine; the
        reference sidesteps this by rebuilding its IAS every dirty frame
        (PTScene.cpp:77-160); here a full rebuild = constructing a new
        Renderer."""
        if self.clusters is None or self._cluster_area0 <= 0.0:
            return 1.0
        return self._cluster_area(self.clusters) / self._cluster_area0

    DRIFT_REBUILD_RATIO = 2.0

    def _check_cluster_drift(self):
        # one tiny D2H per REBAKE frame (not per frame) — the advisory is
        # worthless if it can't see current boxes
        if self.clusters is None:
            return
        drift = self.cluster_drift()
        self._last_drift = drift
        if drift > self.DRIFT_REBUILD_RATIO:
            from ..utils import log as log_mod

            log_mod.core().warning(
                "cluster drift %.2fx exceeds %.1fx: refit quality degraded; "
                "rebuild the Renderer (fresh cluster membership) for these "
                "instance positions", drift, self.DRIFT_REBUILD_RATIO)

    # -- public API ---------------------------------------------------------

    def init_state(self, seed: int = 0) -> state_mod.FrameState:
        restir0 = None
        if self._restir_fn is not None and hasattr(self._restir_fn, "init_state"):
            restir0 = self._restir_fn.init_state(self.config.num_pixels)
        st = state_mod.init_state(self.config.num_pixels, seed, restir=restir0)
        if self._mesh is not None:
            from ..parallel import shard as shard_mod

            st = shard_mod.shard_pixels(st, self._mesh)
        return st

    def render_frame(self, st, camera):
        """One progressive frame. Returns (new_state, aux AOV dict).

        Progressive accumulation resets when the camera moves (≙ the
        reference's a_FrameCount=0 blend restart on input,
        Sandbox/src/OutputLayer.cpp:519,559); disable with
        reset_on_camera_move=False (e.g. fixed-camera benchmarks, where the
        per-frame host compare is pure overhead)."""
        t0 = time.perf_counter()
        if self._reset_on_camera_move:
            # identity fast path: progressive loops re-pass the same Camera
            # object every frame — skip the per-frame device-to-host field
            # reads (each one a sync with the device) in that case
            if camera is not getattr(self, "_prev_cam_obj", None):
                sig = tuple(
                    np.asarray(x).tobytes()
                    for x in (camera.eye, camera.u, camera.v, camera.w))
                if self._prev_cam_sig is not None \
                        and sig != self._prev_cam_sig:
                    st = state_mod.reset_accumulation(st)
                self._prev_cam_sig = sig
                self._prev_cam_obj = camera
        if self._dynamic is not None:
            if self.accel_kind == "two_level":
                if self._dynamic.dirty:
                    # attrs rebake O(T) + accel refit O(units) — no triangle
                    # re-transform in the accel (≙ IAS-only rebuild)
                    self.scene, self.instanced = self._dynamic.rebake_two_level(
                        self.scene, self.instanced)
                new_st, aux = self._step(st, camera, self.scene, self.instanced)
            else:
                if self._dynamic.dirty:
                    # one jitted device rebake: geometry + lights + cluster
                    # refit
                    self.scene, self.clusters = self._dynamic.rebake(
                        self.scene, self.clusters)
                    self._check_cluster_drift()
                new_st, aux = self._step(st, camera, self.scene, self.clusters)
        else:
            new_st, aux = self._step(st, camera, self.scene)
        jax.block_until_ready(new_st.accum)
        if self.config.debug_checks and "debug_first_bad" in aux:
            # debug mode: one scalar D2H read per frame, by design
            bad = wavefront.decode_debug_stage(int(aux["debug_first_bad"]))
            if bad is not None:
                raise RuntimeError(
                    f"debug_checks: non-finite value first produced by "
                    f"stage {bad!r} (≙ the reference's CHECKCUDAERROR + "
                    f"device NaN asserts, CudaUtilities.h:6-106)"
                )
        # NOTE: no device->host reads here — each one is a host sync
        self._frames_done = getattr(self, "_frames_done", 0) + 1
        self.frame_stats = {
            "Total Frame Time": (time.perf_counter() - t0) * 1e3,
            "Frame": self._frames_done,
        }
        if getattr(self, "_last_drift", None) is not None:
            self.frame_stats["cluster_drift"] = self._last_drift
        # per-frame per-stage visibility (≙ the reference's FrameStats map):
        # refresh the sampled per-stage probe every N frames, merge always
        if self._stats_every > 0:
            if (self._frames_done - 1) % self._stats_every == 0:
                self._stage_stats = self.profile_stages(camera, reps=1)
            self.frame_stats.update(self._stage_stats)
            from ..utils import log as log_mod

            log_mod.frame_record(self.frame_stats)
        return new_st, aux

    def render(self, camera: Camera, spp: int = 16, seed: int = 0):
        """Render `spp` progressive frames, return (H,W,3) float radiance."""
        st = self.init_state(seed)
        for _ in range(spp):
            st, _ = self.render_frame(st, camera)
        img = np.asarray(st.accum).reshape(
            self.config.height, self.config.width, 3
        )
        return img

    def render_sequence(self, cameras, spp: int = 1, denoise: str = "temporal",
                        seed: int = 0):
        """Render an animated camera path, one image per camera.

        denoise: "temporal" (motion-reprojected history + variance clamp in
        front of À-Trous, ≙ the reference's temporal denoiser mode,
        `OptixDenoiserWrapper.h:66-105`) | "spatial" | "off".
        Cameras should carry `prev_view_proj` (see `Camera.with_previous`)
        so motion vectors reproject; frame f's noise is decorrelated via
        seed+f. Returns a list of (H,W,3) float arrays.
        """
        from . import denoise as dn

        h, w = self.config.height, self.config.width
        tstate = dn.init_temporal_state(h, w)
        imgs = []
        for f, cam in enumerate(cameras):
            st = self.init_state(seed + f)
            aux = None
            for _ in range(spp):
                st, aux = self.render_frame(st, cam)
            if denoise == "temporal":
                tstate, img = dn.temporal_denoise_frame(
                    tstate, st.accum, aux, w, h
                )
            elif denoise == "spatial":
                img = dn.denoise_frame(st.accum, aux, w, h)
            else:
                img = st.accum
            imgs.append(np.asarray(img).reshape(h, w, 3))
        return imgs

    def render_png(self, camera: Camera, path: str, spp: int = 16, exposure=1.0):
        img = self.render(camera, spp)
        u8 = tonemap.to_uint8(tonemap.tonemap_gamma(jnp.asarray(img), exposure=exposure))
        tonemap.save_png(path, np.asarray(u8))
        return img

    def get_last_frame_stats(self) -> Dict[str, float]:
        """≙ `LumenRenderer::GetLastFrameStats` (`LumenRenderer.h:29-34`)."""
        return dict(self.frame_stats)

    def _probe_fns(self) -> Dict[str, Callable]:
        """Jitted per-stage probe programs, built once and reused across
        `profile_stages`/`stats_every` calls (camera and scene are arguments,
        not closures, so probes never retrace on new cameras)."""
        if getattr(self, "_probes", None) is not None:
            return self._probes
        from ..core import camera as camera_mod
        from ..integrator import nee as nee_mod
        from ..integrator import wavefront as wf
        from ..integrator.surface import extract_surface_data

        cfg = self.config
        tmin = jnp.float32(1e-3)
        self._probes = {
            "prim": jax.jit(lambda cam, fi, k: camera_mod.generate_primary_rays(
                cam, cfg.width, cfg.height, fi, key=k, jitter=cfg.jitter)),
            "isect": jax.jit(lambda o, d, tx: self._isect(o, d, tmin, tx)),
            "occl": jax.jit(lambda o, d, tx: self._occl(o, d, tmin, tx)),
            "extract": jax.jit(lambda s, o, d, hh: extract_surface_data(
                s, o, d, hh["t"], hh["tri"], hh["u"], hh["v"])),
            "bsdf": jax.jit(lambda s, sd, a, b: wf._bsdf_eval(
                cfg, sd, s.materials, a, b)),
            "nee": jax.jit(lambda lt, u, pos: nee_mod.sample_light(lt, u, pos)),
        }
        return self._probes

    def profile_stages(self, camera: Camera, reps: int = 3,
                       seed: int = 0) -> Dict[str, float]:
        """Per-stage frame-time breakdown, merged into `frame_stats`.

        ≙ the reference's per-stage FrameStats map filled across TraceFrame
        (`WaveFrontRenderer.cpp:453,610,833,854,1012,1078`). The production
        frame is ONE fused XLA program (per-stage timers can't exist inside
        it), so profiling mode times each stage as its own jitted program at
        frame shapes — the fusion the full frame enjoys is lost, so the sum
        of stages is an upper bound on the fused frame.
        """
        import time as _time

        from ..integrator import nee as nee_mod

        cfg = self.config
        n = cfg.num_pixels
        sc = self.scene
        key = jax.random.PRNGKey(seed)
        stats: Dict[str, float] = {}

        def timeit(name, fn, *args):
            out = jax.block_until_ready(fn(*args))
            t0 = _time.perf_counter()
            for _ in range(reps):
                out = fn(*args)
            jax.block_until_ready(out)
            stats[name] = (_time.perf_counter() - t0) / reps * 1e3
            return out

        # probe programs are built + jitted ONCE (fresh jax.jit lambdas per
        # call would recompile ~6 programs every Nth frame under
        # stats_every); camera/scene ride as ARGUMENTS
        p = self._probe_fns()
        ray_o, ray_d = timeit("GeneratePrimaryRays", p["prim"], camera,
                              jnp.int32(0), key)
        tmax = jnp.full((n,), 1e8, jnp.float32)
        hits = timeit("Intersect (primary, coherent)", p["isect"],
                      ray_o, ray_d, tmax)
        sd = timeit("ExtractSurfaceData", p["extract"], sc, ray_o, ray_d, hits)
        ku = jax.random.uniform(jax.random.fold_in(key, 1), (n, 3)) * 2 - 1
        bd = ku / jnp.linalg.norm(ku, axis=-1, keepdims=True)
        # bounce origins from extract's EXACT sd.t (the tiled fast path's
        # hits["t"] is the quantized packed-key distance)
        bo = ray_o + jnp.where(
            jnp.isfinite(sd.t), sd.t, 1.0)[:, None] * ray_d
        timeit("Intersect (bounce, incoherent)", p["isect"], bo, bd, tmax)
        timeit("Occlusion (shadow)", p["occl"], bo, bd, tmax)
        wo = -ray_d
        timeit("BSDF evaluate", p["bsdf"], sc, sd, wo, bd)
        ltab = jax.jit(nee_mod.build_light_table,
                       static_argnames=("selection",))(
            sc, selection=cfg.light_selection)
        u3 = jax.random.uniform(jax.random.fold_in(key, 3), (n, 3))
        timeit("ShadeDirect sample_light", p["nee"], ltab, u3, sd.position)

        def _run(st_):
            if self._dynamic is not None:
                return self._step(st_, camera, sc, self.clusters)[0]
            return self._step(st_, camera, sc)[0]

        st = self.init_state(seed)
        st = _run(st)                            # compile + warm
        jax.block_until_ready(st.accum)
        t0 = _time.perf_counter()
        for _ in range(reps):
            st = _run(st)
        jax.block_until_ready(st.accum)
        stats["Total Frame Time"] = (_time.perf_counter() - t0) / reps * 1e3
        self.frame_stats.update(stats)
        return stats
