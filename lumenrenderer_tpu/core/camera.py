"""Pinhole camera with motion-vector support.

JAX equivalent of the reference's `Lumen/src/Lumen/Renderer/Camera.h:8-67`
(eye/U/V/W vector basis, previous+current view-projection matrices for motion
vectors) and the primary-ray generation kernel
(`CUDAKernels/WaveFrontKernels/GPUGeneratePrimRay.cu:28-82`, Halton(2,3)
per-frame jitter).

The camera is a frozen pytree so it can live inside the jitted frame function;
host-side helpers (look_at, orbit) build new instances.
"""
from __future__ import annotations

from typing import Tuple

import chex
import jax
import jax.numpy as jnp

from . import sampling
from . import vecmath as vm


@chex.dataclass(frozen=True)
class Camera:
    """Pinhole camera pytree.

    eye: (3,) position; u,v,w: screen-space basis (u=right*tan(fov)*aspect,
    v=up*tan(fov), w=forward), mirroring the reference's GetVectorData.
    prev_view_proj: (4,4) previous-frame view-projection for motion vectors.
    """

    eye: jnp.ndarray
    u: jnp.ndarray
    v: jnp.ndarray
    w: jnp.ndarray
    prev_view_proj: jnp.ndarray
    t_min: jnp.ndarray
    t_max: jnp.ndarray

    @staticmethod
    def look_at(
        eye,
        target,
        up=(0.0, 1.0, 0.0),
        fov_y_deg: float = 45.0,
        aspect: float = 1.0,
        t_min: float = 1e-3,
        t_max: float = 1e9,
    ) -> "Camera":
        eye = jnp.asarray(eye, jnp.float32)
        target = jnp.asarray(target, jnp.float32)
        up = jnp.asarray(up, jnp.float32)
        w = vm.normalize(target - eye)
        u = vm.normalize(jnp.cross(w, up))
        v = jnp.cross(u, w)
        tan_half = jnp.tan(jnp.deg2rad(jnp.asarray(fov_y_deg, jnp.float32)) * 0.5)
        cam = Camera(
            eye=eye,
            u=u * tan_half * aspect,
            v=v * tan_half,
            w=w,
            prev_view_proj=jnp.eye(4, dtype=jnp.float32),
            t_min=jnp.asarray(t_min, jnp.float32),
            t_max=jnp.asarray(t_max, jnp.float32),
        )
        return cam.replace(prev_view_proj=cam.view_proj(fov_y_deg, aspect))

    def view_proj(self, fov_y_deg: float = 45.0, aspect: float = 1.0) -> jnp.ndarray:
        """Row-major view-projection matrix (for motion-vector reprojection)."""
        fwd = vm.normalize(self.w)
        right = vm.normalize(self.u)
        up = vm.normalize(self.v)
        view = jnp.eye(4, dtype=jnp.float32)
        rot = jnp.stack([right, up, fwd], axis=0)
        view = view.at[:3, :3].set(rot)
        view = view.at[:3, 3].set(-rot @ self.eye)
        f = 1.0 / jnp.tan(jnp.deg2rad(jnp.asarray(fov_y_deg, jnp.float32)) * 0.5)
        near, far = 0.01, 1e6
        proj = jnp.array(
            [
                [f / aspect, 0.0, 0.0, 0.0],
                [0.0, f, 0.0, 0.0],
                [0.0, 0.0, far / (far - near), -far * near / (far - near)],
                [0.0, 0.0, 1.0, 0.0],
            ],
            dtype=jnp.float32,
        )
        return proj @ view

    def with_previous(self, prev: "Camera", fov_y_deg: float = 45.0, aspect: float = 1.0) -> "Camera":
        """Carry the previous frame's view-projection for motion vectors."""
        return self.replace(prev_view_proj=prev.view_proj(fov_y_deg, aspect))


def block_swizzle_map(width: int, height: int, bw: int = 16, bh: int = 8):
    """Pixel permutation grouping 16x8 blocks consecutively, so each 128-ray
    intersector tile is a compact screen block (compact frusta for the
    hierarchical culling) instead of a thin scanline strip.

    Returns (perm, inv) as numpy int32 arrays: ray slot i handles pixel
    perm[i]; image[p] = result[inv[p]]. Falls back to identity when the
    resolution doesn't tile evenly.
    """
    import numpy as np

    n = width * height
    if width % bw or height % bh:
        ident = np.arange(n, dtype=np.int32)
        return ident, ident
    bx = width // bw
    ys, xs = np.mgrid[0:height, 0:width]
    block = (ys // bh) * bx + (xs // bw)
    within = (ys % bh) * bw + (xs % bw)
    slot = block * (bw * bh) + within          # ray slot for pixel (y,x)
    inv = slot.reshape(-1).astype(np.int32)    # pixel -> slot
    perm = np.empty(n, np.int32)
    perm[inv] = np.arange(n, dtype=np.int32)   # slot -> pixel
    return perm, inv


def generate_primary_rays(
    camera: Camera,
    width: int,
    height: int,
    frame_index: jnp.ndarray,
    key: jax.Array | None = None,
    jitter: str = "halton",
    pixel_ids: jnp.ndarray | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Generate one primary ray per pixel with sub-pixel jitter.

    Returns (origins (N,3), directions (N,3)) with N = width*height, in
    row-major pixel order unless `pixel_ids` (N,) assigns ray slot i to a
    specific pixel (block swizzling). Equivalent of `GeneratePrimaryRay`
    (`GPUGeneratePrimRay.cu`): Halton(2,3) jitter indexed by frame for
    progressive accumulation, or uniform random jitter from `key`.
    """
    # pixel_ids may be a SLICE of the frame (mesh sharding): n follows it
    n = width * height if pixel_ids is None else pixel_ids.shape[0]
    ids = (
        jnp.arange(n, dtype=jnp.int32) if pixel_ids is None else pixel_ids
    )
    px = ids % width
    py = ids // width
    if jitter == "halton":
        j = sampling.halton23(jnp.broadcast_to(frame_index.astype(jnp.uint32), (n,)))
    elif jitter == "random" and key is not None:
        j = jax.random.uniform(key, (n, 2))
    else:
        j = jnp.full((n, 2), 0.5, dtype=jnp.float32)
    # NDC in [-1, 1], y up (pixel row 0 = top of image)
    sx = ((px.astype(jnp.float32) + j[:, 0]) / width) * 2.0 - 1.0
    sy = 1.0 - ((py.astype(jnp.float32) + j[:, 1]) / height) * 2.0
    d = vm.normalize(
        sx[:, None] * camera.u[None, :]
        + sy[:, None] * camera.v[None, :]
        + camera.w[None, :]
    )
    o = jnp.broadcast_to(camera.eye[None, :], (n, 3))
    return o, d


def motion_vectors(
    world_pos: jnp.ndarray,
    valid: jnp.ndarray,
    camera: Camera,
    width: int,
    height: int,
    pixel_ids: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Screen-space motion vectors by reprojection through prev view-proj.

    Equivalent of `GenerateMotionVector` (`CUDAKernels/MotionVectors.cu:8-54`).
    world_pos: (N,3) primary-hit positions; valid: (N,) hit mask.
    Returns (N,2) pixel-space deltas (prev - current), 0 where invalid.
    """
    n = world_pos.shape[0]
    hp = jnp.concatenate([world_pos, jnp.ones((n, 1), world_pos.dtype)], axis=-1)
    # HIGHEST: a reduced-precision default (bf16/TF32) would round it;
    # reprojection needs subpixel accuracy for ReSTIR temporal reuse
    clip = jnp.matmul(hp, camera.prev_view_proj.T,
                      precision=jax.lax.Precision.HIGHEST)
    ndc = clip[:, :2] / jnp.where(jnp.abs(clip[:, 3:4]) > 1e-8, clip[:, 3:4], 1.0)
    prev_px = (ndc[:, 0] * 0.5 + 0.5) * width
    prev_py = (0.5 - ndc[:, 1] * 0.5) * height
    ids = jnp.arange(n, dtype=jnp.int32) if pixel_ids is None else pixel_ids
    cur_px = (ids % width).astype(jnp.float32) + 0.5
    cur_py = (ids // width).astype(jnp.float32) + 0.5
    mv = jnp.stack([prev_px - cur_px, prev_py - cur_py], axis=-1)
    behind = clip[:, 3] <= 0.0
    return jnp.where((valid & ~behind)[:, None], mv, 0.0)
