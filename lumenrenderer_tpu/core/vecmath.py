"""Vector math primitives for the wavefront path tracer.

All functions operate on arrays whose last axis is the 3 (or 4) vector
components, so every op is trivially batched/vmapped and XLA fuses the
elementwise chains.

JAX replacement for the reference's CUDA helper headers
(`Shaders/CppCommon/RenderingUtility.h`, `CUDAKernels/bsdf_math.cuh`).
"""
from __future__ import annotations

import jax.numpy as jnp

EPS = 1e-6
INF = jnp.inf


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the last axis, keepdims=False."""
    return jnp.sum(a * b, axis=-1)


def vdot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product keeping the last axis (size 1) for broadcasting."""
    return jnp.sum(a * b, axis=-1, keepdims=True)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def length(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(jnp.maximum(dot(v, v), 0.0))


def length_sq(v: jnp.ndarray) -> jnp.ndarray:
    return dot(v, v)


def normalize(v: jnp.ndarray, eps: float = 1e-20) -> jnp.ndarray:
    """Safe normalize: returns v/|v|; near-zero vectors map to ~0."""
    return v * jnp.where(
        vdot(v, v) > eps, jnp.reciprocal(jnp.sqrt(jnp.maximum(vdot(v, v), eps))), 0.0
    )


def reflect(d: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Reflect direction d about normal n (d points into the surface)."""
    return d - 2.0 * vdot(d, n) * n


def refract(d: jnp.ndarray, n: jnp.ndarray, eta: jnp.ndarray):
    """Refract incoming direction d at normal n with relative IOR eta.

    Returns (refracted_dir, total_internal_reflection_mask).
    """
    cos_i = -vdot(d, n)
    sin2_t = eta[..., None] ** 2 * jnp.maximum(1.0 - cos_i**2, 0.0)
    tir = sin2_t[..., 0] >= 1.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 0.0))
    refr = eta[..., None] * d + (eta[..., None] * cos_i - cos_t) * n
    return jnp.where(tir[..., None], reflect(d, n), refr), tir


def luminance(rgb: jnp.ndarray) -> jnp.ndarray:
    """Rec.709 luminance; mirrors the radiance weighting used by the
    reference's ReSTIR CDF build (`CUDAKernels/ReSTIRKernels.cu:165`)."""
    return rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722


def build_onb(n: jnp.ndarray):
    """Branchless orthonormal basis from a unit normal (Duff et al. 2017).

    Returns (tangent, bitangent) with shape of n. Replaces the reference's
    `Tangent2World`-style frame construction (`RenderingUtility.h`).
    """
    s = jnp.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = jnp.stack(
        [1.0 + s * n[..., 0] ** 2 * a, s * b, -s * n[..., 0]], axis=-1
    )
    bt = jnp.stack([b, s + n[..., 1] ** 2 * a, -n[..., 1]], axis=-1)
    return t, bt


def to_world(local: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Transform a tangent-space direction (z=up) into world space about n."""
    t, b = build_onb(n)
    return (
        local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * n
    )


def to_local(world: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Transform a world direction into the tangent frame about n."""
    t, b = build_onb(n)
    return jnp.stack([dot(world, t), dot(world, b), dot(world, n)], axis=-1)


def to_local_frame(world, t, b, n) -> jnp.ndarray:
    """Transform a world direction into an explicit (t, b, n) frame."""
    return jnp.stack([dot(world, t), dot(world, b), dot(world, n)], axis=-1)


def to_world_frame(local, t, b, n) -> jnp.ndarray:
    """Transform a tangent-space direction out of an explicit (t, b, n) frame."""
    return local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * n


def face_forward(n: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Flip n to lie in the hemisphere opposite direction d (d = incoming)."""
    return jnp.where(vdot(n, d) > 0.0, -n, n)


def transform_point(m: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Apply a (...,4,4) row-major transform to points (...,3)."""
    return (
        p[..., None, :] @ jnp.swapaxes(m[..., :3, :3], -1, -2)
    )[..., 0, :] + m[..., :3, 3]


def transform_dir(m: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Apply the rotation/scale part of a (...,4,4) transform to directions."""
    return (d[..., None, :] @ jnp.swapaxes(m[..., :3, :3], -1, -2))[..., 0, :]


def transform_normal(m_inv: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Transform normals with the inverse-transpose: n' = (M^-1)^T n.

    Pass the *inverse* matrix; the transpose is applied here.
    """
    return (n[..., None, :] @ m_inv[..., :3, :3])[..., 0, :]


def safe_rcp(x: jnp.ndarray, eps: float = 1e-20) -> jnp.ndarray:
    """1/x with sign-preserving clamp away from zero (for ray inv-dir)."""
    return jnp.where(
        jnp.abs(x) > eps, 1.0 / jnp.where(jnp.abs(x) > eps, x, 1.0),
        jnp.where(x >= 0.0, 1.0 / eps, -1.0 / eps),
    )


def lerp(a, b, t):
    return a + (b - a) * t


def saturate(x):
    return jnp.clip(x, 0.0, 1.0)
