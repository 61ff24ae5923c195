"""Sampling primitives: low-discrepancy sequences and warping functions.

JAX replacement for the reference's RNG/sampling helpers
(`Shaders/CppCommon/RandomUtilities.cuh` Wang-hash/xorshift,
`GPUGeneratePrimRay.cu:28-82` Halton(2,3) pixel jitter,
`RenderingUtility.h:260-338` GGX-VNDF sampling).

We use `jax.random` threefry keys for decorrelated sampling and keep the
Halton(2,3) pixel jitter of the reference for progressive accumulation.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from . import vecmath as vm


def halton(index: jnp.ndarray, base: int) -> jnp.ndarray:
    """Radical inverse of `index` in `base` (Halton sequence component).

    Vectorized, fixed 16 digits — enough for ~2^16 frames of jitter at
    base 2, matching the per-frame jitter use in the reference.
    """
    index = index.astype(jnp.uint32)
    f = jnp.ones_like(index, dtype=jnp.float32)
    r = jnp.zeros_like(index, dtype=jnp.float32)

    def body(_, carry):
        f, r, idx = carry
        f = f / base
        r = r + f * (idx % base).astype(jnp.float32)
        idx = idx // base
        return f, r, idx

    f, r, _ = jax.lax.fori_loop(0, 16, body, (f, r, index))
    return r


def halton23(index: jnp.ndarray) -> jnp.ndarray:
    """2D Halton point (bases 2, 3) — the reference's pixel jitter."""
    return jnp.stack([halton(index, 2), halton(index, 3)], axis=-1)


def sample_cosine_hemisphere(u: jnp.ndarray) -> jnp.ndarray:
    """Cosine-weighted hemisphere direction in tangent space (z up).

    u: (..., 2) uniform samples. pdf = cos_theta / pi.
    """
    r = jnp.sqrt(u[..., 0])
    phi = 2.0 * jnp.pi * u[..., 1]
    x = r * jnp.cos(phi)
    y = r * jnp.sin(phi)
    z = jnp.sqrt(jnp.maximum(1.0 - u[..., 0], 0.0))
    return jnp.stack([x, y, z], axis=-1)


def cosine_hemisphere_pdf(cos_theta: jnp.ndarray) -> jnp.ndarray:
    return jnp.maximum(cos_theta, 0.0) / jnp.pi


def sample_uniform_sphere(u: jnp.ndarray) -> jnp.ndarray:
    z = 1.0 - 2.0 * u[..., 0]
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    phi = 2.0 * jnp.pi * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def sample_triangle(u: jnp.ndarray) -> jnp.ndarray:
    """Uniform barycentrics on a triangle from (...,2) uniforms.

    Mirrors the sqrt warp used by the reference's NEE light sampling
    (`GPUShadeDirect.cu`).
    """
    su = jnp.sqrt(u[..., 0])
    b0 = 1.0 - su
    b1 = u[..., 1] * su
    return jnp.stack([b0, b1, 1.0 - b0 - b1], axis=-1)


def sample_ggx_vndf(wo: jnp.ndarray, roughness: jnp.ndarray, u: jnp.ndarray,
                    roughness_y: jnp.ndarray | None = None) -> jnp.ndarray:
    """Sample a GGX visible-normal (Heitz 2018) in tangent space.

    wo: (...,3) outgoing dir in tangent space (z up), roughness: (...,) the
    x slope (= alpha_x; pass alpha_y via roughness_y for anisotropy),
    u: (...,2). Returns the half-vector m. Same estimator the reference
    uses (`RenderingUtility.h:260-338`, anisotropic alphas ≙ `ggxmdf.cuh`),
    vectorized.
    """
    ax = jnp.maximum(roughness, 1e-4)[..., None]
    ay = ax if roughness_y is None else jnp.maximum(roughness_y, 1e-4)[..., None]
    vh = vm.normalize(wo * jnp.concatenate([ax, ay, jnp.ones_like(ax)], axis=-1))
    # Orthonormal basis around vh
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    t1 = jnp.where(
        (lensq > 1e-7)[..., None],
        jnp.stack([-vh[..., 1], vh[..., 0], jnp.zeros_like(lensq)], axis=-1)
        * jax.lax.rsqrt(jnp.maximum(lensq, 1e-7))[..., None],
        jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0]), vh.shape),
    )
    t2 = jnp.cross(vh, t1)
    r = jnp.sqrt(u[..., 0])
    phi = 2.0 * jnp.pi * u[..., 1]
    p1 = r * jnp.cos(phi)
    p2 = r * jnp.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * jnp.sqrt(jnp.maximum(1.0 - p1**2, 0.0)) + s * p2
    p3 = jnp.sqrt(jnp.maximum(1.0 - p1**2 - p2**2, 0.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * vh
    m = vm.normalize(
        jnp.stack(
            [ax[..., 0] * nh[..., 0], ay[..., 0] * nh[..., 1], jnp.maximum(nh[..., 2], 0.0)],
            axis=-1,
        )
    )
    return m


def power_heuristic(pdf_a: jnp.ndarray, pdf_b: jnp.ndarray) -> jnp.ndarray:
    """MIS power heuristic (beta=2) weight for sampling strategy a."""
    a2 = pdf_a * pdf_a
    return jnp.where(pdf_a > 0.0, a2 / jnp.maximum(a2 + pdf_b * pdf_b, 1e-20), 0.0)
