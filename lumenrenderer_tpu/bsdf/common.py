"""Shared microfacet/Fresnel math for BSDFs.

JAX equivalent of the reference's shared BSDF headers:
`CUDAKernels/bsdf_math.cuh` (Schlick, Smith helpers) and
`CUDAKernels/ggxmdf.cuh` (GGX + GTR1 microfacet distribution functions).
All functions are elementwise over batch dims (VPU-friendly).
"""
from __future__ import annotations

import jax.numpy as jnp


def schlick_fresnel(cos_theta: jnp.ndarray) -> jnp.ndarray:
    """Schlick's (1-cos)^5 weight."""
    m = jnp.clip(1.0 - cos_theta, 0.0, 1.0)
    return m * m * m * m * m


def fresnel_schlick(f0: jnp.ndarray, cos_theta: jnp.ndarray) -> jnp.ndarray:
    return f0 + (1.0 - f0) * schlick_fresnel(cos_theta)[..., None]


def fresnel_dielectric(cos_i: jnp.ndarray, eta: jnp.ndarray) -> jnp.ndarray:
    """Exact dielectric Fresnel; eta = eta_t/eta_i. cos_i >= 0."""
    cos_i = jnp.clip(cos_i, 0.0, 1.0)
    sin2_t = (1.0 - cos_i * cos_i) / jnp.maximum(eta * eta, 1e-8)
    tir = sin2_t >= 1.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 0.0))
    r_par = (eta * cos_i - cos_t) / jnp.maximum(eta * cos_i + cos_t, 1e-8)
    r_perp = (cos_i - eta * cos_t) / jnp.maximum(cos_i + eta * cos_t, 1e-8)
    f = 0.5 * (r_par * r_par + r_perp * r_perp)
    return jnp.where(tir, 1.0, f)


def ggx_d(nh: jnp.ndarray, alpha: jnp.ndarray) -> jnp.ndarray:
    """GGX normal distribution D(h) (isotropic). ≙ GGXMDF::D."""
    a2 = alpha * alpha
    d = nh * nh * (a2 - 1.0) + 1.0
    return jnp.where(nh > 0.0, a2 / jnp.maximum(jnp.pi * d * d, 1e-12), 0.0)


def ggx_lambda(cos_theta: jnp.ndarray, alpha: jnp.ndarray) -> jnp.ndarray:
    """Smith Lambda for GGX."""
    c = jnp.clip(jnp.abs(cos_theta), 1e-6, 1.0)
    s2 = jnp.maximum(1.0 - c * c, 0.0)
    t2 = s2 / (c * c)
    return 0.5 * (-1.0 + jnp.sqrt(1.0 + alpha * alpha * t2))


def smith_g1(cos_theta: jnp.ndarray, alpha: jnp.ndarray) -> jnp.ndarray:
    return 1.0 / (1.0 + ggx_lambda(cos_theta, alpha))


def smith_g2(cos_o: jnp.ndarray, cos_i: jnp.ndarray, alpha: jnp.ndarray) -> jnp.ndarray:
    """Height-correlated Smith G2. ≙ GGXMDF::G."""
    return 1.0 / (1.0 + ggx_lambda(cos_o, alpha) + ggx_lambda(cos_i, alpha))


def gtr1_d(nh: jnp.ndarray, alpha: jnp.ndarray) -> jnp.ndarray:
    """Berry/GTR1 distribution for clearcoat. ≙ GTR1MDF::D."""
    a2 = jnp.clip(alpha * alpha, 1e-6, 1.0 - 1e-6)
    d = 1.0 + (a2 - 1.0) * nh * nh
    return jnp.where(
        nh > 0.0,
        (a2 - 1.0) / jnp.maximum(jnp.pi * jnp.log(a2) * d, 1e-12),
        0.0,
    )


def ggx_d_aniso(h: jnp.ndarray, ax: jnp.ndarray, ay: jnp.ndarray) -> jnp.ndarray:
    """Anisotropic GGX D(h), h in the (tangent, bitangent, normal) frame.

    ≙ `CUDAKernels/ggxmdf.cuh` GGXMDF::D(alpha_x, alpha_y). Reduces exactly
    to `ggx_d` when ax == ay, so the isotropic path shares this code.
    """
    hx, hy, hz = h[..., 0], h[..., 1], h[..., 2]
    e = (hx / ax) ** 2 + (hy / ay) ** 2 + hz * hz
    return jnp.where(
        hz > 0.0, 1.0 / jnp.maximum(jnp.pi * ax * ay * e * e, 1e-12), 0.0
    )


def ggx_lambda_aniso(w: jnp.ndarray, ax: jnp.ndarray, ay: jnp.ndarray) -> jnp.ndarray:
    """Smith Lambda for anisotropic GGX, w in the tangent frame."""
    wx, wy = w[..., 0], w[..., 1]
    wz = jnp.clip(jnp.abs(w[..., 2]), 1e-6, 1.0)
    a2t2 = ((ax * wx) ** 2 + (ay * wy) ** 2) / (wz * wz)
    return 0.5 * (-1.0 + jnp.sqrt(1.0 + a2t2))


def smith_g1_aniso(w, ax, ay):
    return 1.0 / (1.0 + ggx_lambda_aniso(w, ax, ay))


def smith_g2_aniso(wo, wi, ax, ay):
    """Height-correlated Smith G2, anisotropic. ≙ GGXMDF::G."""
    return 1.0 / (
        1.0 + ggx_lambda_aniso(wo, ax, ay) + ggx_lambda_aniso(wi, ax, ay)
    )


def ggx_vndf_pdf_aniso(wo, h, ax, ay):
    """PDF of anisotropic GGX VNDF sampling (half-vector measure)."""
    wo_z = wo[..., 2]
    oh = jnp.sum(wo * h, axis=-1)
    g1 = smith_g1_aniso(wo, ax, ay)
    d = ggx_d_aniso(h, ax, ay)
    return jnp.where(
        wo_z > 0.0,
        g1 * d * jnp.maximum(oh, 0.0) / jnp.maximum(wo_z, 1e-6),
        0.0,
    )


def ggx_vndf_pdf(wo_z, nh, oh, alpha):
    """PDF of GGX VNDF sampling (half-vector measure → solid-angle measure)."""
    g1 = smith_g1(wo_z, alpha)
    d = ggx_d(nh, alpha)
    return jnp.where(
        wo_z > 0.0,
        g1 * d * jnp.maximum(oh, 0.0) / jnp.maximum(wo_z, 1e-6),
        0.0,
    )
