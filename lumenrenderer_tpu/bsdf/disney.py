"""Disney BSDF: sample + evaluate, fully vectorized and differentiable.

JAX re-implementation of the reference's Disney/AppleSeed BSDF
(`CUDAKernels/disney.cuh:173-320+` sample/evaluate, `ggxmdf.cuh` GGX+GTR1
MDFs, `frosted.cuh` rough dielectric): diffuse with Burley retro-reflection,
sheen, GGX specular (metallic workflow), GTR1 clearcoat, and rough dielectric
transmission. Written from the published Disney BRDF/BSDF formulation —
not a translation of the CUDA code: everything is batched tangent-space math
on (R,...) arrays, branch-free (lobe selection via `jnp.where`), so one
evaluation runs all lobes for every ray on the VPU.

`evaluate` returns the combined f (no cosine) and the overall solid-angle pdf
of `sample`, which is what MIS weighting needs.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import sampling
from ..core import vecmath as vm
from . import common


class _Lobes(NamedTuple):
    p_diffuse: jnp.ndarray
    p_specular: jnp.ndarray
    p_clearcoat: jnp.ndarray
    p_transmission: jnp.ndarray


def _lobe_probs(g, sd) -> _Lobes:
    base_lum = jnp.maximum(vm.luminance(sd.base_color), 1e-4)
    metallic = sd.metallic
    spec_trans = g.spec_trans
    f0_lum = vm.luminance(_f0_color(g, sd))
    w_diff = (1.0 - metallic) * (1.0 - spec_trans) * base_lum
    w_spec = jnp.maximum(f0_lum, 0.08)
    w_cc = 0.25 * g.clearcoat
    w_trans = (1.0 - metallic) * spec_trans * base_lum
    total = w_diff + w_spec + w_cc + w_trans
    inv = 1.0 / jnp.maximum(total, 1e-8)
    return _Lobes(w_diff * inv, w_spec * inv, w_cc * inv, w_trans * inv)


def _f0_color(g, sd):
    """Specular F0: dielectric from `specular` scaled 0.08, tinted, lerped to
    base color by metallic (Disney convention)."""
    spec = g.specular
    tint_w = g.spec_tint
    lum = jnp.maximum(vm.luminance(sd.base_color), 1e-8)
    tint = sd.base_color / lum[..., None]
    dielectric = (
        0.08 * spec[..., None] * vm.lerp(jnp.ones_like(tint), tint, tint_w[..., None])
    )
    return vm.lerp(dielectric, sd.base_color, sd.metallic[..., None])


def _alpha(roughness):
    return jnp.maximum(roughness * roughness, 1e-4)


def _alpha_aniso(g, sd):
    """Anisotropic GGX slopes (ax, ay) from roughness + `anisotropic`.

    Disney aspect-ratio convention (≙ `ggxmdf.cuh` alpha_x/alpha_y plumbed
    through GGXMDF::D/G). anisotropic == 0 gives ax == ay == alpha, so the
    isotropic case is the same code path at the same cost.
    """
    alpha = _alpha(sd.roughness)
    aspect = jnp.sqrt(1.0 - 0.9 * jnp.clip(g.anisotropic, 0.0, 1.0))
    ax = jnp.maximum(alpha / aspect, 1e-4)
    ay = jnp.maximum(alpha * aspect, 1e-4)
    return ax, ay


def _frame(sd):
    """Shading frame (t, b, n): UV tangent orthogonalized against the
    (possibly normal-mapped) shading normal, so `anisotropic` stretches
    highlights along the surface's U direction; canonical ONB fallback for
    degenerate tangents."""
    n = sd.normal
    t_raw = sd.tangent - n * vm.dot(sd.tangent, n)[..., None]
    len2 = vm.dot(t_raw, t_raw)
    t_onb, _ = vm.build_onb(n)
    t = jnp.where((len2 > 1e-8)[..., None],
                  t_raw * jax.lax.rsqrt(jnp.maximum(len2, 1e-12))[..., None],
                  t_onb)
    b = jnp.cross(n, t)
    return t, b, n


def _eta(g, sd):
    """Relative IOR eta_i/eta_t for refraction direction computation."""
    ior = g.ior
    return jnp.where(sd.front_face, 1.0 / ior, ior)


def _eval_lobes(g, sd, wo_l, wi_l):
    """All reflection lobes in tangent space; wo_l.z > 0 assumed.

    Returns (f_reflect (R,3), pdf components dict).
    """
    cos_o = jnp.maximum(wo_l[..., 2], 1e-6)
    cos_i = wi_l[..., 2]
    reflect_side = cos_i > 1e-6
    cos_i_c = jnp.maximum(cos_i, 1e-6)

    h = vm.normalize(wo_l + wi_l)
    h = jnp.where((h[..., 2:3] < 0.0), -h, h)
    oh = jnp.maximum(vm.dot(wo_l, h), 0.0)
    nh = jnp.maximum(h[..., 2], 0.0)

    rough = sd.roughness
    alpha = _alpha(rough)
    ax, ay = _alpha_aniso(g, sd)

    # -- Disney diffuse + retro + sheen --
    fl = common.schlick_fresnel(cos_i_c)
    fv = common.schlick_fresnel(cos_o)
    rr = 2.0 * rough * oh * oh
    # Burley: f_d = (1 + (FD90-1)Fl)(1 + (FD90-1)Fv), FD90 = 0.5 + 2 rough oh^2
    fd90 = 0.5 + rr
    f_d = (1.0 + (fd90 - 1.0) * fl) * (1.0 + (fd90 - 1.0) * fv)
    # subsurface approximation (Hanrahan-Krueger lerp)
    fss90 = rr
    fss = (1.0 + (fss90 - 1.0) * fl) * (1.0 + (fss90 - 1.0) * fv)
    ss = 1.25 * (fss * (1.0 / (cos_i_c + cos_o) - 0.5) + 0.5)
    subsurface = g.subsurface
    diff_w = vm.lerp(f_d, ss, subsurface)
    diffuse_weight = (1.0 - sd.metallic) * (
        1.0 - g.spec_trans
    )
    f_diffuse = (
        sd.base_color / jnp.pi * (diff_w * diffuse_weight)[..., None]
    )
    # sheen
    lum = jnp.maximum(vm.luminance(sd.base_color), 1e-8)
    tint = sd.base_color / lum[..., None]
    sheen_tint = g.sheen_tint
    sheen_color = vm.lerp(jnp.ones_like(tint), tint, sheen_tint[..., None])
    fh = common.schlick_fresnel(oh)
    f_sheen = (
        g.sheen * diffuse_weight
    )[..., None] * sheen_color * fh[..., None]

    # -- GGX specular (anisotropic; wo_l/wi_l live in the UV tangent frame) --
    f0 = _f0_color(g, sd)
    fres = common.fresnel_schlick(f0, oh)
    d = common.ggx_d_aniso(h, ax, ay)
    g2 = common.smith_g2_aniso(wo_l, wi_l, ax, ay)
    f_spec = fres * (d * g2 / jnp.maximum(4.0 * cos_o * cos_i_c, 1e-8))[..., None]

    # -- clearcoat (GTR1, fixed 0.25 weight, F0=0.04) --
    cc = g.clearcoat
    cc_alpha = vm.lerp(0.1, 0.001, g.clearcoat_gloss)
    d_cc = common.gtr1_d(nh, cc_alpha)
    g_cc = common.smith_g2(cos_o, cos_i_c, jnp.full_like(cc_alpha, 0.25))
    f_cc_s = 0.04 + 0.96 * common.schlick_fresnel(oh)
    f_clearcoat = (
        0.25 * cc * d_cc * g_cc * f_cc_s / jnp.maximum(4.0 * cos_o * cos_i_c, 1e-8)
    )[..., None] * jnp.ones_like(f_spec)

    f_reflect = jnp.where(
        reflect_side[..., None],
        f_diffuse + f_sheen + f_spec + f_clearcoat,
        0.0,
    )

    # pdfs (solid angle) of each reflection sampling strategy
    pdf_diffuse = jnp.where(reflect_side, cos_i_c / jnp.pi, 0.0)
    pdf_spec_h = common.ggx_vndf_pdf_aniso(wo_l, h, ax, ay)
    pdf_spec = jnp.where(reflect_side, pdf_spec_h / jnp.maximum(4.0 * oh, 1e-8), 0.0)
    pdf_cc_h = d_cc * nh  # GTR1 sampled proportional to D * cos
    pdf_cc = jnp.where(reflect_side, pdf_cc_h / jnp.maximum(4.0 * oh, 1e-8), 0.0)
    return f_reflect, {
        "diffuse": pdf_diffuse,
        "specular": pdf_spec,
        "clearcoat": pdf_cc,
    }


def _eval_transmission(g, sd, wo_l, wi_l):
    """Rough dielectric transmission (Walter 2007) with base-color tint.

    ≙ `frosted.cuh` rough dielectric; Beer's-law volume absorption is applied
    by the integrator along the interior segment, not here.
    Returns (f_trans (R,3), pdf_trans (R,)).
    """
    cos_o = jnp.maximum(wo_l[..., 2], 1e-6)
    cos_i = wi_l[..., 2]
    trans_side = cos_i < -1e-6
    eta = _eta(g, sd)  # eta_i / eta_t
    # half vector for refraction: h = -(wo*eta_i + wi*eta_t) normalized.
    # with our eta convention: h ∝ wo + wi/eta ... use wt = wo + wi/eta?
    # Walter: h = -(eta_i * wi + eta_t * wo). Use unit-free form:
    h = vm.normalize(wo_l + wi_l * (1.0 / eta)[..., None])
    h = jnp.where((h[..., 2:3] < 0.0), -h, h)
    oh = vm.dot(wo_l, h)
    ih = vm.dot(wi_l, h)
    nh = jnp.maximum(h[..., 2], 0.0)
    alpha = _alpha(sd.roughness)
    ax, ay = _alpha_aniso(g, sd)
    d = common.ggx_d_aniso(h, ax, ay)
    g2 = common.smith_g2_aniso(wo_l, wi_l, ax, ay)
    f_r = common.fresnel_dielectric(jnp.abs(oh), 1.0 / eta)
    denom = jnp.maximum((oh + ih / eta) ** 2, 1e-8)
    jac = jnp.abs(ih) / denom * (1.0 / (eta * eta))
    f_t = (
        (1.0 - f_r)
        * d
        * g2
        * jnp.abs(oh)
        * jac
        / jnp.maximum(cos_o * jnp.abs(cos_i), 1e-8)
    )
    spec_trans = g.spec_trans
    w = (1.0 - sd.metallic) * spec_trans
    color = jnp.sqrt(jnp.maximum(sd.base_color, 0.0))  # thin tint split
    f_trans = jnp.where(
        trans_side[..., None], (f_t * w)[..., None] * color, 0.0
    )
    pdf_h = common.ggx_vndf_pdf_aniso(wo_l, h, ax, ay)
    pdf_trans = jnp.where(
        trans_side, pdf_h * jac * (1.0 - f_r), 0.0
    )
    return f_trans, pdf_trans


def evaluate(materials, sd, wo, wi):
    """Combined Disney f (no cosine) and sampling pdf. World-space wo/wi.

    `materials` is unused (kept for API stability): params come pre-gathered
    as packed rows on sd (one gather per batch, see MaterialTable.packed).
    """
    from ..scene.materials import GatheredMaterial

    g = GatheredMaterial(sd.mat_rows)
    t, b, n = _frame(sd)
    wo_l = vm.to_local_frame(wo, t, b, n)
    wi_l = vm.to_local_frame(wi, t, b, n)
    # shading normal may disagree with geometric side; clamp wo to upper hemi
    valid_o = wo_l[..., 2] > 1e-6
    wo_l = wo_l.at[..., 2].set(jnp.maximum(wo_l[..., 2], 1e-6))

    f_refl, pdfs = _eval_lobes(g, sd, wo_l, wi_l)
    f_trans, pdf_trans = _eval_transmission(g, sd, wo_l, wi_l)
    lobes = _lobe_probs(g, sd)
    f = f_refl + f_trans
    pdf = (
        lobes.p_diffuse * pdfs["diffuse"]
        + lobes.p_specular * pdfs["specular"]
        + lobes.p_clearcoat * pdfs["clearcoat"]
        + lobes.p_transmission * pdf_trans
    )
    f = jnp.where(valid_o[..., None], f, 0.0)
    pdf = jnp.where(valid_o, pdf, 0.0)
    return f, pdf


def sample(materials, sd, wo, u, key=None):
    """Sample the Disney BSDF. u: (R,4) uniforms (2 for direction, 1 lobe
    select, 1 spare). Returns (wi, f, pdf, is_specular)."""
    from ..scene.materials import GatheredMaterial

    g = GatheredMaterial(sd.mat_rows)
    t, b, n = _frame(sd)
    wo_l = vm.to_local_frame(wo, t, b, n)
    wo_l = wo_l.at[..., 2].set(jnp.maximum(wo_l[..., 2], 1e-6))
    lobes = _lobe_probs(g, sd)
    sel = u[..., 2]
    c1 = lobes.p_diffuse
    c2 = c1 + lobes.p_specular
    c3 = c2 + lobes.p_clearcoat
    pick_diffuse = sel < c1
    pick_spec = (sel >= c1) & (sel < c2)
    pick_cc = (sel >= c2) & (sel < c3)
    pick_trans = sel >= c3

    u2 = u[..., :2]
    # diffuse: cosine hemisphere
    wi_diff = sampling.sample_cosine_hemisphere(u2)
    # specular: GGX VNDF reflect (anisotropic slopes)
    alpha = _alpha(sd.roughness)
    ax, ay = _alpha_aniso(g, sd)
    m_spec = sampling.sample_ggx_vndf(wo_l, ax, u2, roughness_y=ay)
    wi_spec = vm.reflect(-wo_l, m_spec)
    # clearcoat: GTR1 D-sampling
    cc_alpha = vm.lerp(0.1, 0.001, g.clearcoat_gloss)
    a2 = jnp.clip(cc_alpha * cc_alpha, 1e-6, 1.0 - 1e-6)
    cos2 = (1.0 - jnp.power(a2, 1.0 - u2[..., 0])) / (1.0 - a2)
    cos_t = jnp.sqrt(jnp.clip(cos2, 0.0, 1.0))
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos2, 0.0))
    phi = 2.0 * jnp.pi * u2[..., 1]
    m_cc = jnp.stack(
        [sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t], axis=-1
    )
    wi_cc = vm.reflect(-wo_l, m_cc)
    # transmission: VNDF half-vector, refract (or reflect on TIR/Fresnel)
    eta = _eta(g, sd)
    m_t = sampling.sample_ggx_vndf(wo_l, ax, u2, roughness_y=ay)
    cos_om = vm.dot(wo_l, m_t)
    f_r = common.fresnel_dielectric(jnp.abs(cos_om), 1.0 / eta)
    refr, tir = vm.refract(-wo_l, m_t, eta)
    do_reflect_t = (u[..., 3] < f_r) | tir
    wi_trans = jnp.where(
        do_reflect_t[..., None], vm.reflect(-wo_l, m_t), vm.normalize(refr)
    )

    wi_l = jnp.where(
        pick_diffuse[..., None],
        wi_diff,
        jnp.where(
            pick_spec[..., None],
            wi_spec,
            jnp.where(pick_cc[..., None], wi_cc, wi_trans),
        ),
    )
    # Detached-sampling: the sampled direction is sampling machinery — cut
    # its (roughness-dependent) backward chain here so `f = evaluate(wi)`
    # only carries shading gradients. Without this, sqrt(0) corners in the
    # VNDF warp produce NaN cotangents.
    wi_l = jax.lax.stop_gradient(wi_l)
    wi = vm.to_world_frame(wi_l, t, b, n)
    f, pdf = evaluate(materials, sd, wo, wi)
    # transmission reflect-branch pdf correction: the Fresnel reflection off a
    # transmissive microfacet looks like the specular lobe; fold its
    # probability into the pdf to stay unbiased.
    h_rfl = vm.normalize(wo_l + wi_l)
    h_rfl = jnp.where((h_rfl[..., 2:3] < 0.0), -h_rfl, h_rfl)
    oh = jnp.maximum(vm.dot(wo_l, h_rfl), 0.0)
    pdf_spec_extra = common.ggx_vndf_pdf_aniso(
        wo_l, h_rfl, ax, ay
    ) / jnp.maximum(4.0 * oh, 1e-8)
    pdf = pdf + jnp.where(
        wi_l[..., 2] > 0.0, lobes.p_transmission * f_r * pdf_spec_extra, 0.0
    )
    is_specular = (pick_spec | pick_cc | pick_trans) & (sd.roughness < 0.08)
    return wi, f, pdf, is_specular
