"""Edge-avoiding À-Trous wavelet denoiser.

JAX replacement for the reference's denoiser slots (OptiX AI
denoiser `Framework/OptixDenoiserWrapper.{h,cpp}`, NRD/DLSS via DX11
`Framework/Nvidia/*`): those are closed black boxes behind an interop
layer; here denoising is an open, differentiable JAX image filter driven by
the same feature buffers the reference feeds its denoisers (color, albedo,
normal, depth — `WaveFrontRenderer.cpp:614-649` snapshot names them).

Algorithm: Dammertz et al. 2010 edge-avoiding À-Trous with SVGF-style
edge-stopping on normal/depth/luminance; 5 dilated 5x5 passes. All
convolution-shaped — XLA fuses it tightly on the VPU.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

import numpy as np

_KERNEL = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0  # numpy: stays concrete under jit


def _demod_albedo(albedo):
    """Albedo divisor for demodulation: near-zero-albedo pixels (emitters,
    env misses) pass through unmodulated — dividing them by the epsilon
    floor would amplify them ~1000x and dominate every filter."""
    return jnp.where(albedo > 0.02, albedo, 1.0)


def _shift2(img, dy, dx):
    """Edge-clamped 2D shift of (H,W,C)."""
    h, w = img.shape[:2]
    ys = jnp.clip(jnp.arange(h) + dy, 0, h - 1)
    xs = jnp.clip(jnp.arange(w) + dx, 0, w - 1)
    return img[ys][:, xs]


@partial(jax.jit, static_argnames=("iterations",))
def atrous_denoise(
    color,       # (H,W,3) radiance
    albedo,      # (H,W,3)
    normal,      # (H,W,3)
    depth,       # (H,W)
    iterations: int = 5,
    sigma_color: float = 4.0,
    sigma_normal: float = 128.0,
    sigma_depth: float = 1.0,
):
    """Returns denoised (H,W,3). Demodulates albedo first (standard
    practice so texture detail is preserved) and re-modulates after."""
    alb_safe = _demod_albedo(albedo)
    demod = color / alb_safe
    lum = (
        demod[..., 0] * 0.2126 + demod[..., 1] * 0.7152 + demod[..., 2] * 0.0722
    )

    out = demod
    for it in range(iterations):
        step = 1 << it
        acc = jnp.zeros_like(out)
        wacc = jnp.zeros_like(depth)
        lum_c = (
            out[..., 0] * 0.2126 + out[..., 1] * 0.7152 + out[..., 2] * 0.0722
        )
        for ky in range(5):
            for kx in range(5):
                dy = (ky - 2) * step
                dx = (kx - 2) * step
                h = float(_KERNEL[ky] * _KERNEL[kx])
                c_s = _shift2(out, dy, dx)
                n_s = _shift2(normal, dy, dx)
                d_s = _shift2(depth[..., None], dy, dx)[..., 0]
                l_s = (
                    c_s[..., 0] * 0.2126 + c_s[..., 1] * 0.7152 + c_s[..., 2] * 0.0722
                )
                w_n = jnp.maximum(jnp.sum(n_s * normal, -1), 0.0) ** sigma_normal
                w_d = jnp.exp(
                    -jnp.abs(d_s - depth) / (sigma_depth * jnp.maximum(depth, 1e-3))
                )
                w_l = jnp.exp(-jnp.abs(l_s - lum_c) / sigma_color)
                w = h * w_n * w_d * w_l
                acc = acc + c_s * w[..., None]
                wacc = wacc + w
        out = acc / jnp.maximum(wacc, 1e-8)[..., None]
    return out * alb_safe


def denoise_frame(accum, aovs, width: int, height: int, **kw):
    """Convenience wrapper over flat (N,·) renderer outputs."""
    c = accum.reshape(height, width, 3)
    a = aovs["albedo"].reshape(height, width, 3)
    n = aovs["normal"].reshape(height, width, 3)
    d = aovs["depth"].reshape(height, width)
    return atrous_denoise(c, a, n, d, **kw).reshape(-1, 3)


# ---------------------------------------------------------------------------
# Temporal accumulation (SVGF-style), in front of the À-Trous pass.
#
# ≙ the reference's temporal denoiser mode: `OptixDenoiserWrapper.h:66-105`
# feeds previous output + 2D flow into OPTIX_DENOISER_MODEL_KIND_TEMPORAL.
# Here the same inputs (motion AOV from `core/camera.py:motion_vectors`,
# depth/normal feature buffers) drive an open reprojected-history blend with
# a neighbourhood variance clamp (Karis 2014) to bound ghosting.
# ---------------------------------------------------------------------------

import chex


@chex.dataclass
class TemporalState:
    """History carried between frames of an animated sequence."""

    hist: jnp.ndarray     # (H,W,3) accumulated (demodulated) radiance
    depth: jnp.ndarray    # (H,W) previous depth
    normal: jnp.ndarray   # (H,W,3) previous shading normal
    count: jnp.ndarray    # (H,W) history length (0 = no history)


def init_temporal_state(height: int, width: int) -> TemporalState:
    return TemporalState(
        hist=jnp.zeros((height, width, 3), jnp.float32),
        depth=jnp.zeros((height, width), jnp.float32),
        normal=jnp.zeros((height, width, 3), jnp.float32),
        count=jnp.zeros((height, width), jnp.float32),
    )


def _bilinear(img, py, px):
    """Bilinear sample of (H,W,C) at float pixel coords (edge-clamped)."""
    h, w = img.shape[:2]
    y0 = jnp.clip(jnp.floor(py).astype(jnp.int32), 0, h - 1)
    x0 = jnp.clip(jnp.floor(px).astype(jnp.int32), 0, w - 1)
    y1 = jnp.minimum(y0 + 1, h - 1)
    x1 = jnp.minimum(x0 + 1, w - 1)
    fy = jnp.clip(py - y0, 0.0, 1.0)[..., None]
    fx = jnp.clip(px - x0, 0.0, 1.0)[..., None]
    a = img[y0, x0]
    b = img[y0, x1]
    c = img[y1, x0]
    d = img[y1, x1]
    return (a * (1 - fx) + b * fx) * (1 - fy) + (c * (1 - fx) + d * fx) * fy


@jax.jit
def temporal_accumulate(
    state: TemporalState,
    color,    # (H,W,3) current noisy radiance (demodulated or raw)
    normal,   # (H,W,3)
    depth,    # (H,W)
    motion,   # (H,W,2) pixel-space (prev - current) deltas
    alpha_min: float = 0.12,
    clamp_k: float = 1.25,
):
    """Reproject history through motion vectors and blend.

    Validity = in-bounds + normal agreement + relative depth agreement
    (≙ the flow-guided temporal mode of `OptixDenoiserWrapper`). Reprojected
    history is clamped to the 3x3 neighbourhood mean ± clamp_k·sigma of the
    CURRENT frame before blending, so stale history can't ghost.

    Returns (new_state, blended (H,W,3)).
    """
    h, w = depth.shape
    yy, xx = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")
    px = xx + motion[..., 0]
    py = yy + motion[..., 1]
    in_b = (px >= 0) & (px <= w - 1) & (py >= 0) & (py <= h - 1)

    hist = _bilinear(state.hist, py, px)
    p_depth = _bilinear(state.depth[..., None], py, px)[..., 0]
    p_normal = _bilinear(state.normal, py, px)
    p_count = _bilinear(state.count[..., None], py, px)[..., 0]

    n_ok = jnp.sum(p_normal * normal, -1) > 0.85
    d_ok = jnp.abs(p_depth - depth) < 0.1 * jnp.maximum(depth, 1e-3) + 1e-2
    valid = in_b & n_ok & d_ok & (p_count > 0.5)

    # 3x3 neighbourhood statistics of the current frame (variance clamp)
    mean = jnp.zeros_like(color)
    m2 = jnp.zeros_like(color)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            s = _shift2(color, dy, dx)
            mean = mean + s
            m2 = m2 + s * s
    mean = mean / 9.0
    sigma = jnp.sqrt(jnp.maximum(m2 / 9.0 - mean * mean, 0.0))
    hist_c = jnp.clip(hist, mean - clamp_k * sigma, mean + clamp_k * sigma)

    count = jnp.where(valid, p_count + 1.0, 1.0)
    alpha = jnp.maximum(1.0 / count, alpha_min)[..., None]
    blended = jnp.where(
        valid[..., None], hist_c + (color - hist_c) * alpha, color
    )
    new_state = TemporalState(
        hist=blended, depth=depth, normal=normal, count=count
    )
    return new_state, blended


def temporal_denoise_frame(state, frame, aovs, width: int, height: int,
                           spatial: bool = True, **atrous_kw):
    """Full temporal+spatial pipeline over flat (N,·) renderer outputs.

    frame: the CURRENT frame's radiance (not the progressive accum).
    Returns (new_state, denoised (N,3)).
    """
    c = frame.reshape(height, width, 3)
    a = aovs["albedo"].reshape(height, width, 3)
    n = aovs["normal"].reshape(height, width, 3)
    d = aovs["depth"].reshape(height, width)
    m = aovs["motion"].reshape(height, width, 2)
    alb = _demod_albedo(a)
    state, blended = temporal_accumulate(state, c / alb, n, d, m)
    out = blended * alb
    if spatial:
        out = atrous_denoise(out, a, n, d, **atrous_kw)
    return state, out.reshape(-1, 3)
