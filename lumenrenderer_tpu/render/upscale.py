"""Render→output resolution decoupling (the reference's DLSS slot).

≙ `WaveFrontSettings` render vs output resolution
(`Framework/WaveFrontRenderer.h:41-45`) and the DLSS evaluate call
(`WaveFrontRenderer.cpp:975-993`). DLSS itself is closed NVIDIA IP behind a
DX11 interop; this slot is an open upscaler: bilinear / Lanczos3
via XLA resize, optionally sharpened. A learned JAX upscaler can drop into
the same seam later.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def upscale(img, out_h: int, out_w: int, method: str = "lanczos3", sharpen: float = 0.0):
    """img: (H,W,3) → (out_h,out_w,3)."""
    out = jax.image.resize(img, (out_h, out_w, img.shape[-1]), method=method)
    if sharpen > 0.0:
        blur = jax.image.resize(
            jax.image.resize(
                out,
                (max(out_h // 2, 1), max(out_w // 2, 1), img.shape[-1]),
                method="linear",
            ),
            out.shape,
            method="linear",
        )
        out = jnp.clip(out + sharpen * (out - blur), 0.0, None)
    return out
