"""Output post-processing: channel merge, blend, tonemap, quantize.

JAX equivalent of the reference's post-process block
(`Framework/WaveFrontRenderer.cpp:876-1010`): `MergeOutputChannels` with
blend-count running average (`CPUShadingKernels.cu:253-271`) and
`WriteToOutput` fp16→uchar4 conversion with `make_color` gamma
(`CUDAKernels/GPUShadingKernels.cu:28-56`).
"""
from __future__ import annotations

import struct
import zlib

import jax.numpy as jnp
import numpy as np


def blend_accumulate(
    accum: jnp.ndarray, frame: jnp.ndarray, blend_count: jnp.ndarray
) -> jnp.ndarray:
    """Progressive running average (≙ blend mode, `WaveFrontRenderer.h:99-108`).

    accum is the mean of `blend_count` frames; returns mean including `frame`.
    """
    n = blend_count.astype(jnp.float32)
    return (accum * n + frame) / (n + 1.0)


def tonemap_gamma(rgb: jnp.ndarray, gamma: float = 2.2, exposure: float = 1.0) -> jnp.ndarray:
    """Simple exposure + gamma (the reference's output shader applies gamma
    in `Sandbox/assets/shaders`; `make_color` clamps)."""
    x = jnp.clip(rgb * exposure, 0.0, None)
    return jnp.clip(x ** (1.0 / gamma), 0.0, 1.0)


def tonemap_aces(rgb: jnp.ndarray, exposure: float = 1.0) -> jnp.ndarray:
    """ACES filmic approximation (Narkowicz) — optional nicer curve."""
    x = jnp.clip(rgb * exposure, 0.0, None)
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return jnp.clip((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0) ** (1 / 2.2)


def to_uint8(rgb01: jnp.ndarray) -> jnp.ndarray:
    """≙ make_color: [0,1] float → uchar (RGB)."""
    return (jnp.clip(rgb01, 0.0, 1.0) * 255.0 + 0.5).astype(jnp.uint8)


def encode_png(img_uint8: np.ndarray) -> bytes:
    """(H,W,3) uint8 -> PNG bytes: 8-bit RGB, no filtering, zlib-deflated."""
    img = np.ascontiguousarray(img_uint8, np.uint8)
    h, w, c = img.shape
    assert c == 3, img.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    # each scanline is prefixed with filter type 0 (None)
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def save_png(path: str, img_uint8: np.ndarray) -> None:
    """Write (H,W,3) uint8 to PNG (≙ stb screenshot path,
    `OutputLayer.cpp:882-905`)."""
    with open(path, "wb") as f:
        f.write(encode_png(np.asarray(img_uint8)))
