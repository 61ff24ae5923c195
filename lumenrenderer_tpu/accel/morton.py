"""Morton (Z-order) codes for LBVH construction.

JAX replacement for the spatial-sorting role OptiX's internal BVH
builder plays in the reference (`OptixWrapper::BuildGeometryAccelerationStructure`,
`Framework/OptixWrapper.cpp:46-78`). 30-bit codes (10 bits/axis), fully
vectorized integer ops on the VPU.
"""
from __future__ import annotations

import jax.numpy as jnp


def expand_bits_10(v: jnp.ndarray) -> jnp.ndarray:
    """Spread the low 10 bits of v so there are 2 zero bits between each
    (standard Morton bit-interleave helper)."""
    v = v.astype(jnp.uint32) & 0x3FF
    v = (v | (v << 16)) & jnp.uint32(0x030000FF)
    v = (v | (v << 8)) & jnp.uint32(0x0300F00F)
    v = (v | (v << 4)) & jnp.uint32(0x030C30C3)
    v = (v | (v << 2)) & jnp.uint32(0x09249249)
    return v


def morton3d(p: jnp.ndarray, lo: jnp.ndarray, hi: jnp.ndarray) -> jnp.ndarray:
    """30-bit Morton codes of points p (...,3) normalized to [lo, hi]."""
    extent = jnp.maximum(hi - lo, 1e-12)
    q = jnp.clip((p - lo) / extent, 0.0, 1.0 - 1e-7)
    cell = (q * 1024.0).astype(jnp.uint32)
    x = expand_bits_10(cell[..., 0])
    y = expand_bits_10(cell[..., 1])
    z = expand_bits_10(cell[..., 2])
    return (x << 2) | (y << 1) | z
