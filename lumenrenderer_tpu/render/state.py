"""Renderer frame state — an explicit, checkpointable pytree.

JAX equivalent of the mutable GPU buffers the reference keeps on
`WaveFrontRenderer` (accumulation/blend counter `WaveFrontRenderer.h:99-108`,
frame index swap `WaveFrontRenderer.cpp:1039-1081`) — except here the whole
render state is one pytree: donate it through the jitted step, shard it,
save/restore it (SURVEY.md §5.4: accumulation + RNG + reservoirs = true
resume for long renders).
"""
from __future__ import annotations

from typing import Any, Optional

import chex
import jax
import jax.numpy as jnp


@chex.dataclass
class FrameState:
    accum: jnp.ndarray         # (N,3) running-average radiance
    blend_count: jnp.ndarray   # () int32 frames accumulated
    frame_index: jnp.ndarray   # () uint32 monotonically increasing
    key: jax.Array             # PRNG key
    restir: Optional[Any] = None  # ReSTIR reservoir state (M5)


def init_state(num_pixels: int, seed: int = 0, restir: Optional[Any] = None) -> FrameState:
    return FrameState(
        accum=jnp.zeros((num_pixels, 3), jnp.float32),
        blend_count=jnp.zeros((), jnp.int32),
        frame_index=jnp.zeros((), jnp.uint32),
        key=jax.random.PRNGKey(seed),
        restir=restir,
    )


def reset_accumulation(state: FrameState) -> FrameState:
    """≙ blend reset on camera move (`OutputLayer.cpp:519,559`)."""
    return state.replace(
        accum=jnp.zeros_like(state.accum), blend_count=jnp.zeros_like(state.blend_count)
    )
