"""Distributed differentiable-rendering training step.

The "full training step" of this framework: render the scene, compare to a
target image, differentiate w.r.t. scene parameters (materials, emission,
env — the north star's gradient targets), and apply an optax update. Under
the tile-sharded mesh (`parallel/shard.py`), XLA turns the parameter
gradients (replicated params, sharded pixel loss) into a psum
automatically and overlaps it with the backward pass — the gradient
all-reduce of a data-parallel trainer.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import optax

from ..core.camera import Camera
from ..integrator import wavefront
from ..scene.scene import SceneData


class TrainState(NamedTuple):
    params: dict            # differentiable scene leaves
    opt_state: optax.OptState
    step: jnp.ndarray


def split_params(scene: SceneData) -> Tuple[dict, SceneData]:
    """Extract the differentiable parameter dict from the scene."""
    params = {
        "base_color": scene.materials.base_color,
        "roughness": scene.materials.roughness,
        "metallic": scene.materials.metallic,
        "emissive": scene.materials.emissive,
        "env_radiance": scene.env_radiance,
    }
    return params, scene


def merge_params(scene: SceneData, params: dict) -> SceneData:
    return scene.replace(
        materials=scene.materials.replace(
            base_color=params["base_color"],
            roughness=params["roughness"],
            metallic=params["metallic"],
            emissive=params["emissive"],
        ),
        env_radiance=params["env_radiance"],
    )


def make_train_step(
    scene: SceneData,
    intersect_fn: Callable,
    occlude_fn: Callable,
    camera: Camera,
    cfg: wavefront.RenderConfig,
    optimizer: optax.GradientTransformation,
):
    """Returns (init_state, train_step) for inverse rendering against a
    target image (N,3). train_step is pure/jittable and GSPMD-shardable."""

    def loss_fn(params, key, frame_idx, target):
        sc = merge_params(scene, params)
        out = wavefront.render_wavefront(
            sc, intersect_fn, occlude_fn, camera, key, frame_idx, cfg
        )
        img = wavefront.merge_channels(out)
        return jnp.mean((img - target) ** 2)

    def train_step(state: TrainState, key, frame_idx, target):
        loss, grads = jax.value_and_grad(loss_fn)(
            state.params, key, frame_idx, target
        )
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1), loss

    def init_state() -> TrainState:
        params, _ = split_params(scene)
        return TrainState(params, optimizer.init(params), jnp.zeros((), jnp.int32))

    return init_state, train_step
