"""Volumetric ray-marching: transmittance + single-scatter NEE.

JAX equivalent of `VolumetricShadeDirect`
(`CUDAKernels/VolumetricKernels/GPUVolumetricShadeDirect.cu:8-101`): the
reference marches MAX_STEPS=5 jittered steps between the volume entry/exit
reported by the custom-primitive IS (`Shaders/volumetric_wavefront.cu:60-97`)
and samples one CDF light per step. Here the AABB intersection is a dense
slab test over the (small) volume list, the march is a fixed-length
vectorized loop, and everything is differentiable w.r.t. the density grid
(stop-gradients only on sampling machinery).

Model: absorption+single scattering, isotropic phase (1/4π), Beer-Lambert
transmittance via jittered Riemann sum (the reference's scheme); optional
shadow-segment self-attenuation with a shorter secondary march.
"""
from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from ..core import vecmath as vm
from . import grid as grid_mod

INV_4PI = 1.0 / (4.0 * jnp.pi)


def _aabb_segment(lo, hi, o, d, t_min, t_max):
    """Entry/exit of rays (R,3) with one AABB. Returns (t0, t1, hit)."""
    inv = 1.0 / jnp.where(jnp.abs(d) > 1e-20, d, jnp.where(d >= 0, 1e-20, -1e-20))
    ta = (lo[None, :] - o) * inv
    tb = (hi[None, :] - o) * inv
    tn = jnp.max(jnp.minimum(ta, tb), axis=-1)
    tf = jnp.min(jnp.maximum(ta, tb), axis=-1)
    t0 = jnp.maximum(tn, t_min)
    t1 = jnp.minimum(tf, t_max)
    return t0, t1, t1 > t0


def march_single_volume(
    vols: grid_mod.VolumeSet,
    v: int,
    light_table,
    o: jnp.ndarray,
    d: jnp.ndarray,
    t_min: jnp.ndarray,
    t_max: jnp.ndarray,
    key,
    occlude_fn: Callable,
    steps: int = 5,
    light_samples: bool = True,
    detach_sampling: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (in_scatter (R,3), transmittance (R,)) for volume v.

    steps ≙ the reference's MAX_STEPS=5 with random offset
    (`GPUVolumetricShadeDirect.cu:8-101`).
    """
    from ..integrator import nee as nee_mod

    sg = jax.lax.stop_gradient if detach_sampling else (lambda x: x)
    r = o.shape[0]
    vidx = jnp.full((r,), v, jnp.int32)
    t0, t1, hit = _aabb_segment(vols.aabb_lo[v], vols.aabb_hi[v], o, d, t_min, t_max)
    seg = jnp.where(hit, t1 - t0, 0.0)
    dt = seg / steps
    u0 = jax.random.uniform(jax.random.fold_in(key, 7), (r,))

    sigma_t = vols.sigma_t[v]
    albedo = vols.albedo[v]

    trans = jnp.ones((r,), jnp.float32)
    scatter = jnp.zeros((r, 3), jnp.float32)

    for i in range(steps):
        t_i = t0 + (i + u0) * dt
        pos = o + t_i[:, None] * d
        dens = grid_mod.sample_density(vols, vidx, pos)
        sig = dens * sigma_t
        step_tau = sig * dt
        # transmittance up to the middle of this step (pre-attenuation)
        t_here = trans * jnp.exp(-0.5 * step_tau)
        if light_samples:
            lkey = jax.random.fold_in(key, 100 + i)
            u3 = jax.random.uniform(lkey, (r, 3))
            ls = nee_mod.sample_light(light_table, u3, pos)
            pdf_sa = nee_mod.pdf_solid_angle(ls)
            occluded = occlude_fn(
                pos, ls.wi, jnp.asarray(1e-3, jnp.float32), ls.dist - 2e-3
            )
            ok = hit & ls.valid & ~occluded & (pdf_sa > 1e-12) & (seg > 0)
            scale = jnp.where(ok, 1.0 / jnp.maximum(sg(pdf_sa), 1e-12), 0.0)
            # sigma_s * phase * T_to_here * L * dt
            contrib = (
                (albedo * sig * INV_4PI * t_here * sg(dt) * scale)[:, None]
                * ls.radiance
            )
            scatter = scatter + contrib
        trans = trans * jnp.exp(-step_tau)

    return scatter, jnp.where(hit, trans, 1.0)


def volume_scatter(
    vols: grid_mod.VolumeSet,
    light_table,
    o,
    d,
    t_min,
    t_max,
    key,
    occlude_fn,
    steps: int = 5,
    detach_sampling: bool = True,
):
    """Composite all volumes along the segment (independent media).
    Returns (in_scatter (R,3), transmittance (R,))."""
    trans = jnp.ones((o.shape[0],), jnp.float32)
    scatter = jnp.zeros((o.shape[0], 3), jnp.float32)
    for v in range(vols.count):
        s, t = march_single_volume(
            vols, v, light_table, o, d, t_min, t_max,
            jax.random.fold_in(key, v), occlude_fn, steps=steps,
            detach_sampling=detach_sampling,
        )
        scatter = scatter + trans[:, None] * s
        trans = trans * t
    return scatter, trans


def transmittance_only(vols, o, d, t_min, t_max, steps: int = 5, key=None,
                       estimator: str = "riemann", max_events: int = 64):
    """Transmittance along a segment (for shadow attenuation).

    estimator:
      "riemann" — jittered Riemann sum of optical depth (the reference's
        fixed 5-step scheme, `GPUVolumetricShadeDirect.cu:8-101`): biased
        for strongly heterogeneous grids.
      "ratio"   — ratio tracking (BASELINE config 4): unbiased null-collision
        estimator; Poisson event chain under the per-volume density majorant,
        statically bounded at `max_events` events (P(exceed) ~ Poisson tail
        of majorant*segment — negligible for sane majorants).
    """
    if estimator == "ratio":
        return _transmittance_ratio(vols, o, d, t_min, t_max, key,
                                    max_events=max_events)
    r = o.shape[0]
    trans = jnp.ones((r,), jnp.float32)
    u0 = 0.5 if key is None else jax.random.uniform(key, (r,))
    for v in range(vols.count):
        vidx = jnp.full((r,), v, jnp.int32)
        t0, t1, hit = _aabb_segment(vols.aabb_lo[v], vols.aabb_hi[v], o, d, t_min, t_max)
        seg = jnp.where(hit, t1 - t0, 0.0)
        dt = seg / steps
        tau = jnp.zeros((r,), jnp.float32)
        for i in range(steps):
            pos = o + (t0 + (i + u0) * dt)[:, None] * d
            tau = tau + grid_mod.sample_density(vols, vidx, pos) * vols.sigma_t[v] * dt
        trans = trans * jnp.exp(-tau)
    return trans


def _transmittance_ratio(vols, o, d, t_min, t_max, key, max_events: int = 64):
    """Ratio tracking: T = E[ prod_i (1 - sigma(x_i)/sigma_maj) ] with event
    distances ~ Exp(sigma_maj). Unbiased for heterogeneous grids (unlike the
    fixed-step Riemann march). Fixed-shape: a fori_loop of `max_events`
    events per volume; rays whose event chain passes the segment exit keep
    their weight (the common case after ~majorant*segment events)."""
    assert key is not None, "ratio tracking needs an RNG key"
    r = o.shape[0]
    trans = jnp.ones((r,), jnp.float32)
    # per-volume majorant: max grid density * sigma_t (NanoVDB grids carry
    # per-node maxima; dense grids take the global max)
    maj_all = grid_mod.density_majorant(vols)
    for v in range(vols.count):
        vkey = jax.random.fold_in(key, v)
        vidx = jnp.full((r,), v, jnp.int32)
        t0, t1, hit = _aabb_segment(
            vols.aabb_lo[v], vols.aabb_hi[v], o, d, t_min, t_max)
        maj = jnp.maximum(maj_all[v] * vols.sigma_t[v], 1e-8)

        def body(i, carry):
            t, w = carry
            u = jax.random.uniform(jax.random.fold_in(vkey, i), (r,))
            t_new = t - jnp.log(jnp.maximum(1.0 - u, 1e-12)) / maj
            inside = t_new < t1
            pos = o + t_new[:, None] * d
            dens = grid_mod.sample_density(vols, vidx, pos)
            ratio = 1.0 - dens * vols.sigma_t[v] / maj
            w = jnp.where(inside, w * ratio, w)
            return (t_new, w)

        _, w = jax.lax.fori_loop(
            0, max_events, body, (t0, jnp.ones((r,), jnp.float32)))
        trans = trans * jnp.where(hit, w, 1.0)
    return trans
