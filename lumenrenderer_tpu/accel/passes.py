"""Frame-shaped ray passes for checking and timing the intersector.

`make_passes` builds, for one camera, the three kinds of query a frame
issues: primary rays, bounce rays (cosine-sampled at the primary hits) and
shadow rays (toward a sampled light point), the latter two in the
integrator's sorted order (`accel/sorting.py`). `agreement` compares two
intersectors' answers on one pass.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core import camera as camera_mod
from ..core import sampling
from ..core import vecmath as vm
from ..integrator import nee
from . import sorting, tiled

CLOSEST = {"primary": True, "bounce": True, "shadow": False}


def _sorted(o, d, tn, tx, lo, hi, capsule):
    if capsule:
        key = sorting.capsule_sort_key(o, d, tx, lo, hi)
    else:
        key = sorting.ray_sort_key(o, d, lo, hi)
    key = jnp.where(tx > tn, key, jnp.uint32(0xFFFFFFFF))
    order = jnp.argsort(key)
    return o[order], d[order], tn[order], tx[order]


def make_passes(scene, cam, cs, width: int, height: int, seed: int = 0,
                interpret: bool = False):
    """{"primary" | "bounce" | "shadow": (o, d, t_min, t_max)}; dead rays
    (no primary hit, or no valid light sample) carry t_max < t_min."""
    n = width * height
    key = jax.random.PRNGKey(seed)
    o, d = camera_mod.generate_primary_rays(cam, width, height, jnp.uint32(0),
                                            key=key, jitter="center")
    tn = jnp.full((n,), 1e-3, jnp.float32)
    tx = jnp.full((n,), 1e8, jnp.float32)
    hit = tiled.intersect_closest(cs, o, d, tn, tx,
                                  max_visits=cs.num_clusters,
                                  interpret=interpret)
    ok = hit["tri"] >= 0
    p = o + jnp.where(ok, hit["t"], 0.0)[:, None] * d
    tri = scene.tri_pos[jnp.maximum(hit["tri"], 0)]
    nrm = vm.normalize(jnp.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]))
    nrm = jnp.where((vm.dot(nrm, d) > 0)[:, None], -nrm, nrm)
    org = p + nrm * 1e-3
    u = jax.random.uniform(jax.random.fold_in(key, 1), (n, 3))
    bd = vm.to_world(sampling.sample_cosine_hemisphere(u[:, :2]), nrm)
    ls = nee.sample_light(nee.build_light_table(scene, "cdf"), u, org)
    lo = jnp.min(scene.tri_pos.reshape(-1, 3), axis=0)
    hi = jnp.max(scene.tri_pos.reshape(-1, 3), axis=0)
    bounce = _sorted(org, bd, tn, jnp.where(ok, 1e8, -1.0), lo, hi, False)
    shadow = _sorted(org, ls.wi, tn,
                     jnp.where(ok & ls.valid, ls.dist - 2e-3, -1.0),
                     lo, hi, True)
    return {"primary": (o, d, tn, tx), "bounce": bounce, "shadow": shadow}


def agreement(a, b, closest: bool) -> dict:
    """Fractions of rays on which two answers agree. Closest: same hit/miss
    (`hit_set_equal`), and among rays both hit, the same triangle or t within
    2^-8 relative — the packed key's resolution (`tri_or_t_equal`). Any:
    equal occlusion bits (`occlusion_equal`)."""
    if not closest:
        return {"occlusion_equal": float(
            (np.asarray(a) == np.asarray(b)).mean())}
    ta, tb = np.asarray(a["tri"]), np.asarray(b["tri"])
    fa, fb = np.asarray(a["t"]), np.asarray(b["t"])
    both = (ta >= 0) & (tb >= 0)
    diff = np.subtract(fa, fb, out=np.zeros_like(fa), where=both)
    rel = np.abs(diff) / np.maximum(np.abs(np.where(both, fb, 1.0)), 1e-6)
    ok = (ta == tb) | ~both | (rel <= 2.0 ** -8)
    return {"hit_set_equal": float(((ta >= 0) == (tb >= 0)).mean()),
            "tri_or_t_equal": float(ok.mean())}
