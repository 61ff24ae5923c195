"""Tiled-stream intersector: the Pallas visit kernel (interpret mode) and
the plain-XLA scan against each other and the brute-force oracle."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lumenrenderer_tpu.accel import brute, stream, tiled
from lumenrenderer_tpu.core.camera import generate_primary_rays
from lumenrenderer_tpu.ops.pallas import intersect as pk
from lumenrenderer_tpu.scene import presets

# the two implementations of the visit loop: the kernel runs in interpret
# mode here (the CPU), the scan is the plain-XLA reference
IMPLS = {"kernel": dict(interpret=True), "scan": dict(method="scan")}


def random_tris(rng, n, spread=2.0):
    c = rng.uniform(-spread, spread, size=(n, 1, 3))
    d = rng.normal(size=(n, 3, 3)) * 0.15
    return (c + d).astype(np.float32)


def random_rays(rng, r, spread=3.0):
    o = rng.uniform(-spread, spread, size=(r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("n_tris,k", [(30, 8), (200, 16), (500, 64)])
def test_closest_matches_brute(rng, n_tris, k, impl):
    tris = jnp.asarray(random_tris(rng, n_tris))
    cs = stream.build_clusters(tris, cluster_size=k)
    o, d = random_rays(rng, 300)  # deliberately not a RAY_TILE multiple
    res_s = tiled.intersect_closest(cs, o, d, 1e-4, 1e9, max_visits=64,
                                    **IMPLS[impl])
    res_b = brute.intersect_closest(tris, o, d, 1e-4, 1e9)
    assert not bool(res_s["overflow"])
    ib, ir = np.asarray(res_s["tri"]), np.asarray(res_b["tri"])
    same = ib == ir
    tie = np.isclose(np.asarray(res_s["t"]), np.asarray(res_b["t"]), rtol=1e-5)
    assert (same | tie).mean() > 0.995
    both = (ib >= 0) & same
    np.testing.assert_allclose(
        np.asarray(res_s["t"])[both], np.asarray(res_b["t"])[both], rtol=2e-4, atol=1e-5
    )


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_any_matches_brute(rng, impl):
    tris = jnp.asarray(random_tris(rng, 150))
    cs = stream.build_clusters(tris, cluster_size=16)
    o, d = random_rays(rng, 256)
    occ_s = np.asarray(tiled.intersect_any(cs, o, d, 1e-4, 4.0, max_visits=32,
                                           **IMPLS[impl]))
    occ_b = np.asarray(brute.intersect_any(tris, o, d, 1e-4, 4.0))
    assert (occ_s == occ_b).mean() > 0.995


def test_cornell_primary_hits():
    scene, camf = presets.cornell_box()
    sc, cam = scene.build(), camf(1.0)
    cs = stream.build_clusters(sc.tri_pos, cluster_size=8)
    o, d = generate_primary_rays(cam, 32, 32, jnp.uint32(0), jitter="center")
    rs = tiled.intersect_closest(cs, o, d, 1e-3, 1e9, max_visits=8,
                                 method="scan")
    rb = brute.intersect_closest(sc.tri_pos, o, d, 1e-3, 1e9)
    same = np.asarray(rs["tri"]) == np.asarray(rb["tri"])
    tie = np.isclose(np.asarray(rs["t"]), np.asarray(rb["t"]), rtol=1e-5)
    assert (same | tie).mean() > 0.999


def test_overflow_flag():
    rng = np.random.default_rng(9)
    tris = jnp.asarray(random_tris(rng, 400, spread=0.3))
    cs = stream.build_clusters(tris, cluster_size=8)
    o, d = random_rays(rng, 128, spread=0.5)
    res = stream.intersect_closest(cs, o, d, 1e-4, 1e9, max_pairs_per_ray=1)
    res_t = tiled.intersect_closest(cs, o, d, 1e-4, 1e9, max_visits=1,
                                    method="scan")
    assert bool(res_t["overflow"])


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_dead_rays_skip(impl):
    rng = np.random.default_rng(4)
    tris = jnp.asarray(random_tris(rng, 64))
    cs = stream.build_clusters(tris, cluster_size=16)
    o, d = random_rays(rng, 128)
    tmax = jnp.where(jnp.arange(128) % 2 == 0, 1e9, -1.0)  # half dead
    res = tiled.intersect_closest(cs, o, d, 1e-4, tmax, max_visits=32,
                                  **IMPLS[impl])
    dead = np.arange(128) % 2 == 1
    assert np.all(np.asarray(res["tri"])[dead] == -1)


def test_tree_culling_matches_dense(rng):
    """Hierarchical packet culling must agree with the dense path when the
    visit cap is not exceeded (soundness: no false misses)."""
    from lumenrenderer_tpu.accel import brute as br

    tris = jnp.asarray(random_tris(rng, 800, spread=3.0))
    cs = stream.build_clusters(tris, cluster_size=32)
    o, d = random_rays(rng, 384, spread=4.0)
    rb = br.intersect_closest(tris, o, d, 1e-4, 1e9)
    c = cs.num_clusters
    rt = tiled.intersect_closest(cs, o, d, 1e-4, 1e9, max_visits=c,
                                 culling="tree", method="scan")
    assert not bool(rt["overflow"])
    same = np.asarray(rt["tri"]) == np.asarray(rb["tri"])
    tie = np.isclose(np.asarray(rt["t"]), np.asarray(rb["t"]), rtol=1e-4)
    assert (same | tie).mean() > 0.998
    occ_t = np.asarray(tiled.intersect_any(cs, o, d, 1e-4, 3.0, max_visits=c,
                                           culling="tree", method="scan"))
    occ_b = np.asarray(br.intersect_any(tris, o, d, 1e-4, 3.0))
    assert (occ_t == occ_b).mean() > 0.998


def test_frustum_culling_matches_brute(rng):
    """Tile-frustum culling is conservative: with an uncapped visit budget it
    must agree with the brute-force oracle."""
    from lumenrenderer_tpu.accel import brute as br

    tris = jnp.asarray(random_tris(rng, 600, spread=3.0))
    cs = stream.build_clusters(tris, cluster_size=32)
    o, d = random_rays(rng, 384, spread=4.0)
    rf = tiled.intersect_closest(cs, o, d, 1e-4, 1e9,
                                 max_visits=cs.num_clusters, culling="frustum",
                                 method="scan")
    assert not bool(rf["overflow"])
    rb = br.intersect_closest(tris, o, d, 1e-4, 1e9)
    same = np.asarray(rf["tri"]) == np.asarray(rb["tri"])
    tie = np.isclose(np.asarray(rf["t"]), np.asarray(rb["t"]), rtol=1e-4)
    assert (same | tie).mean() > 0.998


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_uncapped_visits_match_brute_exactly(rng, impl):
    """mv = num_clusters (no truncation): the tiled intersector must agree
    with the brute oracle up to packed-key t-resolution ties, and occlusion
    must be exact — the guarantee the bench config relies on."""
    from lumenrenderer_tpu.accel import brute as br

    tris = jnp.asarray(random_tris(rng, 500, spread=3.0))
    cs = stream.build_clusters(tris, cluster_size=32)
    o, d = random_rays(rng, 512, spread=4.0)
    rt = tiled.intersect_closest(cs, o, d, 1e-4, 1e9,
                                 max_visits=cs.num_clusters, **IMPLS[impl])
    assert not bool(rt["overflow"])
    rb = br.intersect_closest(tris, o, d, 1e-4, 1e9)
    t_t, t_b = np.asarray(rt["t"]), np.asarray(rb["t"])
    finite = np.isfinite(t_b)
    assert (np.asarray(rt["tri"] >= 0) == finite).all()
    rel = np.abs(t_t[finite] - t_b[finite]) / np.maximum(t_b[finite], 1e-6)
    assert rel.max() < 2 ** -8  # key ties pick a co-near triangle at worst
    # occlusion: cap at half the closest-hit distance -> nothing can block
    occ = np.asarray(tiled.intersect_any(
        cs, o, d, 1e-4, jnp.asarray(np.where(finite, t_b * 0.5, -1.0)),
        **IMPLS[impl]))
    assert not occ.any()


# kernel (interpret mode) vs scan on identical visit lists, over both
# queries, both tile culling modes and two cluster widths
PARITY = [(q, culling, k) for q in ("closest", "any")
          for culling in ("dense", "frustum") for k in (32, 128)]


def _parity(rng, query, culling, k, capped):
    tris = jnp.asarray(random_tris(rng, 1000 if k == 128 else 400,
                                   spread=3.0))
    cs = stream.build_clusters(tris, cluster_size=k)
    o, d = random_rays(rng, 384, spread=4.0)
    mv = max(cs.num_clusters // 2, 1) if capped else cs.num_clusters
    if query == "any":
        ox = np.asarray(tiled.intersect_any(cs, o, d, 1e-4, 4.0, max_visits=mv,
                                            culling=culling, method="scan"))
        op = np.asarray(tiled.intersect_any(cs, o, d, 1e-4, 4.0, max_visits=mv,
                                            culling=culling, interpret=True))
        assert ox.any()
        assert (ox == op).all()
        return
    rx = tiled.intersect_closest(cs, o, d, 1e-4, 1e9, max_visits=mv,
                                 culling=culling, method="scan")
    rp = tiled.intersect_closest(cs, o, d, 1e-4, 1e9, max_visits=mv,
                                 culling=culling, interpret=True)
    assert bool(rp["overflow"]) == bool(rx["overflow"]) == capped
    same = np.asarray(rx["tri"]) == np.asarray(rp["tri"])
    tie = np.isclose(np.asarray(rx["t"]), np.asarray(rp["t"]), rtol=1e-3)
    assert (np.asarray(rx["tri"]) >= 0).any()
    assert (same | tie).mean() == 1.0


@pytest.mark.parametrize("query,culling,k", PARITY)
def test_pallas_interpret_matches_xla(rng, query, culling, k):
    """Uncapped visits (max_visits = C): kernel and scan agree exactly up
    to packed-key ties."""
    _parity(rng, query, culling, k, capped=False)


@pytest.mark.parametrize("query,culling,k", PARITY)
def test_pallas_capped_production_parity(rng, query, culling, k):
    """Capped max_visits: kernel and scan must pick identical winners from
    identical (truncated) visit lists."""
    _parity(rng, query, culling, k, capped=True)


def test_feature_rows_cover_cluster_layout(rng):
    """The kernel reads only FEATURE_ROWS of each (10, 4K) cluster block;
    every other row must be zero in the `build_clusters` layout."""
    tris = jnp.asarray(random_tris(rng, 300))
    cs = stream.build_clusters(tris, cluster_size=32)
    f = np.asarray(cs.tri_feat).reshape(cs.num_clusters, 10, 4, 32)
    for q, rows in enumerate(pk.FEATURE_ROWS):
        unread = [j for j in range(10) if j not in rows]
        assert not f[:, unread, q, :].any(), q
        assert f[:, list(rows), q, :].any(), q


@pytest.mark.parametrize("rb,kb,num_warps", [(16, 32, 4), (32, 64, 4),
                                              (128, 128, 8)])
@pytest.mark.parametrize("closest", [True, False])
def test_visit_kernel_block_shapes_agree(rng, rb, kb, num_warps, closest):
    """Row/triangle block sizes change only the schedule, never the
    result."""
    tris = jnp.asarray(random_tris(rng, 600, spread=3.0))
    cs = stream.build_clusters(tris, cluster_size=128)
    o, d = random_rays(rng, 256, spread=4.0)
    mv = cs.num_clusters
    inp = tiled.kernel_inputs(cs, o, d, 1e-4, 3.0, max_visits=mv)
    k_bits, _, low_bits = tiled._key_layout(128, mv)
    run = lambda **kw: np.asarray(pk.visit_scan(
        inp["rays"], cs.tri_feat, inp["sel"], inp["nv"], inp["tnb"], k=128,
        tile=tiled.RAY_TILE, mv=mv, k_bits=k_bits, low_bits=low_bits,
        closest=closest, interpret=True, **kw))
    ref = run()
    assert ref.shape == (256,)
    np.testing.assert_array_equal(
        run(rb=rb, kb=kb, num_warps=num_warps), ref)


def test_kernel_tangent_is_symbolic_zero(rng):
    """The kernel's custom_jvp: differentiating through the production
    intersector gives zero (not an error) w.r.t. the ray window."""
    tris = jnp.asarray(random_tris(rng, 100))
    cs = stream.build_clusters(tris, cluster_size=32)
    o, d = random_rays(rng, 128)

    def f(tmax):
        res = tiled.intersect_closest(cs, o, d, 1e-4, tmax, max_visits=8,
                                      decode=False, interpret=True)
        occ = tiled.intersect_any(cs, o, d, 1e-4, tmax, max_visits=8,
                                  interpret=True)
        return jnp.sum(jnp.where(res["tri"] >= 0, 1.0, 0.0) * tmax) \
            + jnp.sum(occ * tmax)

    g = jax.grad(f)(jnp.full((128,), 5.0))
    assert np.isfinite(np.asarray(g)).all()


def test_frame_passes_and_agreement():
    """`accel/passes.py`: primary/bounce/shadow rays for one camera, dead
    rays sorted last, and the kernel agreeing with the scan on each."""
    from lumenrenderer_tpu.accel import passes

    scene, camf = presets.cornell_box()
    sc, cam = scene.build(), camf(1.0)
    cs = stream.build_clusters(sc.tri_pos, cluster_size=32)
    ps = passes.make_passes(sc, cam, cs, 16, 8, interpret=True)
    assert set(ps) == set(passes.CLOSEST)
    c = cs.num_clusters
    for name, (o, d, tn, tx) in ps.items():
        assert o.shape == d.shape == (128, 3) and tn.shape == tx.shape
        live = np.asarray(tx) > np.asarray(tn)
        assert live.any()
        assert not (~live[:-1] & live[1:]).any(), name  # dead rays last
        closest = passes.CLOSEST[name]
        fn = tiled.intersect_closest if closest else tiled.intersect_any
        got = passes.agreement(
            fn(cs, o, d, tn, tx, max_visits=c, interpret=True),
            fn(cs, o, d, tn, tx, max_visits=c, method="scan"), closest)
        assert all(v == 1.0 for v in got.values()), (name, got)
    miss = {"tri": np.array([-1, 3]), "t": np.array([np.inf, 2.0])}
    hit = {"tri": np.array([5, 4]), "t": np.array([1.0, 2.001])}
    assert passes.agreement(miss, hit, True) == {
        "hit_set_equal": 0.5, "tri_or_t_equal": 1.0}
