"""BVH build invariants + traversal-vs-brute-force oracle tests
(the S1 stage of SURVEY.md §7; the veclib golden-test pattern, §4.1)."""

import numpy as np
import pytest

from snail.bvh import build_bvh, save_bvh, load_bvh, build_or_load
from snail.bvh.build import MAX_DEPTH
from snail.scene import load_wavefront_obj


def random_tris(rng, n, spread=10.0, size=0.5):
    base = rng.uniform(-spread, spread, (n, 1, 3))
    tri = base + rng.uniform(-size, size, (n, 3, 3))
    return tri.astype(np.float32)


def tri_bounds(tri):
    return tri.min(axis=1), tri.max(axis=1)


@pytest.mark.parametrize("method", ["binned", "sweep"])
def test_build_invariants(rng, method):
    tri = random_tris(rng, 500)
    lo, hi = tri_bounds(tri)
    bvh = build_bvh(lo, hi, leaf_size=4, method=method)

    assert bvh.depth <= MAX_DEPTH
    # permutation is a bijection
    assert sorted(bvh.order.tolist()) == list(range(500))

    # leaves cover [0, T) disjointly
    leaf = bvh.count > 0
    firsts = bvh.child[leaf]
    counts = bvh.count[leaf]
    seg = sorted(zip(firsts.tolist(), counts.tolist()))
    pos = 0
    for f, c in seg:
        assert f == pos
        pos += c
    assert pos == 500

    # every node's bbox contains its triangles' bboxes
    plo, phi = lo[bvh.order], hi[bvh.order]
    for nid in np.where(leaf)[0][:50]:
        f, c = bvh.child[nid], bvh.count[nid]
        assert (plo[f : f + c] >= bvh.node_lo[nid] - 1e-4).all()
        assert (phi[f : f + c] <= bvh.node_hi[nid] + 1e-4).all()

    # inner children are adjacent and contained in parent
    inner = np.where(~leaf)[0]
    for nid in inner[:50]:
        c = bvh.child[nid]
        for k in (0, 1):
            assert (bvh.node_lo[c + k] >= bvh.node_lo[nid] - 1e-4).all()
            assert (bvh.node_hi[c + k] <= bvh.node_hi[nid] + 1e-4).all()


def test_sah_beats_median_ish(rng):
    # SAH cost of the built tree should beat a degenerate flat leaf split
    tri = random_tris(rng, 2000, spread=50.0)
    lo, hi = tri_bounds(tri)
    bvh = build_bvh(lo, hi)
    # a single-leaf "tree" has cost == T
    assert bvh.sah_cost() < 2000 * 0.5


def test_cache_roundtrip(tmp_path, rng):
    tri = random_tris(rng, 100)
    lo, hi = tri_bounds(tri)
    b1 = build_or_load(lo, hi, cache_dir=str(tmp_path), name="t")
    b2 = build_or_load(lo, hi, cache_dir=str(tmp_path), name="t")
    np.testing.assert_array_equal(b1.order, b2.order)
    np.testing.assert_array_equal(b1.child, b2.child)
    # different input invalidates
    b3 = build_or_load(lo + 1.0, hi + 1.0, cache_dir=str(tmp_path), name="t")
    assert b3.num_nodes >= 1


def _flat_from_tri(tri):
    a = tri[:, 0]
    ba = tri[:, 1] - tri[:, 0]
    ca = tri[:, 2] - tri[:, 0]
    return a, ba, ca


@pytest.mark.parametrize("method", ["binned", "sweep"])
def test_traversal_matches_brute_force(rng, method):
    import jax.numpy as jnp
    from snail.ops import intersect_brute_force, traverse_bvh_ref
    from snail.core.vecmath import BIG

    tri = random_tris(rng, 300, spread=5.0, size=1.0)
    lo, hi = tri_bounds(tri)
    bvh = build_bvh(lo, hi, leaf_size=4, method=method)
    a, ba, ca = _flat_from_tri(tri[bvh.order])

    n_rays = 256
    orig = rng.uniform(-8, 8, (n_rays, 3)).astype(np.float32)
    target = rng.uniform(-5, 5, (n_rays, 3)).astype(np.float32)
    dirn = target - orig
    dirn /= np.linalg.norm(dirn, axis=-1, keepdims=True)
    tmax = np.full(n_rays, 1e30, np.float32)
    tmax[:8] = -1.0  # masked rays

    bf_dist, bf_tri, bf_bary = intersect_brute_force(
        jnp.asarray(orig), jnp.asarray(dirn), a, ba, ca
    )
    tv_dist, tv_tri, tv_bary = traverse_bvh_ref(
        bvh.node_lo, bvh.node_hi, bvh.child, bvh.count, bvh.axis,
        bvh.first_node, a, ba, ca, orig, dirn, tmax, leaf_max=4,
    )

    bf_dist = np.asarray(bf_dist)
    tv_dist = np.asarray(tv_dist)
    live = tmax >= 0
    hit_bf = bf_dist[live] < BIG / 2
    hit_tv = tv_dist[live] < BIG / 2
    np.testing.assert_array_equal(hit_bf, hit_tv)
    np.testing.assert_allclose(
        tv_dist[live][hit_tv], bf_dist[live][hit_bf], rtol=1e-4
    )
    np.testing.assert_array_equal(
        np.asarray(tv_tri)[live][hit_tv], np.asarray(bf_tri)[live][hit_bf]
    )
    np.testing.assert_allclose(
        np.asarray(tv_bary)[live][hit_tv],
        np.asarray(bf_bary)[live][hit_bf],
        atol=1e-4,
    )
    # masked rays report inactive
    assert (tv_dist[~live] < 0).all()


def test_shadow_matches_brute_force(rng):
    import jax.numpy as jnp
    from snail.ops import intersect_any_brute_force, traverse_bvh_shadow_ref

    tri = random_tris(rng, 200, spread=4.0, size=1.0)
    lo, hi = tri_bounds(tri)
    bvh = build_bvh(lo, hi, leaf_size=4)
    a, ba, ca = _flat_from_tri(tri[bvh.order])

    n_rays = 128
    light = np.array([0.0, 20.0, 0.0], np.float32)
    surf = rng.uniform(-4, 4, (n_rays, 3)).astype(np.float32)
    dirn = surf - light
    dist = np.linalg.norm(dirn, axis=-1)
    dirn /= dist[:, None]
    orig = np.broadcast_to(light, (n_rays, 3)).copy()
    tmax = (dist * 0.9999).astype(np.float32)
    tmax[:5] = -np.inf  # masked

    bf = np.asarray(
        intersect_any_brute_force(
            jnp.asarray(orig), jnp.asarray(dirn), a, ba, ca, jnp.asarray(tmax)
        )
    )
    tv = np.asarray(
        traverse_bvh_shadow_ref(
            bvh.node_lo, bvh.node_hi, bvh.child, bvh.count, bvh.axis,
            bvh.first_node, a, ba, ca, orig, dirn, tmax, leaf_max=4,
        )
    )
    live = tmax >= 0
    np.testing.assert_array_equal(tv[live], bf[live])
    assert not tv[~live].any()


def test_box_scene_traversal(box_scene):
    """End-to-end: rays at the reference box.obj cube."""
    import jax.numpy as jnp
    from snail.ops import traverse_bvh_ref
    from snail.core.vecmath import BIG

    g = box_scene.flatten()
    lo, hi = g.bounds()
    bvh = build_bvh(lo, hi, leaf_size=4)
    gp = g.permuted(bvh.order)

    # orthographic-ish rays from z=+5 looking down -z in a 16x16 grid
    n = 16
    xs = np.linspace(-2, 2, n, dtype=np.float32)
    gx, gy = np.meshgrid(xs, xs)
    orig = np.stack([gx, gy, np.full_like(gx, 5.0)], axis=-1).reshape(-1, 3)
    dirn = np.broadcast_to(
        np.array([0, 0, -1], np.float32), orig.shape
    ).copy()
    tmax = np.full(len(orig), 1e30, np.float32)

    dist, tri, bary = traverse_bvh_ref(
        bvh.node_lo, bvh.node_hi, bvh.child, bvh.count, bvh.axis,
        bvh.first_node, gp.a, gp.ba, gp.ca, orig, dirn, tmax, leaf_max=4,
    )
    dist = np.asarray(dist)
    inside = (np.abs(orig[:, 0]) < 1.0) & (np.abs(orig[:, 1]) < 1.0)
    hit = dist < BIG / 2
    np.testing.assert_array_equal(hit, inside)
    np.testing.assert_allclose(dist[inside], 4.0, rtol=1e-5)


def test_traced_scene_rejects_trees_deeper_than_the_stack(rng):
    """make_traced_scene refuses a tree whose depth the traversal stack
    (STACK_CAP entries, shared by traverse_ref and the CUDA kernel) cannot
    hold, instead of letting the walk clamp its stack silently."""
    import dataclasses

    from snail.ops.traverse_ref import STACK_CAP
    from snail.scene.procedural import soup_scene
    from snail.scene.scene import make_traced_scene

    g = soup_scene(64, seed=2).flatten()
    lo, hi = g.bounds()
    bvh = build_bvh(lo, hi, leaf_size=4)
    make_traced_scene(g, dataclasses.replace(bvh, depth=STACK_CAP - 2))
    with pytest.raises(ValueError, match="stack"):
        make_traced_scene(g, dataclasses.replace(bvh, depth=STACK_CAP - 1))
