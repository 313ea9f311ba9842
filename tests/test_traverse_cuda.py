"""The GPU traversal seam: which traversal dispatch lowers for each
platform, the kernel wrapper's packed node and triangle rows, and a walk
over those rows that mirrors native/traverse.cu step for step, checked
against the jnp reference on the CPU. The kernel itself runs only on a
card (``gpu`` marker; chip_smoke.py runs it at full size)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from snail.bvh import build_bvh
from snail.core.vecmath import BIG
from snail.ops import dispatch, traverse_cuda
from snail.ops.traverse_ref import STACK_CAP
from snail.scene.procedural import soup_scene
from snail.scene.scene import make_traced_scene


@pytest.fixture(scope="module")
def soup():
    g = soup_scene(300, spread=3.0, size=0.8, seed=5).flatten()
    lo, hi = g.bounds()
    return make_traced_scene(g, build_bvh(lo, hi, leaf_size=4))


@pytest.fixture(scope="module")
def rays():
    rng = np.random.default_rng(7)
    n = 256
    orig = rng.uniform(-6.0, 6.0, (n, 3)).astype(np.float32)
    tgt = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    d = tgt - orig
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.full(n, BIG, np.float32)
    tmax[::7] = -1.0  # masked rays
    tmax[1::5] = 4.0  # short segments
    return orig, d.astype(np.float32), tmax


QUERIES = {
    "closest_hit": (dispatch.closest_hit, traverse_cuda.CLOSEST_TARGET,
                    lambda o: o),
    "any_hit": (dispatch.any_hit, traverse_cuda.ANY_TARGET, lambda o: o),
    "any_hit_from": (dispatch.any_hit_from, traverse_cuda.ANY_TARGET,
                     lambda o: o[0]),
}


def _lowered(fn, scene, orig, dirn, tmax, platform):
    traced = jax.jit(lambda s, o, d, t: fn(s, o, d, t)).trace(
        scene, orig, dirn, tmax)
    return traced.lower(lowering_platforms=(platform,)).as_text()


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_dispatch_picks_kernel_for_cuda_and_reference_for_cpu(
        soup, rays, query):
    fn, target, origin = QUERIES[query]
    orig, d, tmax = rays
    args = (soup, jnp.asarray(origin(orig)), jnp.asarray(d),
            jnp.asarray(tmax))
    cuda = _lowered(fn, *args, "cuda")
    cpu = _lowered(fn, *args, "cpu")
    assert target in cuda
    assert "while" not in cuda  # no reference loop compiled for the GPU
    assert target not in cpu and "while" in cpu


def test_reference_backend_never_lowers_the_kernel(soup, rays):
    orig, d, tmax = rays
    txt = _lowered(dispatch.closest_hit, soup.with_backend("reference"),
                   jnp.asarray(orig), jnp.asarray(d), jnp.asarray(tmax),
                   "cuda")
    assert traverse_cuda.CLOSEST_TARGET not in txt and "while" in txt


def _bits(x):
    return np.asarray(x).view(np.int32)


def test_pack_nodes_rows_match_scene(soup):
    rows = np.asarray(traverse_cuda.pack_nodes(soup))
    assert rows.shape == (soup.num_nodes, 8) and rows.dtype == np.float32
    np.testing.assert_array_equal(rows[:, 0:3], soup.node_lo)
    np.testing.assert_array_equal(rows[:, 4:7], soup.node_hi)
    np.testing.assert_array_equal(_bits(rows[:, 3]), soup.node_child)
    meta = _bits(rows[:, 7])
    np.testing.assert_array_equal(meta >> 3, soup.node_count)
    np.testing.assert_array_equal((meta >> 2) & 1, soup.node_first)
    np.testing.assert_array_equal(meta & 3, soup.node_axis)


def test_pack_tris_follows_current_vertices(soup):
    moved = soup.tri_a + 1.5  # e.g. after a training step

    rows = np.asarray(jax.jit(traverse_cuda.pack_tris)(
        moved, soup.tri_ba, soup.tri_ca))
    assert rows.shape == (soup.tri_a.shape[0], 12)
    np.testing.assert_array_equal(rows[:, 0:3], moved)
    np.testing.assert_array_equal(rows[:, 4:7], soup.tri_ba)
    np.testing.assert_array_equal(rows[:, 8:11], soup.tri_ca)
    np.testing.assert_array_equal(rows[:, 3::4], 0.0)


def _walk_packed(nodes, tris, o, d, tmax, shadow):
    """native/traverse.cu for one ray, over the packed rows."""
    f = np.float32
    idir = f(1.0) / (d + f(1e-8))
    meta_all = nodes[:, 7].view(np.int32)
    child_all = nodes[:, 3].view(np.int32)
    active = tmax >= 0
    init = min(tmax, f(BIG))
    best = init if active else f(-BIG)
    hit = (0, f(0), f(0))
    stack = [0] if active else []
    while stack:
        node = stack.pop()
        t1 = (nodes[node, 0:3] - o) * idir
        t2 = (nodes[node, 4:7] - o) * idir
        tnear = np.minimum(t1, t2).max()
        tfar = np.maximum(t1, t2).min()
        limit = tmax if shadow else best
        if not (tnear <= tfar and tfar > 0 and tnear < limit):
            continue
        child, meta = int(child_all[node]), int(meta_all[node])
        cnt = meta >> 3
        if cnt == 0:
            fn = ((meta >> 2) & 1) ^ int(d[meta & 3] < 0)
            stack += [child + 1 - fn, child + fn]
            assert len(stack) <= STACK_CAP
            continue
        for tid in range(child, child + cnt):
            a, ba, ca = tris[tid, 0:3], tris[tid, 4:7], tris[tid, 8:11]
            n = np.cross(ba, ca)
            t = o - a
            det = d @ n
            u = d @ np.cross(t, ca)
            v = d @ np.cross(ba, t)
            tmul = -(t @ n)
            if shadow:
                if min(u, v) >= 0 and u + v <= det and 0 < tmul < tmax * det:
                    return True
                continue
            duv = det - u - v
            side = max(u, v, duv) <= 0 or min(u, v, duv) >= 0
            if side and det != 0:
                dist = tmul / det
                if 0 < dist < best:
                    best, hit = dist, (tid, u / det, v / det)
    if shadow:
        return False
    return (best if best < init else f(BIG)) if active else f(-BIG), hit


@pytest.mark.parametrize("shadow", [False, True])
def test_packed_walk_matches_reference(soup, rays, shadow):
    orig, d, tmax = rays
    nodes = np.asarray(traverse_cuda.pack_nodes(soup))
    tris = np.asarray(traverse_cuda.pack_tris(
        soup.tri_a, soup.tri_ba, soup.tri_ca))
    ref = soup.with_backend("reference")
    if shadow:
        want = np.asarray(dispatch.any_hit(ref, orig, d, tmax))
        got = [_walk_packed(nodes, tris, orig[i], d[i], tmax[i], True)
               for i in range(len(tmax))]
        assert want.any() and not want.all()
        np.testing.assert_array_equal(got, want)
        return
    dist, tri, bary = map(np.asarray, dispatch.closest_hit(ref, orig, d,
                                                           tmax))
    got = [_walk_packed(nodes, tris, orig[i], d[i], tmax[i], False)
           for i in range(len(tmax))]
    gdist = np.array([g[0] for g in got], np.float32)
    np.testing.assert_allclose(gdist, dist, rtol=1e-5)
    hit = (dist > 0) & (dist < BIG)
    assert hit.any() and not hit.all()
    np.testing.assert_array_equal([g[1][0] for g in got], np.where(hit, tri,
                                                                   0))
    gbary = np.array([g[1][1:] for g in got], np.float32)
    np.testing.assert_allclose(gbary[hit], bary[hit], atol=1e-5)


def test_library_is_keyed_by_source_and_kept_in_the_checkout():
    import os

    path = traverse_cuda.library_path()
    assert os.path.dirname(path) == traverse_cuda.BUILD_DIR
    assert os.path.basename(path).startswith("libsnail_traverse-")


def test_no_cuda_backend_needs_no_library(monkeypatch):
    def fail():
        raise AssertionError("built without a CUDA backend")

    monkeypatch.setattr(traverse_cuda, "build", fail)
    traverse_cuda.ensure_registered()
    assert not traverse_cuda._registered


@pytest.mark.gpu
def test_kernel_matches_reference_on_gpu(gpu_device, soup, rays):
    orig, d, tmax = (jax.device_put(x, gpu_device) for x in rays)
    scene = jax.device_put(soup, gpu_device)
    dist, tri, bary = map(np.asarray, jax.jit(dispatch.closest_hit)(
        scene, orig, d, tmax))
    rd, rt, rb = map(np.asarray, jax.jit(dispatch.closest_hit)(
        scene.with_backend("reference"), orig, d, tmax))
    np.testing.assert_allclose(dist, rd, rtol=1e-4)
    np.testing.assert_array_equal(tri, rt)
    np.testing.assert_allclose(bary, rb, atol=1e-4)
    blocked = np.asarray(jax.jit(dispatch.any_hit)(scene, orig, d, tmax))
    want = np.asarray(jax.jit(dispatch.any_hit)(
        scene.with_backend("reference"), orig, d, tmax))
    np.testing.assert_array_equal(blocked, want)
