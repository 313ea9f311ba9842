"""Gradient correctness: autodiff through traversal vs finite differences
(the S4 stage of SURVEY.md §7; BASELINE.json "pixel-gradient allclose")."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from snail.bvh import build_bvh
from snail.core.vecmath import BIG
from snail.diff.vjp import diff_closest_hit
from snail.scene.scene import make_traced_scene
from snail.scene.base_scene import BaseScene, SceneObject
from snail.core.types import Light


def _two_tri_scene(offset=0.0):
    """Two parallel quads-worth of triangles at z=0 and z=-2."""
    verts = np.array(
        [
            # front tri (z=0)
            [-1.0, -1.0, 0.0],
            [3.0, -1.0, 0.0],
            [-1.0, 3.0, 0.0],
            # back tri (z=-2), bigger
            [-4.0, -4.0, -2.0],
            [8.0, -4.0, -2.0],
            [-4.0, 8.0, -2.0],
        ],
        np.float32,
    )
    verts[:3, 2] += offset
    obj = SceneObject(
        verts=verts,
        uvs=np.zeros((0, 2), np.float32),
        normals=np.zeros((0, 3), np.float32),
        tri_v=np.array([[0, 1, 2], [3, 4, 5]], np.int32),
        tri_vt=np.full((2, 3), -1, np.int32),
        tri_vn=np.full((2, 3), -1, np.int32),
        tri_mat=np.zeros(2, np.int32),
    )
    scene = BaseScene()
    scene.objects.append(obj)
    return scene


def _traced(base):
    # the reference pipeline flips OBJ normals before building
    # (rtracer.cpp:554-560); the lighting dot>0 convention relies on it
    base.flip_normals()
    g = base.flatten()
    lo, hi = g.bounds()
    bvh = build_bvh(lo, hi, leaf_size=2)
    light = Light.make((0.0, 0.5, 5.0), (1.0, 1.0, 1.0), 50.0)
    return make_traced_scene(g, bvh, lights=light, backend="reference")


def test_dist_grad_wrt_vertices_matches_fd():
    import dataclasses

    base = _two_tri_scene()
    scene = _traced(base)
    orig = jnp.asarray([[0.3, 0.2, 5.0], [0.1, -0.4, 5.0]], jnp.float32)
    dirn = jnp.asarray([[0.0, 0.0, -1.0], [0.05, 0.02, -1.0]], jnp.float32)
    dirn = dirn / jnp.linalg.norm(dirn, axis=-1, keepdims=True)
    tmax = jnp.full(2, BIG)

    def loss(tri_a):
        s = dataclasses.replace(scene, tri_a=tri_a)
        dist, tri, bary = diff_closest_hit(s, orig, dirn, tmax)
        return jnp.sum(dist) + jnp.sum(bary)

    g = jax.grad(loss)(scene.tri_a)
    g = np.asarray(g)

    # central finite differences
    eps = 1e-3
    a0 = np.asarray(scene.tri_a)
    fd = np.zeros_like(a0)
    for i in range(a0.shape[0]):
        for k in range(3):
            ap = a0.copy()
            ap[i, k] += eps
            am = a0.copy()
            am[i, k] -= eps
            lp = float(loss(jnp.asarray(ap)))
            lm = float(loss(jnp.asarray(am)))
            fd[i, k] = (lp - lm) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=2e-2, atol=2e-3)


def test_ray_grads_flow():
    base = _two_tri_scene()
    scene = _traced(base)
    orig = jnp.asarray([[0.3, 0.2, 5.0]], jnp.float32)
    dirn = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    tmax = jnp.full(1, BIG)

    def f(orig):
        dist, _, _ = diff_closest_hit(scene, orig, dirn, tmax)
        return jnp.sum(dist)

    g = np.asarray(jax.grad(f)(orig))
    # moving the origin along -z by dz reduces dist by dz => d dist/d oz = +1
    np.testing.assert_allclose(g[0], [0.0, 0.0, 1.0], atol=1e-4)


def test_image_grads_wrt_light_and_materials():
    """End-to-end: grad of mean image brightness w.r.t. light color and
    material diffuse is positive where it should be."""
    import dataclasses

    from snail.core.types import Camera, RenderOpts
    from snail.render.renderer import render_frame

    base = _two_tri_scene()
    scene = _traced(base)
    cam = Camera.look_at((0.5, 0.5, 6.0), (0.5, 0.5, 0.0))
    opts = RenderOpts(reflections=False, transparency=False)

    def mean_img(light_color, diffuse):
        s = dataclasses.replace(
            scene,
            lights=dataclasses.replace(scene.lights, color=light_color),
            mat_diffuse=diffuse,
        )
        img = render_frame(s, cam, 16, 16, opts)
        return jnp.mean(img)

    g_light, g_mat = jax.grad(mean_img, argnums=(0, 1))(
        scene.lights.color, scene.mat_diffuse
    )
    assert float(jnp.abs(g_light).sum()) > 0.0
    assert float(jnp.abs(g_mat).sum()) > 0.0
    assert np.isfinite(np.asarray(g_light)).all()
    assert np.isfinite(np.asarray(g_mat)).all()


def test_pixel_grads_vs_fd_camera():
    """Pixel-gradient allclose vs finite differences through the whole
    renderer, w.r.t. a camera parameter (the BASELINE acceptance check,
    miniature)."""
    import dataclasses

    from snail.core.types import Camera, RenderOpts
    from snail.render.renderer import render_frame

    base = _two_tri_scene()
    scene = _traced(base)
    opts = RenderOpts(reflections=False, transparency=False, shadows=False)

    def img_of_z(z):
        cam = Camera(
            pos=jnp.asarray([0.5, 0.5, 0.0], jnp.float32)
            + jnp.asarray([0.0, 0.0, 1.0]) * z,
            right=jnp.asarray([1.0, 0.0, 0.0], jnp.float32),
            up=jnp.asarray([0.0, 1.0, 0.0], jnp.float32),
            front=jnp.asarray([0.0, 0.0, -1.0], jnp.float32),
            plane_dist=jnp.float32(1.0),
        )
        return render_frame(scene, cam, 8, 8, opts)

    z0 = jnp.float32(6.0)
    g = jax.jacfwd(img_of_z)(z0)
    eps = 1e-2
    fd = (np.asarray(img_of_z(z0 + eps)) - np.asarray(img_of_z(z0 - eps))) / (
        2 * eps
    )
    g = np.asarray(g)
    # compare only where FD is smooth (no visibility edge crossings)
    smooth = np.abs(fd) < 10.0
    np.testing.assert_allclose(g[smooth], fd[smooth], rtol=0.05, atol=5e-3)
