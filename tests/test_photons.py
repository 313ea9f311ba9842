"""Photon mapping (reference src/photons.{h,cpp}): tracing lands photons
on geometry; grid radiance estimate agrees with the kd-tree oracle."""

import numpy as np
import pytest

import jax.numpy as jnp

from snail.core.types import Camera, Light
from snail.render.photons import (
    build_photon_kdtree,
    gather_photons_grid,
    gather_photons_kd,
    photon_grid,
    render_photon_preview,
    trace_photons,
)
from snail.scene.scene import load_scene


@pytest.fixture(scope="module")
def box_scene(box_path):
    return load_scene(
        box_path, cache_dir=None,
        lights=Light.make((0.0, 0.5, 0.0), (1.0, 1.0, 1.0), 40.0),  # inside the box
        backend="reference",
    )


@pytest.fixture(scope="module")
def pmap(box_scene):
    return trace_photons(box_scene, n_per_light=2048, seed=1)


def test_photons_land_on_geometry(box_scene, pmap):
    assert pmap.count > 1000  # light inside the box: most photons hit
    # every photon position must lie inside the scene bbox
    lo = np.asarray(box_scene.node_lo[0]) - 1e-3
    hi = np.asarray(box_scene.node_hi[0]) + 1e-3
    assert (pmap.pos >= lo).all() and (pmap.pos <= hi).all()
    # normals are unit
    np.testing.assert_allclose(
        np.linalg.norm(pmap.normal, axis=1), 1.0, atol=1e-3)


def test_kdtree_gather_matches_bruteforce(pmap):
    kd = build_photon_kdtree(pmap)
    point = pmap.pos.mean(axis=0)
    normal = np.array([0.0, 1.0, 0.0], np.float32)
    radius = 1.0

    acc = np.zeros(3, np.float32)
    d = np.linalg.norm(pmap.pos - point, axis=1)
    m = d < radius
    w = (1.0 - d[m] / radius) * np.maximum(0.0, pmap.normal[m] @ normal)
    acc = (pmap.power[m] * w[:, None]).sum(axis=0) / (np.pi * radius**2)

    got = gather_photons_kd(kd, pmap, point, normal, radius)
    np.testing.assert_allclose(got, acc, rtol=1e-4, atol=1e-6)


def test_grid_gather_tracks_kd_density(box_scene, pmap):
    """The grid estimate is a redesign, not a port — require correlation
    with the kd oracle across sample points, not equality."""
    lo = np.asarray(box_scene.node_lo[0])
    hi = np.asarray(box_scene.node_hi[0])
    pg = photon_grid(pmap, lo, hi, res=16)
    kd = build_photon_kdtree(pmap)

    rng = np.random.default_rng(0)
    sel = rng.choice(pmap.count, 48, replace=False)
    pts = pmap.pos[sel]
    grid_v = np.asarray(gather_photons_grid(pg, jnp.asarray(pts))).sum(1)
    # like-for-like: kd radius ~ grid smoothing scale, and query with the
    # photon's own surface normal so same-wall photons weight ~1
    kd_v = np.array([
        gather_photons_kd(kd, pmap, p, pmap.normal[i], radius=0.3).sum()
        for p, i in zip(pts, sel)
    ])
    # both should rank dense vs sparse regions the same way
    corr = np.corrcoef(grid_v, kd_v)[0, 1]
    assert corr > 0.5, corr


def test_photon_preview_smoke(box_scene, pmap):
    lo = np.asarray(box_scene.node_lo[0])
    hi = np.asarray(box_scene.node_hi[0])
    pg = photon_grid(pmap, lo, hi, res=16)
    cam = Camera.look_at(pos=(0.5, 1.0, 1.5), target=(0.0, 0.0, 0.0))
    img = np.asarray(render_photon_preview(box_scene, cam, 64, 64, pg,
                                           exposure=10.0))
    assert img.shape == (64, 64, 3)
    assert np.isfinite(img).all()
    assert img.max() > 0.0
