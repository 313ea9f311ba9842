"""Photon radiance in the integrator (reference photons.cpp:68-195 +
the scene_trace photon render variant): an opt-in term that adds
gathered photon irradiance to the diffuse light sum."""
import numpy as np
import jax.numpy as jnp

from snail.bvh import build_bvh
from snail.core.types import Camera, Light, RenderOpts
from snail.render.photons import (
    build_photon_kdtree, gather_photons_grid, gather_photons_kd,
    photon_grid, trace_photons,
)
from snail.render.renderer import render_frame
from snail.render.integrator import shade_hits
from snail.scene.procedural import cornell_scene
from snail.scene.scene import make_traced_scene


def _scene():
    base = cornell_scene()
    g = base.flatten()
    lo, hi = g.bounds()
    bvh = build_bvh(lo, hi, leaf_size=8)
    lights = Light.make((0.0, 3.5, 0.0), (1.0, 0.9, 0.8), 30.0)
    return make_traced_scene(g, bvh, lights=lights, backend="reference")


def test_photon_term_matches_grid_gather():
    """render(photons on) - render(photons off) == diffuse * gathered
    irradiance * exposure, ray for ray."""
    scene = _scene()
    pmap = trace_photons(scene, n_per_light=512)
    lo = np.asarray(scene.node_lo[0])
    hi = np.asarray(scene.node_hi[0])
    pg = photon_grid(pmap, lo, hi, res=16)
    cam = Camera.look_at(pos=(0.0, 2.0, 6.0), target=(0.0, 1.5, 0.0))
    base_opts = dict(reflections=False, transparency=False, textures=False)
    opts_off = RenderOpts(**base_opts)
    opts_on = RenderOpts(photons=True, photon_exposure=0.5, **base_opts)

    img_off = np.asarray(render_frame(scene, cam, 32, 32, opts_off))
    img_on = np.asarray(
        render_frame(scene, cam, 32, 32, opts_on, photon_grid=pg))

    # oracle: recompute the expected delta from the shading quantities
    from snail.core.vecmath import BIG
    from snail.diff.vjp import diff_closest_hit
    from snail.render.raygen import primary_rays, tile_rays, untile_image

    origin, dirs = primary_rays(cam, 32, 32)
    d = tile_rays(dirs, 1, 1).reshape(-1, 3)
    o = jnp.broadcast_to(origin, d.shape)
    tmax = jnp.full(d.shape[:1], BIG, jnp.float32)
    dist, tri, bary = diff_closest_hit(scene, o, d, tmax)
    samples = shade_hits(scene, o, d, dist, tri, bary, opts_off)
    rad = gather_photons_grid(pg, samples["pos"])
    delta = np.asarray(samples["diffuse"] * rad * 0.5)
    delta = np.where(np.asarray(samples["hit"])[:, None], delta, 0.0)
    expected = np.asarray(
        untile_image(jnp.asarray(delta).reshape(-1, 1, 3), 32, 32, 1, 1))

    got = img_on - img_off
    assert np.any(expected > 1e-5), "photon term should light something"
    np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-5)


def test_grid_gather_tracks_kd_oracle():
    """The dense-grid estimator agrees with the kd-tree range gather
    (photons.cpp:68-195) on average over surface points: both estimate
    the same power density field (different kernels, so compare loosely
    in aggregate, not pointwise)."""
    scene = _scene()
    pmap = trace_photons(scene, n_per_light=2048)
    kd = build_photon_kdtree(pmap)
    lo = np.asarray(scene.node_lo[0])
    hi = np.asarray(scene.node_hi[0])
    pg = photon_grid(pmap, lo, hi, res=24)

    rng = np.random.default_rng(0)
    pts = pmap.pos[rng.choice(pmap.pos.shape[0], size=32, replace=False)]
    grid_vals = np.asarray(gather_photons_grid(pg, jnp.asarray(pts)))
    kd_vals = np.stack([
        gather_photons_kd(kd, pmap, p, (0.0, 1.0, 0.0), radius=0.5)
        for p in pts
    ])
    # The two estimators use different normalizations (volumetric cell
    # density vs the kd gather's surface density / pi r^2 with cone +
    # normal weighting), so compare the FIELD SHAPE, scale-free: the
    # per-point energies must be positively correlated.
    g = grid_vals.sum(axis=1)
    k = kd_vals.sum(axis=1)
    assert g.sum() > 0 and k.sum() > 0
    gc = g - g.mean()
    kc = k - k.mean()
    corr = float((gc * kc).sum()
                 / np.sqrt((gc * gc).sum() * (kc * kc).sum() + 1e-12))
    assert corr > 0.4, corr
