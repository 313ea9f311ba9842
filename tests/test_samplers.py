"""Bilinear + SAT samplers wired into shading (reference
sampling/bilinear_sampler.*, sat_sampler.h:10-57, NewSampler choice
sampling/sampler.cpp:9-44 -> RenderOpts.tex_filter)."""
import numpy as np
import jax.numpy as jnp

from snail.scene.textures import (
    build_pyramid_atlas, build_sat_atlas, sample_atlas, sample_sat_atlas,
)


def _atlas():
    rng = np.random.default_rng(3)
    img = (rng.random((32, 32, 3)) * 255).astype(np.uint8)
    atlas, meta = build_pyramid_atlas([img.astype(np.float32) / 255.0])
    return np.asarray(img, np.float64) / 255.0, jnp.asarray(atlas), \
        jnp.asarray(meta)


def test_bilinear_equals_point_at_texel_centers():
    img, atlas, meta = _atlas()
    w = h = 32
    ij = np.stack(np.meshgrid(np.arange(8), np.arange(8)), -1).reshape(-1, 2)
    uv = jnp.asarray((ij + 0.5) / w, jnp.float32)
    tid = jnp.zeros(uv.shape[0], jnp.int32)
    p = np.asarray(sample_atlas(atlas, meta, tid, uv, filter="point"))
    b = np.asarray(sample_atlas(atlas, meta, tid, uv, filter="bilinear"))
    np.testing.assert_allclose(p, b, atol=1e-6)


def test_bilinear_midpoint_averages_neighbors():
    img, atlas, meta = _atlas()
    w = 32
    # midpoint between texel (3, y) and (4, y) centers -> horizontal avg
    uv = jnp.asarray([[(4.0) / w, (5.5) / w]], jnp.float32)
    tid = jnp.zeros(1, jnp.int32)
    b = np.asarray(sample_atlas(atlas, meta, tid, uv, filter="bilinear"))[0]
    y = 32 - 1 - 5  # vertical flip
    expect = 0.5 * (img[y, 3] + img[y, 4])
    np.testing.assert_allclose(b, expect, atol=2e-2)


def test_sat_full_rect_is_texture_mean():
    img, atlas, meta = _atlas()
    sat = build_sat_atlas(atlas, meta)
    uv = jnp.asarray([[0.5, 0.5]], jnp.float32)
    duv = jnp.asarray([[1.0, 1.0]], jnp.float32)  # footprint = whole texture
    tid = jnp.zeros(1, jnp.int32)
    got = np.asarray(sample_sat_atlas(sat, meta, tid, uv, duv))[0]
    np.testing.assert_allclose(got, img.mean(axis=(0, 1)), atol=2e-2)


def test_render_paths_accept_all_filters():
    """End-to-end: the textured render runs under every tex_filter and
    the filters actually differ (the mip/test_mip scene)."""
    from snail.core.types import Camera, RenderOpts
    from snail.render.renderer import render_frame
    from snail.scene.scene import with_sat
    from test_mip import _textured_floor_scene

    scene = with_sat(_textured_floor_scene())
    cam = Camera.look_at(pos=(0.0, 3.0, 12.0), target=(0.0, 0.0, -30.0))
    imgs = {}
    for f in ("point", "bilinear", "sat"):
        opts = RenderOpts(reflections=False, transparency=False,
                          textures=True, tex_filter=f)
        imgs[f] = np.asarray(render_frame(scene, cam, 64, 64, opts))
        assert np.isfinite(imgs[f]).all()
    assert np.abs(imgs["point"] - imgs["bilinear"]).max() > 1e-4
    assert np.abs(imgs["point"] - imgs["sat"]).max() > 1e-4


def test_sat_wrap_seam_and_flip():
    """A footprint straddling the u-wrap seam averages across the seam
    (reference wrapped-rect addressing, sat_sampler.cpp:56-80), and the
    SAT orientation matches the point sampler's texel-space flip."""
    img, atlas, meta = _atlas()
    sat = build_sat_atlas(atlas, meta)
    tid = jnp.zeros(1, jnp.int32)
    w = 32
    # center on the seam, ~4-texel footprint: texels {30,31,0,1}
    # ([-1.95, 1.95] in texel units under the reference's floor-inclusive
    # rect convention, sat_sampler.cpp:56-60)
    uv = jnp.asarray([[0.0, (5.5) / w]], jnp.float32)
    duv = jnp.asarray([[3.9 / w, 0.5 / w]], jnp.float32)
    got = np.asarray(sample_sat_atlas(sat, meta, tid, uv, duv))[0]
    y = 32 - 1 - 5  # the point sampler's texel flip
    expect = img[y, [30, 31, 0, 1]].mean(axis=0)
    np.testing.assert_allclose(got, expect, atol=2e-2)

    # tiny footprint at a texel center == the point tap (flip parity)
    uv1 = jnp.asarray([[(7.0 + 0.5) / w, (9.0 + 0.5) / w]], jnp.float32)
    duv1 = jnp.asarray([[0.4 / w, 0.4 / w]], jnp.float32)
    got1 = np.asarray(sample_sat_atlas(sat, meta, tid, uv1, duv1))[0]
    p = np.asarray(sample_atlas(atlas, meta, tid, uv1, filter="point"))[0]
    np.testing.assert_allclose(got1, p, atol=2e-2)
