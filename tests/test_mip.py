"""Mip selection wiring (texDiff, reference scene_inl.h:294 +
point_sampler.cpp:97-108): a grazing-angle textured plane must sample
mips > 0 through the full render path, matching the footprint oracle."""

import numpy as np
import pytest


def _textured_floor_scene():
    """A big textured floor quad, uv tiled so distant pixels have large
    uv footprints."""
    import jax.numpy as jnp

    from snail.bvh import build_bvh
    from snail.core.types import Light
    from snail.scene.base_scene import BaseScene, SceneObject
    from snail.scene.materials import MaterialTable
    from snail.scene.scene import make_traced_scene
    from snail.scene.textures import build_pyramid_atlas

    s = 200.0
    verts = np.array(
        [[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]], np.float32
    )
    uvs = np.array([[0, 0], [40, 0], [40, 40], [0, 40]], np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    obj = SceneObject(
        verts=verts,
        uvs=uvs,
        normals=np.zeros((0, 3), np.float32),
        tri_v=tris,
        tri_vt=tris.copy(),
        tri_vn=np.full_like(tris, -1),
        tri_mat=np.full(2, 1, np.int32),
        name="floor",
    )
    base = BaseScene()
    base.objects.append(obj)
    base.mat_names["floor"] = 1
    base.gen_normals()
    g = base.flatten()
    lo, hi = g.bounds()
    bvh = build_bvh(lo, hi, leaf_size=4)

    # 1-px checker at mip 0; mip >= 1 box-averages to flat 0.5 gray
    n = 64
    yy, xx = np.mgrid[0:n, 0:n]
    checker = ((xx + yy) % 2).astype(np.float32)
    img = np.stack([checker] * 3, axis=-1)
    atlas, meta = build_pyramid_atlas([img])

    mats = MaterialTable.build({"": 0, "floor": 1}, [])
    mats.diffuse_tex[1] = 0
    lights = Light.make((0.0, 50.0, 0.0), (1.0, 1.0, 1.0), 500.0)
    return make_traced_scene(g, bvh, materials=mats, lights=lights,
                             textures=(atlas, meta), backend="reference")


def test_footprint_oracle():
    """uv_footprint matches a numpy forward-difference oracle."""
    import jax.numpy as jnp

    from snail.scene.textures import uv_footprint

    rng = np.random.default_rng(7)
    th = tw = 8
    uv = rng.normal(size=(2 * th * tw, 2)).astype(np.float32)
    valid = rng.random(2 * th * tw) > 0.2
    out = np.asarray(uv_footprint(jnp.asarray(uv), (th, tw),
                                  jnp.asarray(valid)))

    q = uv.reshape(2, th, tw, 2)
    vq = valid.reshape(2, th, tw)
    exp = np.zeros_like(q)
    dy = np.abs(np.diff(q, axis=1))
    oky = (vq[:, 1:] & vq[:, :-1])[..., None]
    dy = np.where(oky, dy, 0.0)
    dy = np.concatenate([dy, dy[:, -1:]], axis=1)
    dx = np.abs(np.diff(q, axis=2))
    okx = (vq[:, :, 1:] & vq[:, :, :-1])[..., None]
    dx = np.where(okx, dx, 0.0)
    dx = np.concatenate([dx, dx[:, :, -1:]], axis=2)
    exp = np.maximum(dx, dy)
    np.testing.assert_allclose(out, exp.reshape(-1, 2), rtol=1e-6)


def test_grazing_plane_selects_higher_mips():
    """Through render_frame: near pixels keep the sharp checker, far
    (grazing) pixels collapse to the gray of mips >= 1 — and the selected
    mips match mip_from_footprint applied to the rendered footprints."""
    import jax.numpy as jnp

    from snail.core.types import Camera, RenderOpts
    from snail.render.renderer import render_frame

    scene = _textured_floor_scene()
    cam = Camera.look_at(pos=(0.0, 2.0, 0.0), target=(0.0, 0.0, -60.0))
    opts = RenderOpts(reflections=False, transparency=False, shadows=False)
    w = h = 64
    img = np.asarray(render_frame(scene, cam, w, h, opts))

    # ground occupies the lower half; top rows of the ground are far away
    far_rows = img[34:38, :, 0]
    near_rows = img[58:62, :, 0]
    # with mip 0 everywhere the checker has huge variance at any distance;
    # footprint-selected mips collapse the far rows to near-constant gray
    assert near_rows.std() > 0.1, near_rows.std()
    assert far_rows.std() < near_rows.std() * 0.5, (
        far_rows.std(), near_rows.std()
    )

    # mip 0 samples only the checker extremes; mips >= 1 are blended —
    # far rows dominated by blends proves footprint reached sample_atlas
    shaded_extremes = ((far_rows < 0.05) | (far_rows > 0.95)).mean()
    assert shaded_extremes < 0.5, shaded_extremes
