"""Volume subsystem (reference src/vtree.*, src/volume_data.*,
src/dicom_viewer.cpp): min/max pyramid, iso/MIP marching, DICOM IO."""

import numpy as np
import pytest

from snail.core.types import Camera
from snail.volume import build_vtree, load_dicom_dir, render_volume
from snail.volume.data import (
    synthetic_sphere,
    write_dicom_file,
    load_dicom_file,
)


@pytest.fixture(scope="module")
def sphere_tree():
    return build_vtree(synthetic_sphere(n=64))


def test_minmax_pyramid(sphere_tree):
    vt = sphere_tree
    assert vt.brick_max.shape == (16, 16, 16)
    assert vt.coarse_max.shape == (4, 4, 4)
    v = np.asarray(vt.vol)
    bm = np.asarray(vt.brick_max)
    # brick max bounds its voxels
    blk = v.reshape(16, 4, 16, 4, 16, 4).max(axis=(1, 3, 5))
    np.testing.assert_allclose(bm, blk)
    assert np.asarray(vt.brick_min).max() <= bm.max()


def test_iso_render_matches_analytic_silhouette(sphere_tree):
    n = 64
    cam = Camera.look_at(pos=(n * 0.5, n * 0.5, -1.5 * n),
                         target=(n * 0.5, n * 0.5, n * 0.5))
    img = np.asarray(render_volume(sphere_tree, cam, 96, 96, iso=0.03))
    lum = img.sum(-1)
    frac = (lum > 0).mean()
    # sphere radius 0.35*n at distance 2n, plane_dist 1 (height-normalized
    # fov): projected radius ~ 0.35n/2n = 0.175 of image height
    expect = np.pi * 0.175**2
    assert abs(frac - expect) < 0.35 * expect, (frac, expect)
    # center pixel hits, corner doesn't
    assert lum[48, 48] > 0 and lum[2, 2] == 0


def test_mip_render(sphere_tree):
    n = 64
    cam = Camera.look_at(pos=(n * 0.5, n * 0.5, -1.5 * n),
                         target=(n * 0.5, n * 0.5, n * 0.5))
    img = np.asarray(render_volume(sphere_tree, cam, 64, 64, mode="mip"))
    assert img.max() > 0.9  # normalized MIP peaks at sphere value
    assert img[0, 0].sum() == 0


def test_dicom_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    for i in range(4):
        px = rng.integers(0, 4000, (32, 24)).astype(np.uint16)
        write_dicom_file(str(tmp_path / f"s{i:02d}.dcm"), px,
                         slice_location=float(i) * 2.5,
                         pixel_spacing=(0.7, 0.8))
    pix, meta = load_dicom_file(str(tmp_path / "s01.dcm"))
    assert pix.shape == (32, 24)
    assert meta["slice_location"] == pytest.approx(2.5)
    vd = load_dicom_dir(str(tmp_path))
    assert vd.shape == (4, 32, 24)
    assert vd.spacing[0] == pytest.approx(2.5)
    assert vd.spacing[1:] == (pytest.approx(0.7), pytest.approx(0.8))
