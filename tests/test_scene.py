"""Scene pipeline tests (loader + flatten), the S0 stage of SURVEY.md §7."""

import numpy as np
import pytest

from snail.scene import load_wavefront_obj, load_material_descs, MaterialTable


def test_box_counts(box_scene):
    # box.obj: 8 verts, 12 tris (a cube), 1 material ("Material")
    obj = box_scene.objects[0]
    assert obj.verts.shape == (8, 3)
    assert obj.num_tris == 12
    assert box_scene.mat_names == {"": 0, "Material": 1}
    assert (obj.tri_mat == 1).all()


def test_box_flatten(box_scene):
    g = box_scene.flatten()
    assert g.num_tris == 12
    # Unit cube centered at origin: edges are axis aligned, |cross| == 2*area
    lo, hi = g.bounds()
    np.testing.assert_allclose(lo.min(axis=0), [-1, -1, -1], atol=1e-5)
    np.testing.assert_allclose(hi.max(axis=0), [1, 1, 1], atol=1e-5)
    # each face diagonal-split triangle has area 2 => t0 == 4... actually
    # cube faces are 2x2 => triangle area 2, t0 = 2*area = 4
    np.testing.assert_allclose(g.t0, 4.0, rtol=1e-5)
    # normals unit length
    np.testing.assert_allclose(np.linalg.norm(g.nrm, axis=-1), 1.0, rtol=1e-5)


def test_box_normals_from_file(box_scene):
    g = box_scene.flatten()
    # box.obj provides axis-aligned vn normals; flat faces => zero deltas
    np.testing.assert_allclose(g.n_e1, 0.0, atol=1e-6)
    np.testing.assert_allclose(g.n_e2, 0.0, atol=1e-6)
    # per-corner normals match geometric normals up to sign conventions
    dots = np.abs(np.sum(g.n0 * g.nrm, axis=-1))
    np.testing.assert_allclose(dots, 1.0, atol=1e-5)


def test_feline_loads(scene_dir):
    scene = load_wavefront_obj(str(scene_dir / "terrain.obj"))
    assert scene.num_tris > 10000
    g = scene.flatten()
    assert np.isfinite(g.a).all()
    assert (g.t0 > 0).all()  # repair dropped degenerates


def test_gen_normals(scene_dir):
    scene = load_wavefront_obj(str(scene_dir / "terrain.obj"))
    obj = scene.objects[0]
    had_missing = (obj.tri_vn < 0).any()
    scene.gen_normals()
    if had_missing:
        assert (obj.tri_vn >= 0).all()


def test_flip_normals(box_path):
    scene = load_wavefront_obj(box_path)
    g0 = scene.flatten()
    scene.flip_normals()
    g1 = scene.flatten()
    np.testing.assert_allclose(g1.nrm, -g0.nrm, atol=1e-6)


def test_quad_triangulation_matches_reference(tmp_path):
    # reference fan for quads: (0,1,2) then (2,1,3) (wavefront_obj.cpp:160-165)
    p = tmp_path / "quad.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n")
    scene = load_wavefront_obj(str(p))
    tv = scene.objects[0].tri_v
    np.testing.assert_array_equal(tv, [[0, 1, 2], [2, 1, 3]])


def test_negative_indices(tmp_path):
    p = tmp_path / "neg.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n")
    scene = load_wavefront_obj(str(p))
    np.testing.assert_array_equal(scene.objects[0].tri_v, [[0, 1, 2]])


def test_mtl_parse(scene_dir):
    descs = load_material_descs(str(scene_dir / "test.mtl"))
    assert len(descs) > 0
    names = {d.name for d in descs}
    assert len(names) == len(descs)
    # single-value colors broadcast; all colors finite
    for d in descs:
        assert len(d.diffuse) == 3


def test_material_table(scene_dir):
    descs = load_material_descs(str(scene_dir / "test.mtl"))
    mat_names = {"": 0}
    for d in descs:
        mat_names[d.name] = len(mat_names)
    tbl = MaterialTable.build(mat_names, descs)
    assert tbl.num_materials == len(mat_names)
    # default material: white, opaque, untextured
    np.testing.assert_allclose(tbl.diffuse[0], 1.0)
    assert tbl.diffuse_tex[0] == -1
    assert tbl.dissolve[0] == 1.0


@pytest.mark.parametrize("which", ["box", "terrain"])
def test_obj_writer_roundtrip(tmp_path, which):
    """procedural.write_obj output loads back to the same geometry,
    normals, materials and mtllib (the fixtures rely on it)."""
    from snail.scene.procedural import (box_obj_scene, terrain_scene,
                                        write_obj)

    scene = box_obj_scene() if which == "box" else terrain_scene(12, seed=3)
    path = str(tmp_path / "s.obj")
    write_obj(path, scene)
    back = load_wavefront_obj(path)
    assert back.mat_names == scene.mat_names
    assert back.mtl_libs == scene.mtl_libs
    a, b = scene.flatten(), back.flatten()
    for f in ("a", "ba", "ca", "n0", "n_e1", "n_e2", "uv0"):
        np.testing.assert_allclose(getattr(b, f), getattr(a, f), atol=1e-6,
                                   err_msg=f)
    np.testing.assert_array_equal(b.mat_id, a.mat_id)
