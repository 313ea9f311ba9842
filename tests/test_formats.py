"""Doom3 .proc / materials.mtr / .list loaders on synthetic inputs
(reference src/formats/doom3_proc.cpp:10-159, src/rtracer.cpp:518-547)."""

import numpy as np
import pytest

from snail.scene.doom3 import (
    load_any,
    load_doom3_proc,
    load_list,
    load_mat2texture_map,
)

MTR = """
table fancyTable { { 0, 1, 0.5 } }
textures/base_wall/lfwall1
{
    qer_editorimage textures/base_wall/lfwall1.tga
    diffusemap map textures/base_wall/lfwall1_d
    bumpmap textures/base_wall/lfwall1_local.tga
}
textures/rock/sharprock
{
    diffusemap textures/rock/sharprock.tga
}
"""

# One model, two surfaces: a real one (2 tris) and a decal (dropped).
# Vertices are written (x z y u v nx nz ny) per the Doom3 swizzle; loader
# must emit (x, y, z) with swapped winding.
PROC = """
mapProcFile003

model { "_area0" 2

/* surface 0 */ { "textures/base_wall/lfwall1" 4 6
( 0 0 0 0 0 0 1 0 ) ( 1 0 0 1 0 0 1 0 )
( 1 0 1 1 1 0 1 0 ) ( 0 0 1 0 1 0 1 0 )
0 1 2 0 2 3
}

/* surface 1 */ { "textures/decals/splat" 3 3
( 0 5 0 0 0 0 1 0 ) ( 1 5 0 1 0 0 1 0 ) ( 1 5 1 1 1 0 1 0 )
0 1 2
}
}

interAreaPortals { 0 0 }
"""


def test_mtr_parse(tmp_path):
    p = tmp_path / "materials.mtr"
    p.write_text(MTR)
    m = load_mat2texture_map(str(p))
    # "diffusemap map <tex>" form, .tga appended when missing
    assert m["textures/base_wall/lfwall1"] == "textures/base_wall/lfwall1_d.tga"
    # "diffusemap <tex>" form, .tga kept
    assert m["textures/rock/sharprock"] == "textures/rock/sharprock.tga"
    assert "fancyTable" not in m  # table blocks skipped


def test_proc_load(tmp_path):
    (tmp_path / "materials.mtr").write_text(MTR)
    p = tmp_path / "level.proc"
    p.write_text(PROC)
    scene = load_doom3_proc(str(p))
    assert len(scene.objects) == 1
    obj = scene.objects[0]
    # decal surface dropped -> 2 tris, 4 verts
    assert obj.tri_v.shape == (2, 3)
    assert obj.verts.shape == (4, 3)
    # (x z y) -> (x, y, z): file says "1 0 1" for vert 2 => (1, 1, 0)
    np.testing.assert_allclose(obj.verts[2], [1.0, 1.0, 0.0])
    # normals swizzled the same way: (0 1 0) in-file => (0, 0, 1)
    np.testing.assert_allclose(obj.normals[0], [0.0, 0.0, 1.0])
    # winding swap: indices "0 1 2" stored as (0, 2, 1)
    np.testing.assert_array_equal(obj.tri_v[0], [0, 2, 1])
    # material mapped through the mtr -> texture name registry
    tex_names = set(scene.mat_names)
    assert "textures/base_wall/lfwall1_d.tga" in tex_names


def test_list_concat(tmp_path, scene_dir, box_path):
    p = tmp_path / "both.list"
    p.write_text("box.obj\nbox.obj\n")
    scene = load_list(str(p), scene_dir=str(scene_dir))
    from snail.scene.wavefront import load_wavefront_obj

    single = load_wavefront_obj(box_path)
    assert scene.num_tris == 2 * single.num_tris


def test_load_any_dispatch(box_path):
    with pytest.raises(ValueError):
        load_any("scene.bin")
    obj = load_any(box_path)
    assert obj.num_tris > 0


# --- Desperados2 .v3o (reference src/formats/desperados2.cpp:66-187) ---

V3O = """
// comment line
D 1000, 2000, 3000, 0 0 0 0 0 0 0 0 0
D 2000, 2000, 3000, 0 0 0 0 0 0 0 0 0
D 1000, 3000, 3000, 0 0 0 0 0 0 0 0 0
D 1000, 2000, 4000, 0 0 0 0 0 0 0 0 0
SRF wall _ _ _ brick.tga _ _ _ _ _ 0
SRF fence _ _ _ wire.tga _ _ _ _ _ 1
P 3 1 2 3 0 0 0 0 1
P 3 1 2 4 0 0 0 0 2
P 4 1 2 3 4 0 0 0 1
TLS 3 2 3 4
"""


def test_v3o_load(tmp_path):
    import struct

    from snail.scene.desperados2 import load_v3o

    p = tmp_path / "level.v3o"
    p.write_text(V3O)
    scene = load_v3o(str(p))
    obj = scene.objects[0]
    # D x y z -> (x, -z, y) * 0.001 (desperados2.cpp:100-103)
    np.testing.assert_allclose(obj.verts[0], [1.0, -3.0, 2.0])
    # one-sided P (1) + two-sided P (2, duplicated) + quad P skipped
    # + TLS triple (1) = 4 triangles
    assert obj.num_tris == 4
    # final winding swap (i1, i0, i2) (desperados2.cpp:181-183):
    # file tri (0, 1, 2) -> stored (1, 0, 2)
    np.testing.assert_array_equal(obj.tri_v[0], [1, 0, 2])
    # two-sided duplicate: file (0,1,3) then flipped (1,0,3) ->
    # stored (1,0,3) and (0,1,3)
    np.testing.assert_array_equal(obj.tri_v[1], [1, 0, 3])
    np.testing.assert_array_equal(obj.tri_v[2], [0, 1, 3])
    # shading normal = negated file-order geometric normal, unit length
    ln = np.linalg.norm(obj.normals, axis=-1)
    np.testing.assert_allclose(ln, 1.0, rtol=1e-5)
    a, b, c = obj.verts[0], obj.verts[1], obj.verts[2]
    want = -np.cross(b - a, c - a)
    want /= np.linalg.norm(want)
    np.testing.assert_allclose(obj.normals[0], want, atol=1e-6)
    # flattens cleanly
    flat = scene.flatten()
    assert flat.num_tris == 4


def test_v3o_heightfield(tmp_path):
    import struct

    from snail.scene.desperados2 import load_v3o

    # 2x2 heightmap: u16 w, u16 h, 15 pad bytes, u16 samples
    hm = tmp_path / "map.raw"
    hm.write_bytes(struct.pack("<HH", 2, 2) + b"\0" * 15
                   + struct.pack("<4H", 100, 200, 300, 400))
    v3o = tmp_path / "hf.v3o"
    v3o.write_text(
        "D 0, 0, 0, 0 0 0 0 0 0 0 0 0\n"
        "D 1000, 0, 0, 0 0 0 0 0 0 0 0 0\n"
        "D 1000, 0, 1000, 0 0 0 0 0 0 0 0 0\n"
        "D 0, 0, 1000, 0 0 0 0 0 0 0 0 0\n"
        "HMAP map.raw\n"
        "HF 1 2 3 4 32767 0 0 0 0 0 0 1 1\n"
        "P 3 1 2 3 0 0 0 0 0\n"
    )
    scene = load_v3o(str(v3o))
    obj = scene.objects[0]
    # HF quad = 2 tris + the P (whose ids are offset by idxAdd=4,
    # the reference quirk) = 3
    assert obj.num_tris == 3
    assert len(obj.verts) == 8
    # corner height: -hmap[0,0] * (32767*255/32767) + 512 = -100*255+512
    h00 = -100.0 * 255.0 + 512.0
    np.testing.assert_allclose(obj.verts[4], [0.0, h00, 0.0], atol=1e-3)
    # the P after HF picks up idxAdd=4: file ids 1,2,3 -> verts 4,5,6
    np.testing.assert_array_equal(sorted(obj.tri_v[2]), [4, 5, 6])
