"""Procedural scenes, and a writer that saves them as OBJ/MTL files.

The reference ships .obj files (scenes/readme.txt) and its tests rely on
rendering them; these generators provide self-contained, seeded
equivalents for tests, benchmarks and the entry points, and
:func:`write_obj` / :func:`write_mtl` turn them into files for the loaders
and the render server, so nothing depends on a mounted asset directory.
"""

from __future__ import annotations

import os
from typing import Iterable

import numpy as np

from .base_scene import BaseScene, SceneObject


def _obj_from_tris(tri: np.ndarray, mat: int = 0) -> SceneObject:
    """SceneObject from a [N, 3, 3] float32 triangle soup (flat normals)."""
    n = tri.shape[0]
    return SceneObject(
        verts=tri.reshape(-1, 3).astype(np.float32),
        uvs=np.zeros((0, 2), np.float32),
        normals=np.zeros((0, 3), np.float32),
        tri_v=np.arange(n * 3, dtype=np.int32).reshape(n, 3),
        tri_vt=np.full((n, 3), -1, np.int32),
        tri_vn=np.full((n, 3), -1, np.int32),
        tri_mat=np.full(n, mat, np.int32),
    )


def _quad(a, b, c, d):
    """Two triangles for quad a-b-c-d (counter-clockwise)."""
    return np.asarray([[a, b, c], [a, c, d]], np.float32)


def box_tris(lo=(-1, -1, -1), hi=(1, 1, 1)) -> np.ndarray:
    """12 triangles of an axis-aligned box (the box.obj shape)."""
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    p = lambda x, y, z: (x, y, z)
    quads = [
        _quad(p(x0, y0, z0), p(x1, y0, z0), p(x1, y1, z0), p(x0, y1, z0)),
        _quad(p(x1, y0, z1), p(x0, y0, z1), p(x0, y1, z1), p(x1, y1, z1)),
        _quad(p(x0, y0, z1), p(x0, y0, z0), p(x0, y1, z0), p(x0, y1, z1)),
        _quad(p(x1, y0, z0), p(x1, y0, z1), p(x1, y1, z1), p(x1, y1, z0)),
        _quad(p(x0, y1, z0), p(x1, y1, z0), p(x1, y1, z1), p(x0, y1, z1)),
        _quad(p(x0, y0, z1), p(x1, y0, z1), p(x1, y0, z0), p(x0, y0, z0)),
    ]
    return np.concatenate(quads, axis=0)


def box_scene() -> BaseScene:
    """A single box — the box.obj test scene equivalent."""
    s = BaseScene()
    s.objects.append(_obj_from_tris(box_tris()))
    s.gen_normals()
    return s


def cornell_scene() -> BaseScene:
    """Open box room + two inner boxes; exercises shadows + reflections."""
    s = BaseScene()
    room = []
    # floor, back wall, left, right, ceiling
    room.append(_quad((-2, 0, -2), (2, 0, -2), (2, 0, 2), (-2, 0, 2)))
    room.append(_quad((-2, 0, -2), (-2, 4, -2), (2, 4, -2), (2, 0, -2)))
    room.append(_quad((-2, 0, -2), (-2, 0, 2), (-2, 4, 2), (-2, 4, -2)))
    room.append(_quad((2, 0, -2), (2, 4, -2), (2, 4, 2), (2, 0, 2)))
    room.append(_quad((-2, 4, -2), (-2, 4, 2), (2, 4, 2), (2, 4, -2)))
    s.objects.append(_obj_from_tris(np.concatenate(room, axis=0), mat=0))
    s.objects.append(
        _obj_from_tris(box_tris((-1.2, 0.0, -1.2), (-0.2, 2.0, -0.2)), mat=0)
    )
    s.objects.append(
        _obj_from_tris(box_tris((0.3, 0.0, 0.2), (1.3, 1.0, 1.2)), mat=0)
    )
    s.gen_normals()
    return s


def soup_scene(n: int = 1000, spread: float = 5.0, size: float = 0.6,
               seed: int = 0) -> BaseScene:
    """Random triangle soup — the incoherent-ray stress scene."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (n, 1, 3))
    tri = (base + rng.uniform(-size, size, (n, 3, 3))).astype(np.float32)
    s = BaseScene()
    s.objects.append(_obj_from_tris(tri))
    s.gen_normals()
    return s


def city_scene(grid: int = 24, seed: int = 0) -> BaseScene:
    """A grid of boxes of varying heights on a ground plane — a
    sponza-like benchmark stand-in (occlusion + shadow heavy) with
    ~``12*grid^2`` triangles."""
    rng = np.random.default_rng(seed)
    tris = [
        _quad(
            (-grid, 0, -grid), (grid, 0, -grid),
            (grid, 0, grid), (-grid, 0, grid),
        )
    ]
    for i in range(grid):
        for j in range(grid):
            if rng.uniform() < 0.3:
                continue
            x = (i - grid / 2) * 2.0 + rng.uniform(0.1, 0.4)
            z = (j - grid / 2) * 2.0 + rng.uniform(0.1, 0.4)
            w = rng.uniform(0.5, 1.4)
            h = rng.uniform(0.5, 6.0)
            tris.append(box_tris((x, 0, z), (x + w, h, z + w)))
    s = BaseScene()
    s.objects.append(_obj_from_tris(np.concatenate(tris, axis=0)))
    s.gen_normals()
    return s


def terrain_scene(n: int = 724, extent: float = 100.0, seed: int = 0,
                  octaves: int = 5) -> BaseScene:
    """Fractal-noise heightfield of ``2*n^2`` triangles — the large-scene
    benchmark stand-in for the reference's foot/thai meshes
    (benchmark.txt:78-80, 101-104; those .obj files are not mounted).
    n=724 gives ~1.05 Mtris, matching foot.obj's 1.06 Mtri scale."""
    rng = np.random.default_rng(seed)
    h = np.zeros((n + 1, n + 1), np.float32)
    for o in range(octaves):
        k = 4 * (2 ** o)
        if k >= n:
            break
        coarse = rng.normal(0.0, extent * 0.04 / (2 ** o), (k + 1, k + 1))
        yi = np.linspace(0, k, n + 1)
        xi = np.linspace(0, k, n + 1)
        y0 = np.clip(yi.astype(np.int64), 0, k - 1)
        x0 = np.clip(xi.astype(np.int64), 0, k - 1)
        fy = (yi - y0)[:, None]
        fx = (xi - x0)[None, :]
        c00 = coarse[np.ix_(y0, x0)]
        c01 = coarse[np.ix_(y0, x0 + 1)]
        c10 = coarse[np.ix_(y0 + 1, x0)]
        c11 = coarse[np.ix_(y0 + 1, x0 + 1)]
        h += ((1 - fy) * (1 - fx) * c00 + (1 - fy) * fx * c01
              + fy * (1 - fx) * c10 + fy * fx * c11).astype(np.float32)

    xs = np.linspace(-extent / 2, extent / 2, n + 1, dtype=np.float32)
    zs = np.linspace(-extent / 2, extent / 2, n + 1, dtype=np.float32)
    vx, vz = np.meshgrid(xs, zs, indexing="xy")
    verts = np.stack([vx, h, vz], axis=-1).reshape(-1, 3)

    idx = np.arange((n + 1) * (n + 1), dtype=np.int32).reshape(n + 1, n + 1)
    a = idx[:-1, :-1].reshape(-1)
    b = idx[:-1, 1:].reshape(-1)
    c = idx[1:, 1:].reshape(-1)
    d = idx[1:, :-1].reshape(-1)
    tri_v = np.concatenate(
        [np.stack([a, b, c], axis=1), np.stack([a, c, d], axis=1)], axis=0
    ).astype(np.int32)

    t = len(tri_v)
    s = BaseScene()
    s.objects.append(SceneObject(
        verts=verts.astype(np.float32),
        uvs=np.zeros((0, 2), np.float32),
        normals=np.zeros((0, 3), np.float32),
        tri_v=tri_v,
        tri_vt=np.full((t, 3), -1, np.int32),
        tri_vn=np.full((t, 3), -1, np.int32),
        tri_mat=np.zeros(t, np.int32),
    ))
    s.gen_normals()
    return s


def box_obj_scene() -> BaseScene:
    """The box.obj test scene as a modelling tool exports it: a 2x2x2 cube
    with 8 shared vertices, faces wound counter-clockwise seen from
    outside, one outward normal per face, every face in material
    "Material" from ``box.mtl``."""
    tris = box_tris()[:, [0, 2, 1]]  # box_tris winds faces inward
    verts, tri_v = np.unique(tris.reshape(-1, 3), axis=0,
                             return_inverse=True)
    fn = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    fn /= np.linalg.norm(fn, axis=-1, keepdims=True)
    normals, tri_n = np.unique(fn.round(6), axis=0, return_inverse=True)
    t = len(tris)
    s = BaseScene()
    s.mat_names["Material"] = 1
    s.mtl_libs.append("box.mtl")
    s.objects.append(SceneObject(
        verts=verts.astype(np.float32),
        uvs=np.zeros((0, 2), np.float32),
        normals=normals.astype(np.float32),
        tri_v=tri_v.reshape(t, 3).astype(np.int32),
        tri_vt=np.full((t, 3), -1, np.int32),
        tri_vn=np.repeat(tri_n.reshape(t, 1), 3, axis=1).astype(np.int32),
        tri_mat=np.ones(t, np.int32),
    ))
    return s


def write_obj(path: str, scene: BaseScene) -> None:
    """Save ``scene`` as a Wavefront OBJ that scene/wavefront.py reads back
    to the same objects (1-based v / vt / vn records, ``mtllib`` and
    ``usemtl`` from the scene's registries, triangles only)."""
    names = {mid: name for name, mid in scene.mat_names.items()}
    with open(path, "w") as fh:
        for lib in scene.mtl_libs:
            fh.write(f"mtllib {lib}\n")
        nv = nt = nn = 0
        for obj in scene.objects:
            np.savetxt(fh, obj.verts, fmt="v %.9g %.9g %.9g")
            if len(obj.uvs):
                np.savetxt(fh, obj.uvs, fmt="vt %.9g %.9g")
            if len(obj.normals):
                np.savetxt(fh, obj.normals, fmt="vn %.9g %.9g %.9g")
            corners = np.stack([obj.tri_v + 1 + nv,
                                np.where(obj.tri_vt >= 0,
                                         obj.tri_vt + 1 + nt, 0),
                                np.where(obj.tri_vn >= 0,
                                         obj.tri_vn + 1 + nn, 0)], axis=-1)
            # runs of one material share a usemtl record
            cuts = np.flatnonzero(np.diff(obj.tri_mat)) + 1
            for run in np.split(np.arange(obj.num_tris), cuts):
                if not len(run):
                    continue
                fh.write(f"usemtl {names[int(obj.tri_mat[run[0]])]}"
                         .rstrip() + "\n")
                for line in _face_lines(corners[run]):
                    fh.write(line)
            nv += len(obj.verts)
            nt += len(obj.uvs)
            nn += len(obj.normals)


def _face_lines(corners: np.ndarray) -> Iterable[str]:
    """``f`` records for [T, 3, (v, vt, vn)] 1-based indices (0 = none)."""
    for tri in corners.tolist():
        parts = []
        for v, vt, vn in tri:
            if vn:
                parts.append(f"{v}/{vt or ''}/{vn}")
            elif vt:
                parts.append(f"{v}/{vt}")
            else:
                parts.append(str(v))
        yield "f " + " ".join(parts) + "\n"


def write_mtl(path: str, descs) -> None:
    """Save MaterialDescs (scene/materials.py) as a ``.mtl`` library."""
    with open(path, "w") as fh:
        for d in descs:
            fh.write(f"newmtl {d.name}\n")
            fh.write("Kd %.6g %.6g %.6g\n" % tuple(d.diffuse))
            fh.write("Ks %.6g %.6g %.6g\n" % tuple(d.specular))
            fh.write("Ke %.6g %.6g %.6g\n" % tuple(d.emissive))
            if d.dissolve_factor > 0:
                fh.write(f"d {d.dissolve_factor:.6g}\n")
            if d.specular_exponent > 0:
                fh.write(f"Ns {d.specular_exponent:.6g}\n")
            if d.diffuse_map:
                fh.write(f"map_Kd {d.diffuse_map}\n")
            fh.write("\n")


def smoke_base(n: int = 224, seed: int = 0) -> BaseScene:
    """``terrain_scene(n, seed)`` in the one material "terrain" of
    :func:`smoke_material`, from ``terrain.mtl``."""
    base = terrain_scene(n, seed=seed)
    base.objects[0].tri_mat[:] = 1
    base.mat_names["terrain"] = 1
    base.mtl_libs.append("terrain.mtl")
    return base


def smoke_material():
    from .materials import MaterialDesc

    return MaterialDesc(name="terrain", diffuse=(0.7, 0.65, 0.55),
                        specular=(0.3, 0.3, 0.3))


# 45 degrees up over one corner: hills cast shadows, and no visible point
# is lit at grazing incidence, where one shadow decision can flip between
# two devices' rounding and move a vertex gradient by ~1e-3 (PERF.md)
SMOKE_LIGHT = ((-40.0, 45.0, 30.0), (1.0, 1.0, 1.0), 200.0)


def smoke_scene(n: int = 224, seed: int = 0, backend: str = "auto",
                leaf_size=None):
    """The GPU smoke and benchmark scene: :func:`smoke_base` (n=224 gives
    100,352 triangles, the scale of the reference's feline.obj flagship)
    with reflectivity 0.3, so the reflection bounce really runs, lit by
    one point light. Returns (TracedScene, Camera)."""
    from ..bvh import build_bvh
    from ..core.types import Light
    from .materials import MaterialTable
    from .scene import LEAF_SIZE, make_traced_scene

    base = smoke_base(n, seed)
    mats = MaterialTable.build(base.mat_names, [smoke_material()],
                               reflectivity={"terrain": 0.3})
    g = base.flatten()
    lo, hi = g.bounds()
    bvh = build_bvh(lo, hi, leaf_size=leaf_size or LEAF_SIZE)
    scene = make_traced_scene(g, bvh, mats, Light.make(*SMOKE_LIGHT),
                              backend=backend)
    return scene, smoke_camera(lo.min(axis=0), hi.max(axis=0))


def smoke_camera(lo, hi):
    """Oblique view over a terrain's bounding box."""
    from ..core.types import Camera

    center = (np.asarray(lo) + np.asarray(hi)) * 0.5
    ext = float(np.max(np.asarray(hi) - np.asarray(lo)))
    return Camera.look_at(
        pos=tuple(center + np.array([0.35, 0.25, 0.4]) * ext),
        target=tuple(center))
