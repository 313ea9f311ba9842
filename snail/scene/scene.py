"""Device-resident scene: the rebuild of ``Scene<AccStruct>``
(reference src/scene.h) as a jit-friendly pytree.

Holds the flat BVH node arrays, permuted triangle SoA, shading SoA,
material table and lights as device arrays. The traversal backend ("auto"
or the "reference" jnp while-loop) is a static field so the integrator
stays backend-agnostic, mirroring how the reference's ``Scene<BVH>`` vs
``Scene<DBVH>`` pick traversal at compile time.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import Light, static_field
from ..bvh.build import BVH
from ..ops.traverse_ref import STACK_CAP
from .base_scene import BaseScene, FlatGeometry
from .materials import MaterialTable


# Leaf size of load_scene's BVH: the fastest of 8, 16 and 32 for
# render_frame on the GPU (PERF.md, bring-up findings).
LEAF_SIZE = 16


def _register(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    data = [f.name for f in dataclasses.fields(cls) if not f.metadata.get("static")]
    meta = [f.name for f in dataclasses.fields(cls) if f.metadata.get("static")]
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    return cls


@_register
class TracedScene:
    # BVH (flat arrays, reference BVH::Node SoA-ized — bvh/tree.h:60-72)
    node_lo: jnp.ndarray
    node_hi: jnp.ndarray
    node_child: jnp.ndarray
    node_count: jnp.ndarray
    node_axis: jnp.ndarray
    node_first: jnp.ndarray
    # Triangles, permuted to leaf order (Triangle precompute, triangle.h:123-136)
    tri_a: jnp.ndarray
    tri_ba: jnp.ndarray
    tri_ca: jnp.ndarray
    # Shading triangles (ShTriangle deltas, triangle.h:181-230)
    sh_n0: jnp.ndarray
    sh_ne1: jnp.ndarray
    sh_ne2: jnp.ndarray
    sh_uv0: jnp.ndarray
    sh_uve1: jnp.ndarray
    sh_uve2: jnp.ndarray
    sh_mat: jnp.ndarray
    # Materials (SoA table)
    mat_diffuse: jnp.ndarray
    mat_specular: jnp.ndarray
    mat_emissive: jnp.ndarray
    mat_dissolve: jnp.ndarray
    mat_reflect: jnp.ndarray
    mat_flags: jnp.ndarray
    mat_difftex: jnp.ndarray
    mat_disstex: jnp.ndarray
    # Lights
    lights: Optional[Light]
    # Textures (atlas arrays; None => untextured scene)
    tex_atlas: Optional[jnp.ndarray] = None
    tex_meta: Optional[jnp.ndarray] = None
    tex_sat: Optional[jnp.ndarray] = None  # per-texture SATs (with_sat)
    # Row-packed shading/material tables: one row gather per hit instead
    # of scattered per-field gathers (the ShTriangle "64 B = one fetch
    # unit" idea, triangle.h:181-230). sh_pack f32[T,32]: n0.xyz, e1.xyz,
    # e2.xyz, u0,v0, du1,dv1, du2,dv2, mat, then the triangle's mat_pack
    # row. mat_pack f32[M,16]: kd.xyz, ks.xyz, reflect, dissolve, difftex,
    # disstex, emissive.xyz, flags, pad.
    sh_pack: Optional[jnp.ndarray] = None
    mat_pack: Optional[jnp.ndarray] = None
    # static meta
    num_tris: int = static_field(default=0)
    num_nodes: int = static_field(default=0)
    leaf_max: int = static_field(default=8)
    depth: int = static_field(default=32)
    # "auto": the CUDA kernel when lowered for a GPU, the jnp reference
    # otherwise; "reference": the jnp reference everywhere (the oracle)
    backend: str = static_field(default="auto")

    @property
    def bbox(self):
        return self.node_lo[0], self.node_hi[0]

    def with_backend(self, backend: str) -> "TracedScene":
        return dataclasses.replace(self, backend=backend)

    def with_lights(self, lights: Optional[Light]) -> "TracedScene":
        return dataclasses.replace(self, lights=lights)


def with_sat(scene: "TracedScene") -> "TracedScene":
    """Attach summed-area tables for RenderOpts(tex_filter="sat")
    (reference SATSampler, sampling/sat_sampler.h:10-57)."""
    import dataclasses

    from .textures import build_sat_atlas

    if scene.tex_atlas is None:
        return scene
    return dataclasses.replace(
        scene, tex_sat=build_sat_atlas(scene.tex_atlas, scene.tex_meta))


def make_traced_scene(
    geom: FlatGeometry,
    bvh: BVH,
    materials: Optional[MaterialTable] = None,
    lights: Optional[Light] = None,
    textures=None,
    backend: str = "auto",
) -> TracedScene:
    """Assemble device arrays from host-built pieces.

    The triangle arrays are permuted to the BVH's leaf order (the reference
    physically reorders tris at build, bvh/tree.cpp:245-253). Raises if
    the tree is deeper than the traversal stack holds.
    """
    if bvh.depth + 2 > STACK_CAP:
        raise ValueError(
            f"BVH depth {bvh.depth} needs a traversal stack of "
            f"{bvh.depth + 2} entries; the cap is {STACK_CAP}")
    g = geom.permuted(bvh.order)
    if materials is None:
        materials = MaterialTable.build({"": 0}, [])

    leaf_max = int(bvh.count.max()) if len(bvh.count) else 1

    def dev(x):
        return jnp.asarray(x)

    tex_atlas = tex_meta = None
    if textures is not None:
        tex_atlas, tex_meta = textures

    m = len(materials.diffuse)
    mat_pack = np.zeros((m, 16), np.float32)
    mat_pack[:, 0:3] = materials.diffuse
    mat_pack[:, 3:6] = materials.specular
    mat_pack[:, 6] = materials.reflectivity
    mat_pack[:, 7] = materials.dissolve
    mat_pack[:, 8] = materials.diffuse_tex.astype(np.float32)
    mat_pack[:, 9] = materials.dissolve_tex.astype(np.float32)
    mat_pack[:, 10:13] = materials.emissive
    mat_pack[:, 13] = materials.flags.astype(np.float32)

    t = len(g.a)
    # 32-wide rows: shading deltas (0:16) + the triangle's material row
    # denormalized into 16:32, so everything a hit needs is one row
    sh_pack = np.zeros((t, 32), np.float32)
    sh_pack[:, 0:3] = g.n0
    sh_pack[:, 3:6] = g.n_e1
    sh_pack[:, 6:9] = g.n_e2
    sh_pack[:, 9:11] = g.uv0
    sh_pack[:, 11:13] = g.uv_e1
    sh_pack[:, 13:15] = g.uv_e2
    sh_pack[:, 15] = g.mat_id.astype(np.float32)
    sh_pack[:, 16:32] = mat_pack[np.clip(g.mat_id, 0, m - 1)]

    return TracedScene(
        node_lo=dev(bvh.node_lo),
        node_hi=dev(bvh.node_hi),
        node_child=dev(bvh.child),
        node_count=dev(bvh.count),
        node_axis=dev(bvh.axis),
        node_first=dev(bvh.first_node),
        tri_a=dev(g.a),
        tri_ba=dev(g.ba),
        tri_ca=dev(g.ca),
        sh_n0=dev(g.n0),
        sh_ne1=dev(g.n_e1),
        sh_ne2=dev(g.n_e2),
        sh_uv0=dev(g.uv0),
        sh_uve1=dev(g.uv_e1),
        sh_uve2=dev(g.uv_e2),
        sh_mat=dev(g.mat_id),
        mat_diffuse=dev(materials.diffuse),
        mat_specular=dev(materials.specular),
        mat_emissive=dev(materials.emissive),
        mat_dissolve=dev(materials.dissolve),
        mat_reflect=dev(materials.reflectivity),
        mat_flags=dev(materials.flags),
        mat_difftex=dev(materials.diffuse_tex),
        mat_disstex=dev(materials.dissolve_tex),
        lights=lights,
        tex_atlas=tex_atlas,
        tex_meta=tex_meta,
        sh_pack=dev(sh_pack),
        mat_pack=dev(mat_pack),
        num_tris=geom.num_tris,
        num_nodes=bvh.num_nodes,
        leaf_max=leaf_max,
        depth=bvh.depth,
        backend=backend,
    )


def _load_geom_cached(obj_path, cache_dir, flip_normals, gen_normals):
    """OBJ parse with a flattened-geometry npz cache beside the BVH cache
    (the reference's dump/ idea extended to the parse step — OBJ text
    parsing dominated warm startup). Returns (FlatGeometry, BaseScene or
    None). A cache hit skips the text parse entirely; material names and
    mtl libs are stored alongside."""
    import dataclasses as _dc
    import json as _json
    import os

    import numpy as _np

    from .base_scene import FlatGeometry
    from .wavefront import load_wavefront_obj

    st = os.stat(obj_path)
    key = f"{st.st_size}:{int(st.st_mtime)}:{flip_normals}:{gen_normals}:g1"
    path = None
    if cache_dir:
        name = os.path.splitext(os.path.basename(obj_path))[0]
        path = os.path.join(cache_dir, f"{name}.geom.npz")
        if os.path.exists(path):
            try:
                z = _np.load(path, allow_pickle=False)
                if str(z["key"]) == key:
                    fields = [f.name for f in _dc.fields(FlatGeometry)]
                    geom = FlatGeometry(**{f: z[f] for f in fields})
                    meta = _json.loads(str(z["meta"]))
                    base = _CachedBaseMeta(meta["mat_names"],
                                           meta["mtl_libs"])
                    return geom, base
            except Exception:
                pass
    base = load_wavefront_obj(obj_path)
    if flip_normals:
        base.flip_normals()
    if gen_normals:
        base.gen_normals()
    geom = base.flatten()
    if path:
        import dataclasses as _dc2

        os.makedirs(cache_dir, exist_ok=True)
        _np.savez(
            path,
            key=key,
            meta=_json.dumps({"mat_names": base.mat_names,
                              "mtl_libs": base.mtl_libs}),
            **{f.name: getattr(geom, f.name)
               for f in _dc2.fields(FlatGeometry)},
        )
    return geom, base


class _CachedBaseMeta:
    """Stand-in for BaseScene when geometry comes from the npz cache —
    only the loader metadata the rest of load_scene touches."""

    def __init__(self, mat_names, mtl_libs):
        self.mat_names = mat_names
        self.mtl_libs = mtl_libs


def load_scene(
    obj_path: str,
    mtl_path: Optional[str] = None,
    tex_dir: Optional[str] = None,
    cache_dir: Optional[str] = "dump",
    flip_normals: bool = True,
    gen_normals: bool = True,
    lights: Optional[Light] = None,
    backend: str = "auto",
    leaf_size: int = LEAF_SIZE,
    bvh_method: str = "binned",
) -> TracedScene:
    """One-call scene load: the rtracer startup path
    (rtracer.cpp:518-587: load OBJ -> FlipNormals -> GenNormals ->
    BVH::Construct -> materials/textures -> UpdateMaterialIds)."""
    import os

    from ..bvh.cache import build_or_load
    from .wavefront import load_wavefront_obj
    from .materials import load_material_descs, MaterialTable
    from .lights import default_scene_lights

    geom, base = _load_geom_cached(obj_path, cache_dir, flip_normals,
                                   gen_normals)
    lo, hi = geom.bounds()
    name = os.path.splitext(os.path.basename(obj_path))[0]
    bvh = build_or_load(
        lo, hi, cache_dir=cache_dir, name=name, leaf_size=leaf_size,
        method=bvh_method,
    )

    descs = []
    if mtl_path is None:
        for lib in base.mtl_libs:
            cand = os.path.join(os.path.dirname(obj_path), lib)
            if os.path.exists(cand):
                mtl_path = cand
                break
    if mtl_path and os.path.exists(mtl_path):
        descs = load_material_descs(mtl_path)

    textures = None
    tex_ids = {}
    if tex_dir and descs:
        from .textures import load_texture_atlas

        textures, tex_ids = load_texture_atlas(descs, tex_dir)

    mats = MaterialTable.build(base.mat_names, descs, tex_ids)
    if lights is None:
        lights = default_scene_lights(lo.min(axis=0), hi.max(axis=0))
    return make_traced_scene(
        geom, bvh, mats, lights, textures, backend=backend
    )
