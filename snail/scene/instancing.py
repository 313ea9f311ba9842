"""Two-level instancing — the rebuild of the reference's DBVH
(reference src/dbvh/tree.h:7-252, src/dbvh/traverse.cpp:14-76).

The reference wraps a base ``BVH`` in ``ObjectInstance`` (rotation matrix +
translation + cached world-space bbox, dbvh/tree.h:7-187), builds a small
median-split BVH over the instances each frame (dbvh/tree.cpp, rebuilt per
frame for animation: node.cpp:326-328, rtracer.cpp:357-364), and during
traversal transforms the ray packet into object space (``ITransformVec`` /
``ITransformPoint``, dbvh/tree.h:34-46), re-derives idir, and recurses into
the base BVH.

Shape here: instance counts are tiny (tens) while wavefronts are huge, so
instead of a per-ray walk over a 2nd tree, the instance level runs at the
XLA layer - one fused transform + base traversal per instance,
threading the running closest-hit through as ``tmax`` so later instances are
distance-culled exactly like the reference's ordered DBVH refinement. The
rotation is orthonormal (rigid), so object-space hit distances ARE
world-space distances and no re-scaling is needed; normals rotate back by R.

Instance world bboxes are cached at construction from the 8 transformed
corners of the base root bbox (the reference caches ``bbox`` the same way).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import static_field
from ..core.vecmath import BIG


def _register(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    data = [f.name for f in dataclasses.fields(cls) if not f.metadata.get("static")]
    meta = [f.name for f in dataclasses.fields(cls) if f.metadata.get("static")]
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    return cls


def rotation_y(angle) -> jnp.ndarray:
    """Y-axis rotation matrix (the reference animates instances this way,
    rtracer.cpp:359-364)."""
    c, s = jnp.cos(angle), jnp.sin(angle)
    z, o = jnp.zeros_like(c), jnp.ones_like(c)
    return jnp.stack([
        jnp.stack([c, z, s], -1),
        jnp.stack([z, o, z], -1),
        jnp.stack([-s, z, c], -1),
    ], -2)


@_register
class InstancedScene:
    """A base TracedScene plus N rigid instances (rot [N,3,3], trans [N,3])."""

    rot: jnp.ndarray
    trans: jnp.ndarray
    inst_lo: jnp.ndarray  # cached world bboxes (dbvh ObjectInstance.bbox)
    inst_hi: jnp.ndarray
    base: object
    num_instances: int = static_field(default=0)

    @property
    def lights(self):
        return self.base.lights


def make_instances(base, rot, trans) -> InstancedScene:
    """Build the instance set + cached world bboxes (MakeDBVH analogue,
    rtracer.cpp:357-364; cheap enough to re-run every frame)."""
    rot = jnp.asarray(rot, jnp.float32)
    trans = jnp.asarray(trans, jnp.float32)
    n = rot.shape[0]
    lo, hi = base.bbox
    corners = jnp.stack(jnp.meshgrid(
        jnp.stack([lo[0], hi[0]]), jnp.stack([lo[1], hi[1]]),
        jnp.stack([lo[2], hi[2]]), indexing="ij"
    ), -1).reshape(-1, 3)  # (8, 3)
    # HIGHEST: a GPU would otherwise take this f32 product in TF32
    wc = jnp.einsum("nij,cj->nci", rot, corners,
                    precision=jax.lax.Precision.HIGHEST) + trans[:, None, :]
    return InstancedScene(
        rot=rot, trans=trans,
        inst_lo=wc.min(axis=1), inst_hi=wc.max(axis=1),
        base=base, num_instances=int(n),
    )


def _ray_hits_box(o3, d3, tmax, lo, hi):
    """Vectorized slab test of every ray against one world bbox — the
    per-packet instance cull the reference gets from its DBVH node tests
    (dbvh/traverse.cpp:14-76): only rays whose segment enters the
    instance's cached world bbox pay that instance's base traversal."""
    tn = jnp.zeros_like(tmax)
    tf = jnp.where(tmax >= 0.0, jnp.minimum(tmax, BIG), -BIG)
    for k in range(3):
        ic = 1.0 / (d3[k] + 1e-8)
        t1 = (lo[k] - o3[k]) * ic
        t2 = (hi[k] - o3[k]) * ic
        tn = jnp.maximum(tn, jnp.minimum(t1, t2))
        tf = jnp.minimum(tf, jnp.maximum(t1, t2))
    return (tn <= tf) & (tf > 0.0)


def _to_object(iscene, i, o3, d3):
    """World -> object space (ITransformVec/ITransformPoint,
    dbvh/tree.h:34-46): p' = R^T (p - t), v' = R^T v."""
    r = iscene.rot[i]
    t = iscene.trans[i]
    ox = o3[0] - t[0]
    oy = o3[1] - t[1]
    oz = o3[2] - t[2]
    oo = (r[0, 0] * ox + r[1, 0] * oy + r[2, 0] * oz,
          r[0, 1] * ox + r[1, 1] * oy + r[2, 1] * oz,
          r[0, 2] * ox + r[1, 2] * oy + r[2, 2] * oz)
    dx, dy, dz = d3
    dd = (r[0, 0] * dx + r[1, 0] * dy + r[2, 0] * dz,
          r[0, 1] * dx + r[1, 1] * dy + r[2, 1] * dz,
          r[0, 2] * dx + r[1, 2] * dy + r[2, 2] * dz)
    return oo, dd


def instanced_closest_hit(iscene: InstancedScene, o3, d3, tmax):
    """Closest hit over all instances (TraversePrimary0 over the DBVH,
    dbvh/traverse.cpp:14-76). Returns (dist, inst, tri, u, v).

    Instance i's traversal uses the best-so-far as its tmax, so geometry
    already occluded by earlier instances is distance-culled inside the
    base kernels (the DBVH's ordered-refinement effect)."""
    from ..ops import dispatch

    r = tmax.shape[0]
    best = jnp.where(tmax >= 0.0, jnp.minimum(tmax, BIG), -BIG)
    inst = jnp.full((r,), -1, jnp.int32)
    tri = jnp.zeros((r,), jnp.int32)
    bu = jnp.zeros((r,), jnp.float32)
    bv = jnp.zeros((r,), jnp.float32)

    for i in range(iscene.num_instances):
        # per-ray world-bbox cull, then skip the WHOLE base traversal
        # when no ray touches this instance (lax.cond executes one
        # branch): the frame cost grows with INTERSECTED instances, not
        # the instance count — the sub-linearity the reference's DBVH
        # gets from its tree over instances (dbvh/tree.h:189-252)
        touch = _ray_hits_box(o3, d3, best, iscene.inst_lo[i],
                              iscene.inst_hi[i])
        oo, dd = _to_object(iscene, i, o3, d3)
        orig = jnp.stack(oo, -1)
        dirn = jnp.stack(dd, -1)
        tm_i = jnp.where(touch, best, -BIG)

        def _trace(args):
            orig, dirn, tm_i = args
            return dispatch.closest_hit(iscene.base, orig, dirn, tm_i)

        def _skip(args):
            orig, dirn, tm_i = args
            r_ = tm_i.shape[0]
            return (jnp.full((r_,), -BIG, jnp.float32),
                    jnp.zeros((r_,), jnp.int32),
                    jnp.zeros((r_, 2), jnp.float32))

        d_i, t_i, b_i = jax.lax.cond(jnp.any(touch), _trace, _skip,
                                     (orig, dirn, tm_i))
        upd = (d_i > 0.0) & (d_i < best)
        best = jnp.where(upd, d_i, best)
        inst = jnp.where(upd, i, inst)
        tri = jnp.where(upd, t_i, tri)
        bu = jnp.where(upd, b_i[:, 0], bu)
        bv = jnp.where(upd, b_i[:, 1], bv)

    dist = jnp.where(inst >= 0, best, jnp.where(tmax >= 0.0, BIG, -BIG))
    return dist, inst, tri, bu, bv


def instanced_any_hit(iscene: InstancedScene, o3, d3, tmax):
    """Shadow any-hit over instances with cumulative early-out: rays
    already blocked get tmax < 0 for later instances (the full-occlusion
    return of dbvh shadow traversal)."""
    from ..ops import dispatch

    blocked = jnp.zeros(tmax.shape, bool)
    for i in range(iscene.num_instances):
        tm = jnp.where(blocked, -BIG, tmax)
        touch = _ray_hits_box(o3, d3, tm, iscene.inst_lo[i],
                              iscene.inst_hi[i])
        oo, dd = _to_object(iscene, i, o3, d3)
        orig = jnp.stack(oo, -1)
        dirn = jnp.stack(dd, -1)
        tm_i = jnp.where(touch, tm, -BIG)

        def _trace(args):
            return dispatch.any_hit(iscene.base, *args)

        def _skip(args):
            return jnp.zeros(args[2].shape, bool)

        blocked = blocked | jax.lax.cond(jnp.any(touch), _trace, _skip,
                                         (orig, dirn, tm_i))
    return blocked


def world_normal(iscene: InstancedScene, inst, n3):
    """Rotate an object-space normal back to world space per ray:
    n_w = R n_o (rigid transforms: inverse-transpose == R)."""
    safe = jnp.maximum(inst, 0)
    r = jnp.take(iscene.rot, safe, axis=0)  # (R, 3, 3)
    nx, ny, nz = n3
    return (
        r[:, 0, 0] * nx + r[:, 0, 1] * ny + r[:, 0, 2] * nz,
        r[:, 1, 0] * nx + r[:, 1, 1] * ny + r[:, 1, 2] * nz,
        r[:, 2, 0] * nx + r[:, 2, 1] * ny + r[:, 2, 2] * nz,
    )


def instance_tracer(iscene: InstancedScene):
    """The instance set as the integrator's visibility queries: primary,
    bounce and shadow rays all run over the DBVH, and the base scene's
    shading normals are rotated to world space (the reference feeds DBVH
    scenes into the same Scene::RayTrace, dbvh/traverse.cpp:14-76 +
    scene_inl.h:169-496)."""
    from ..render.integrator import Tracer

    def split(x):
        return (x[:, 0], x[:, 1], x[:, 2])

    def closest_hit(orig, dirn, tmax):
        dist, inst, tri, u, v = instanced_closest_hit(
            iscene, split(orig), split(dirn), tmax)

        def to_world(n):
            return jnp.stack(world_normal(iscene, inst, split(n)), -1)

        return dist, tri, jnp.stack([u, v], -1), to_world

    def any_hit_from(origin, dirn, tmax):
        o3 = tuple(jnp.broadcast_to(origin[k], tmax.shape)
                   for k in range(3))
        return instanced_any_hit(iscene, o3, split(dirn), tmax)

    return Tracer(closest_hit, any_hit_from)


def render_instanced(iscene: InstancedScene, camera, width: int, height: int,
                     opts=None):
    """Full-Whitted instanced frame (the rtracer instancing demo path,
    rtracer.cpp:357-386): primary + shadow + bounce rays over the DBVH,
    shaded by the same integrator as single-BVH scenes."""
    from ..core.types import RenderOpts
    from ..render.integrator import render_wavefront
    from ..render.raygen import (TILE_H, TILE_W, primary_rays, tile_rays,
                                 untile_image)

    opts = opts or RenderOpts()
    origin, dirs = primary_rays(camera, width, height)
    th = TILE_H if height % TILE_H == 0 else 1
    tw = TILE_W if width % TILE_W == 0 else 1
    d = tile_rays(dirs, th, tw).reshape(-1, 3)
    o = jnp.broadcast_to(origin, d.shape)
    tmax = jnp.full(d.shape[:1], BIG, jnp.float32)
    color = render_wavefront(iscene.base, o, d, tmax, opts,
                             tile_hw=(th, tw), tracer=instance_tracer(iscene))
    return untile_image(color.reshape(-1, th * tw, 3), height, width, th, tw)
