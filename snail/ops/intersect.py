"""Ray-triangle intersection in pure jnp.

The math is the reference's precomputed-edge Möller variant over edges
``ba = p1-p0``, ``ca = p2-p0`` (src/triangle.cpp:4-63 packet Collide):

    nrm  = cross(ba, ca)            (unnormalized; reference keeps the unit
                                     normal + t0, we fold t0 in)
    det  = dir . nrm
    tvec = orig - a
    u    = dir . cross(tvec, ca)    (weight of vertex 1; stored as bar.x,
                                     triangle.cpp:28, 60)
    v    = dir . cross(ba, tvec)    (weight of vertex 2; bar.y)
    dist = -(tvec . nrm) / det

Primary rays are **double-sided**: a hit requires u, v and det-u-v to share
one sign (``uvmax <= 0 || uvmin >= 0``, triangle.cpp:47-51) plus
``0 < dist < best`` (triangle.cpp:57).

Shadow rays are **single-sided** from the light: ``min(u,v) >= 0 &&
u + v <= det && tmul > 0 && tmul < dist*det`` (triangle.cpp:95-96).

These functions are the *oracle* path (tests, small scenes, autodiff
recompute); the traversal kernel (native/traverse.cu) is the fast path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.vecmath import BIG


def _raw_uvdet(orig, dirn, a, ba, ca):
    nrm = jnp.cross(ba, ca)  # [T, 3]
    o = orig[..., None, :]  # [..., 1, 3]
    d = dirn[..., None, :]
    tvec = o - a  # [..., T, 3]
    det = jnp.sum(d * nrm, axis=-1)  # [..., T]
    u = jnp.sum(d * jnp.cross(tvec, ca), axis=-1)
    v = jnp.sum(d * jnp.cross(ba, tvec), axis=-1)
    tmul = -jnp.sum(tvec * nrm, axis=-1)
    return det, u, v, tmul


def intersect_tris(orig, dirn, a, ba, ca, tmax=None):
    """Dense double-sided intersection (the primary-ray rule).

    orig, dirn: float32[..., 3]; a, ba, ca: float32[T, 3].
    Returns (dist[..., T], u[..., T], v[..., T], hit[..., T]); u, v are the
    det-normalized barycentric weights of vertices 1 and 2.
    """
    det, u, v, tmul = _raw_uvdet(orig, dirn, a, ba, ca)
    duv = det - u - v
    uvmin = jnp.minimum(u, jnp.minimum(v, duv))
    uvmax = jnp.maximum(u, jnp.maximum(v, duv))
    side = (uvmax <= 0.0) | (uvmin >= 0.0)
    safe_det = jnp.where(det == 0.0, 1e-30, det)
    idet = 1.0 / safe_det
    dist = tmul * idet
    hit = side & (dist > 0.0) & (det != 0.0)
    if tmax is not None:
        hit = hit & (dist < tmax[..., None])
    return jnp.where(hit, dist, BIG), u * idet, v * idet, hit


def intersect_brute_force(orig, dirn, a, ba, ca, tmax=None):
    """Closest hit over all triangles: the ground-truth oracle
    (the per-leaf loop of bvh/traverse.cpp:45-53, minus the BVH).
    Returns (dist, tri_id, bary[..., 2]); dist == BIG means miss."""
    dist, u, v, hit = intersect_tris(orig, dirn, a, ba, ca, tmax)
    tri = jnp.argmin(dist, axis=-1)
    best = jnp.min(dist, axis=-1)
    bu = jnp.take_along_axis(u, tri[..., None], axis=-1)[..., 0]
    bv = jnp.take_along_axis(v, tri[..., None], axis=-1)[..., 0]
    bary = jnp.stack([bu, bv], axis=-1)
    return best, tri.astype(jnp.int32), bary


def intersect_any_brute_force(orig, dirn, a, ba, ca, tmax):
    """Any-hit occlusion oracle with the reference's *single-sided* shadow
    rule (triangle.cpp:88-103): rays go from the light toward the surface.
    Returns True where blocked before tmax."""
    det, u, v, tmul = _raw_uvdet(orig, dirn, a, ba, ca)
    blocked = (
        (jnp.minimum(u, v) >= 0.0)
        & (u + v <= det)
        & (tmul > 0.0)
        & (tmul < tmax[..., None] * det)
    )
    return jnp.any(blocked, axis=-1)


def intersect_dist_bary(orig, dirn, a, ba, ca, tri_id):
    """Differentiable recompute of (dist, u, v) for a *known* triangle id.

    The backward-pass workhorse: traversal finds tri_id
    (non-differentiable), then distance/barycentrics are recomputed as a
    pure function of (ray, vertices) so gradients flow to both
    (SURVEY.md hard part (c); no reference counterpart)."""
    ta = jnp.take(a, tri_id, axis=0)
    tba = jnp.take(ba, tri_id, axis=0)
    tca = jnp.take(ca, tri_id, axis=0)
    nrm = jnp.cross(tba, tca)
    tvec = orig - ta
    det = jnp.sum(dirn * nrm, axis=-1)
    safe_det = jnp.where(det == 0.0, 1e-30, det)
    u = jnp.sum(dirn * jnp.cross(tvec, tca), axis=-1) / safe_det
    v = jnp.sum(dirn * jnp.cross(tba, tvec), axis=-1) / safe_det
    dist = -jnp.sum(tvec * nrm, axis=-1) / safe_det
    return dist, u, v
