"""Pure-JAX BVH traversal (oracle / portable fallback).

A vectorized per-ray stack traversal expressed with ``lax.while_loop`` and
gathers — the jnp rendition of the reference's stack traversal
(src/bvh/traverse.cpp:14-80 primary, 82-149 shadow):

- ordered descent via the precomputed near-child bit XOR the ray's direction
  sign on the split axis (traverse.cpp:71-74);
- per-node slab test against the ray's current best distance (the role of
  BBox::Test, src/bounding_box.cpp:62-142 — here per-ray, not
  packet-narrowed: compaction replaces the [firstActive,lastActive] trick);
- leaf loops over a contiguous triangle range (the builder reorders
  triangles, so ``child[node] + k`` indexes the permuted arrays);
- shadow variant is any-hit with the reference's single-sided rule and stops
  a ray as soon as it is blocked (traverse.cpp:117-121).

Every ray keeps its own stack (R, MAX_DEPTH+2) so the whole wavefront steps
in lockstep; rays that finish idle until all are done. This is the
correctness oracle for the CUDA kernel (native/traverse.cu), the executable
spec for tests, and the traversal everywhere but on a CUDA GPU.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.vecmath import BIG
from .intersect import _raw_uvdet

STACK_CAP = 66  # maxDepth + 2 (reference bvh/traverse.cpp:17)


@partial(jax.jit, static_argnames=("leaf_max",))
def traverse_bvh_ref(
    node_lo,
    node_hi,
    child,
    count,
    axis,
    first_node,
    a,
    ba,
    ca,
    orig,
    dirn,
    tmax,
    leaf_max: int = 8,
):
    """Closest-hit traversal.

    node_*: [N, ...] flat BVH arrays; a/ba/ca: [T, 3] permuted triangles;
    orig/dirn: [R, 3]; tmax: [R] (negative = masked ray, reference sentinel).
    Returns (dist [R], tri [R] int32, bary [R, 2]).
    """
    r = orig.shape[0]
    ridx = jnp.arange(r)
    idir = 1.0 / (dirn + 1e-8)  # SafeInv (rtbase.h:117-120)

    active0 = tmax >= 0.0
    stack = jnp.zeros((r, STACK_CAP), jnp.int32)
    ptr = jnp.where(active0, 1, 0).astype(jnp.int32)  # root pre-pushed
    best = jnp.where(active0, jnp.minimum(tmax, BIG), -BIG)
    tri = jnp.zeros(r, jnp.int32)
    bu = jnp.zeros(r, jnp.float32)
    bv = jnp.zeros(r, jnp.float32)

    def cond(state):
        ptr = state[0]
        return jnp.any(ptr > 0)

    def body(state):
        ptr, stack, best, tri, bu, bv = state
        act = ptr > 0
        node = stack[ridx, jnp.maximum(ptr - 1, 0)]
        node = jnp.where(act, node, 0)
        ptr = jnp.where(act, ptr - 1, ptr)

        lo = jnp.take(node_lo, node, axis=0)
        hi = jnp.take(node_hi, node, axis=0)
        t1 = (lo - orig) * idir
        t2 = (hi - orig) * idir
        tnear = jnp.max(jnp.minimum(t1, t2), axis=-1)
        tfar = jnp.min(jnp.maximum(t1, t2), axis=-1)
        hit_node = act & (tnear <= tfar) & (tfar > 0.0) & (tnear < best)

        cnt = jnp.take(count, node)
        is_leaf = cnt > 0
        cfirst = jnp.take(child, node)

        # --- leaf: masked loop over up to leaf_max contiguous triangles ---
        def leaf_body(k, carry):
            best, tri, bu, bv = carry
            valid = hit_node & is_leaf & (k < cnt)
            tid = jnp.clip(cfirst + k, 0, a.shape[0] - 1)
            ta = jnp.take(a, tid, axis=0)
            tba = jnp.take(ba, tid, axis=0)
            tca = jnp.take(ca, tid, axis=0)
            nrm = jnp.cross(tba, tca)
            tvec = orig - ta
            det = jnp.sum(dirn * nrm, axis=-1)
            u = jnp.sum(dirn * jnp.cross(tvec, tca), axis=-1)
            v = jnp.sum(dirn * jnp.cross(tba, tvec), axis=-1)
            duv = det - u - v
            side = (jnp.maximum(u, jnp.maximum(v, duv)) <= 0.0) | (
                jnp.minimum(u, jnp.minimum(v, duv)) >= 0.0
            )
            idet = 1.0 / jnp.where(det == 0.0, 1e-30, det)
            dist = -jnp.sum(tvec * nrm, axis=-1) * idet
            upd = valid & side & (det != 0.0) & (dist > 0.0) & (dist < best)
            best = jnp.where(upd, dist, best)
            tri = jnp.where(upd, tid, tri)
            bu = jnp.where(upd, u * idet, bu)
            bv = jnp.where(upd, v * idet, bv)
            return best, tri, bu, bv

        best, tri, bu, bv = jax.lax.fori_loop(
            0, leaf_max, leaf_body, (best, tri, bu, bv)
        )

        # --- inner: push far then near (near pops first) ---
        push = hit_node & ~is_leaf
        ax = jnp.take(axis, node)
        sign = (
            jnp.take_along_axis(dirn, ax[:, None], axis=-1)[:, 0] < 0.0
        ).astype(jnp.int32)
        fn = jnp.take(first_node, node) ^ sign
        near = cfirst + fn
        far = cfirst + (1 - fn)
        p0 = jnp.minimum(ptr, STACK_CAP - 2)
        stack = stack.at[ridx, p0].set(jnp.where(push, far, stack[ridx, p0]))
        stack = stack.at[ridx, p0 + 1].set(
            jnp.where(push, near, stack[ridx, p0 + 1])
        )
        ptr = jnp.where(push, p0 + 2, ptr)
        return ptr, stack, best, tri, bu, bv

    ptr, stack, best, tri, bu, bv = jax.lax.while_loop(
        cond, body, (ptr, stack, best, tri, bu, bv)
    )
    # Misses report BIG (reference reports maxDist = inf, scene_inl.h:183);
    # masked rays report the negative sentinel.
    init_best = jnp.minimum(tmax, BIG)
    best = jnp.where(best < init_best, best, BIG)
    best = jnp.where(active0, best, -BIG)
    return best, tri, jnp.stack([bu, bv], axis=-1)


@partial(jax.jit, static_argnames=("leaf_max",))
def traverse_bvh_shadow_ref(
    node_lo,
    node_hi,
    child,
    count,
    axis,
    first_node,
    a,
    ba,
    ca,
    orig,
    dirn,
    tmax,
    leaf_max: int = 8,
):
    """Any-hit traversal with the single-sided shadow rule
    (triangle.cpp:88-103). Returns blocked [R] bool. ``tmax < 0`` marks
    masked rays (never blocked)."""
    r = orig.shape[0]
    ridx = jnp.arange(r)
    idir = 1.0 / (dirn + 1e-8)

    active0 = tmax >= 0.0
    stack = jnp.zeros((r, STACK_CAP), jnp.int32)
    ptr = jnp.where(active0, 1, 0).astype(jnp.int32)
    blocked = jnp.zeros(r, bool)

    def cond(state):
        return jnp.any(state[0] > 0)

    def body(state):
        ptr, stack, blocked = state
        act = (ptr > 0) & ~blocked
        ptr = jnp.where(blocked, 0, ptr)  # early-out per ray
        node = stack[ridx, jnp.maximum(ptr - 1, 0)]
        node = jnp.where(act, node, 0)
        ptr = jnp.where(act, ptr - 1, ptr)

        lo = jnp.take(node_lo, node, axis=0)
        hi = jnp.take(node_hi, node, axis=0)
        t1 = (lo - orig) * idir
        t2 = (hi - orig) * idir
        tnear = jnp.max(jnp.minimum(t1, t2), axis=-1)
        tfar = jnp.min(jnp.maximum(t1, t2), axis=-1)
        hit_node = act & (tnear <= tfar) & (tfar > 0.0) & (tnear < tmax)

        cnt = jnp.take(count, node)
        is_leaf = cnt > 0
        cfirst = jnp.take(child, node)

        def leaf_body(k, blocked):
            valid = hit_node & is_leaf & (k < cnt)
            tid = jnp.clip(cfirst + k, 0, a.shape[0] - 1)
            ta = jnp.take(a, tid, axis=0)
            tba = jnp.take(ba, tid, axis=0)
            tca = jnp.take(ca, tid, axis=0)
            nrm = jnp.cross(tba, tca)
            tvec = orig - ta
            det = jnp.sum(dirn * nrm, axis=-1)
            u = jnp.sum(dirn * jnp.cross(tvec, tca), axis=-1)
            v = jnp.sum(dirn * jnp.cross(tba, tvec), axis=-1)
            tmul = -jnp.sum(tvec * nrm, axis=-1)
            occ = (
                (jnp.minimum(u, v) >= 0.0)
                & (u + v <= det)
                & (tmul > 0.0)
                & (tmul < tmax * det)
            )
            return blocked | (valid & occ)

        blocked = jax.lax.fori_loop(0, leaf_max, leaf_body, blocked)

        push = hit_node & ~is_leaf
        ax = jnp.take(axis, node)
        sign = (
            jnp.take_along_axis(dirn, ax[:, None], axis=-1)[:, 0] < 0.0
        ).astype(jnp.int32)
        fn = jnp.take(first_node, node) ^ sign
        near = cfirst + fn
        far = cfirst + (1 - fn)
        p0 = jnp.minimum(ptr, STACK_CAP - 2)
        stack = stack.at[ridx, p0].set(jnp.where(push, far, stack[ridx, p0]))
        stack = stack.at[ridx, p0 + 1].set(
            jnp.where(push, near, stack[ridx, p0 + 1])
        )
        ptr = jnp.where(push, p0 + 2, ptr)
        return ptr, stack, blocked

    ptr, stack, blocked = jax.lax.while_loop(cond, body, (ptr, stack, blocked))
    return blocked
