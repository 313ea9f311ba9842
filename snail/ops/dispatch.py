"""Traversal backend dispatch.

``closest_hit`` / ``any_hit`` / ``any_hit_from`` run the CUDA kernel
(:mod:`snail.ops.traverse_cuda`) when the program is lowered for a
CUDA GPU and the jnp reference traversal otherwise. The choice is made at
lowering (``lax.platform_dependent``), not from the default backend, so one
process can compile the same function for the GPU and for the CPU.
``TracedScene.backend == "reference"`` forces the reference everywhere (the
oracle that tests compare against). This is the seam the reference
implements with template instantiation over acceleration structures
(Scene<BVH> vs Scene<DBVH>) and, per node type, the SPU-vs-x86 split
(node.cpp:330-338).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import traverse_cuda
from .traverse_ref import traverse_bvh_ref, traverse_bvh_shadow_ref


def _ref_args(scene):
    return (scene.node_lo, scene.node_hi, scene.node_child,
            scene.node_count, scene.node_axis, scene.node_first,
            scene.tri_a, scene.tri_ba, scene.tri_ca)


def _closest_ref(scene, orig, dirn, tmax):
    return traverse_bvh_ref(*_ref_args(scene), orig, dirn, tmax,
                            leaf_max=scene.leaf_max)


def _any_ref(scene, orig, dirn, tmax):
    orig = jnp.broadcast_to(orig, dirn.shape)
    return traverse_bvh_shadow_ref(*_ref_args(scene), orig, dirn, tmax,
                                   leaf_max=scene.leaf_max)


def _route(scene, kernel, ref, orig, dirn, tmax):
    if scene.backend == "reference":
        return ref(scene, orig, dirn, tmax)
    return jax.lax.platform_dependent(scene, orig, dirn, tmax,
                                      cuda=kernel, default=ref)


def closest_hit(scene, orig, dirn, tmax):
    """(dist, tri, bary[...,2]); dist==BIG miss, dist<0 masked ray."""
    return _route(scene, traverse_cuda.closest_hit, _closest_ref,
                  orig, dirn, tmax)


def any_hit_from(scene, origin, dirn, tmax):
    """Shared-origin any-hit: all rays start at ``origin`` [3] (shadow rays
    are traced FROM the light, scene_inl.h:127-129). blocked [R] bool.

    Occlusion is boolean — no gradient flows through it — so inputs are
    stop_gradient'ed here, which also lets this run under jax.grad (the
    kernel has no AD rule)."""
    sg = jax.lax.stop_gradient
    return _route(sg(scene), traverse_cuda.any_hit, _any_ref,
                  sg(origin), sg(dirn), sg(tmax))


def any_hit(scene, orig, dirn, tmax):
    """blocked [R] bool; tmax<0 masked (never blocked). Inputs are
    stop_gradient'ed (boolean output; see any_hit_from)."""
    sg = jax.lax.stop_gradient
    return _route(sg(scene), traverse_cuda.any_hit, _any_ref,
                  sg(orig), sg(dirn), sg(tmax))
