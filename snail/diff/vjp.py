"""Differentiable traversal.

No reference counterpart — this is the BASELINE.json north star ("vertex,
material, camera and light gradients flow via a custom VJP through traversal
and intersection"). Design (SURVEY.md §7 S4, hard part (c)):

- The *discrete* output of traversal (which triangle was hit) is
  piecewise-constant: gradients treat topology as fixed, so the whole
  traversal kernel runs under ``stop_gradient``.
- The *continuous* outputs (distance, barycentrics) are then **recomputed
  in the forward pass** as a closed-form function of (ray, triangle
  vertices) given the hit id (``intersect_dist_bary``) — one gather + ~40
  flops per ray — and ordinary autodiff through that recompute yields the
  exact VJP *and* JVP. No traversal tape, no custom_vjp plumbing: the
  recompute IS the differentiable surrogate, and it equals the kernel's
  values bit-for-bit in exact arithmetic (same formula).

This composes with every traversal backend (the CUDA kernel on a GPU, the
jnp reference elsewhere) because traversal only ever runs
non-differentiably.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.vecmath import BIG
from ..ops import dispatch as ops_dispatch
from ..ops.intersect import intersect_dist_bary


def diff_closest_hit(scene, orig, dirn, tmax):
    """Closest hit with gradients flowing to scene.tri_* and the ray.

    Drop-in for ops.dispatch.closest_hit inside differentiable integrators:
    returns (dist, tri, bary) where dist/bary carry gradients and tri is
    discrete.
    """
    sg = jax.lax.stop_gradient
    dist0, tri, bary0 = ops_dispatch.closest_hit(
        sg(scene), sg(orig), sg(dirn), sg(tmax)
    )
    tri = sg(tri)
    hit = (dist0 > 0.0) & (dist0 < BIG)
    safe_tri = jnp.where(hit, tri, 0)

    d, u, v = intersect_dist_bary(
        orig, dirn, scene.tri_a, scene.tri_ba, scene.tri_ca, safe_tri
    )
    dist = jnp.where(hit, d, sg(dist0))
    bary = jnp.where(
        hit[..., None], jnp.stack([u, v], axis=-1), sg(bary0)
    )
    return dist, tri, bary


def render_loss_and_grads(render_fn, params, loss_fn):
    """Utility: value+grad of ``loss_fn(render_fn(params))`` w.r.t. a pytree
    of scene parameters (vertices/materials/lights/camera)."""

    def wrapped(params):
        return loss_fn(render_fn(params))

    return jax.value_and_grad(wrapped)(params)
