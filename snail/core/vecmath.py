"""Vector math primitives on ``jnp`` arrays.

This module is the rebuild's analogue of the reference's veclib SIMD wrapper
(reference veclib/veclib.h:98-193) and base math helpers (src/rtbase.h).
The mapping is deliberate and total:

- ``f32x4`` / ``Vec3q`` SoA quads        -> plain jnp arrays with a trailing
  (or leading) component axis; XLA vectorizes across the wavefront the way
  SSE vectorized across the 4-wide quad.
- ``f32x4b`` masks + ``Condition(m,a,b)`` -> bool arrays + ``jnp.where``.
- ``ForAll/ForAny/ForWhich/SignMask``     -> ``jnp.all/jnp.any`` and bool
  arrays directly.
- ``SafeInv`` (src/rtbase.h:117-127)      -> :func:`safe_inv` (same biased
  reciprocal so renders match the reference numerically).

All functions treat the last axis as the xyz component axis and broadcast
over any leading axes, so they work for single vectors, ray wavefronts, and
whole images alike.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Large-but-finite stand-in for +inf where inf would poison arithmetic
# (0 * inf = nan). The reference freely uses real infinities because its
# control flow branches around them; in branchless jnp code a finite BIG
# is safer for masked lanes.
# A Python float (not a jnp array) so kernels can close over it.
BIG = 3.4e37


def dot(a, b):
    """Component dot product over the last axis (veclib operator| )."""
    return jnp.sum(a * b, axis=-1)


def vdot(a, b):
    """Dot product keeping the reduced axis (for broadcasting chains)."""
    return jnp.sum(a * b, axis=-1, keepdims=True)


def cross(a, b):
    """3D cross product over the last axis (veclib operator^ )."""
    return jnp.cross(a, b)


def length(v):
    return jnp.sqrt(dot(v, v))


def normalize(v):
    """v * rsqrt(v|v) — matches the reference's ray normalization
    (src/ray_generator.cpp:41-44)."""
    return v * jax.lax.rsqrt(jnp.sum(v * v, axis=-1, keepdims=True))


def safe_inv(v):
    """Reciprocal that never divides by zero.

    Matches the quad-path ``SafeInv`` actually used by the reference for ray
    inverse directions: ``VInv(v + 1e-8)`` (src/rtbase.h:117-120). The bias
    keeps axis-aligned rays finite while perturbing real components by well
    under float epsilon for typical magnitudes.
    """
    return 1.0 / (v + jnp.float32(1e-8))


def reflect(d, n):
    """Mirror direction ``d`` about normal ``n`` (veclib Reflect as used in
    src/scene_inl.h:505)."""
    return d - 2.0 * vdot(d, n) * n


def refract(d, n, eta):
    """Snell refraction of unit direction ``d`` through unit normal ``n``
    with relative IOR ``eta``; falls back to total internal reflection.

    The reference declares ``fRefraction`` (src/shading/material.h:15) but
    never traces refraction rays (transparency rays continue straight,
    src/scene_inl.h:515-529); we provide the real optics as an extension.
    """
    cos_i = -vdot(d, n)
    sin2_t = eta * eta * (1.0 - cos_i * cos_i)
    tir = sin2_t > 1.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 0.0))
    refr = eta * d + (eta * cos_i - cos_t) * n
    return jnp.where(tir, reflect(d, n), refr)
