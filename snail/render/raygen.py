"""Primary-ray generation and tile (un)packing.

Rebuild of the reference's ``RayGenerator`` (src/ray_generator.h:25-70,
src/ray_generator.cpp:4-50): pixel (x, y) maps to the unnormalized direction

    right * ((x - w/2) * ratio / w) + up * ((y - h/2) / h) + front * planeDist

(the ctor folds ratio into invW so both axes effectively scale by 1/h,
ray_generator.cpp:5-13), then normalized with rsqrt (cpp:41-44).

The reference emits rays in a recursive Z/Morton order inside 8x8-pixel
packets so each ``RayGroup`` is spatially coherent, and un-swizzles with SSE
shuffles afterwards (``Decompose``, cpp:83-150). Here the packet is a
**tile**: we reshape the image into (tiles, TILE_H*TILE_W) ray blocks, so
consecutive rays are neighbouring pixels — the coherence the Z-curve bought
the SSE tracer — and :func:`untile_image` is the Decompose analogue (a
reshape/transpose, free under XLA).

Convention: pixel centers at +0.5, y=0 is the top row and maps to +up
(the image is y-flipped at save time if needed to match references).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.types import Camera, Rays
from ..core.vecmath import BIG

# Tile shape: 16x16 = 256 rays per packet. The reference packet is 8x8x(4)
# = 256 rays too (QuadLevels=3, render.cpp:273), chosen there for SSE
# quads + L1. Here a 32-thread warp of the traversal kernel gets two
# 16-pixel rows of one tile, so its rays walk nearly the same nodes and
# diverge little; the integrator's mip footprints also read the tiling.
TILE_W = 16
TILE_H = 16


def primary_rays(camera: Camera, width: int, height: int, jitter=None):
    """Full-image primary rays.

    Returns origin [3] (shared, reference RayGroup<1,0>) and dirs
    [height, width, 3], normalized.
    """
    x = (jnp.arange(width, dtype=jnp.float32) + 0.5 - width * 0.5) / height
    y = (height * 0.5 - (jnp.arange(height, dtype=jnp.float32) + 0.5)) / height
    if jitter is not None:
        jx, jy = jitter
        x = x + jx / height
        y = y - jy / height
    d = (
        camera.right * x[None, :, None]
        + camera.up * y[:, None, None]
        + camera.front * camera.plane_dist
    )
    d = d * jax.lax.rsqrt(jnp.sum(d * d, axis=-1, keepdims=True))
    return camera.pos, d


def tile_rays(dirs: jnp.ndarray, tile_h: int = TILE_H, tile_w: int = TILE_W):
    """[H, W, 3] -> [P, tile_h*tile_w, 3] tile blocks (the packet layout)."""
    h, w = dirs.shape[:2]
    assert h % tile_h == 0 and w % tile_w == 0, (h, w)
    d = dirs.reshape(h // tile_h, tile_h, w // tile_w, tile_w, 3)
    d = d.transpose(0, 2, 1, 3, 4)
    return d.reshape(-1, tile_h * tile_w, 3)


def untile_image(tiles: jnp.ndarray, height: int, width: int,
                 tile_h: int = TILE_H, tile_w: int = TILE_W):
    """[P, tile_h*tile_w, C] (or [P, N]) -> [H, W, C] — the Decompose
    analogue (ray_generator.cpp:83-150)."""
    c_shape = tiles.shape[2:] if tiles.ndim > 2 else ()
    t = tiles.reshape(
        height // tile_h, width // tile_w, tile_h, tile_w, *c_shape
    )
    t = t.transpose(0, 2, 1, 3, *range(4, 4 + len(c_shape)))
    return t.reshape(height, width, *c_shape)


def camera_rays_wavefront(camera: Camera, width: int, height: int,
                          jitter=None) -> Rays:
    """Primary rays as a flat tiled wavefront [P*256] with shared origin
    broadcast (the RayGroup<1,0> shape, ray_group.h:74-110)."""
    origin, dirs = primary_rays(camera, width, height, jitter)
    d = tile_rays(dirs).reshape(-1, 3)
    o = jnp.broadcast_to(origin, d.shape)
    return Rays(origin=o, dir=d, tmax=jnp.full(d.shape[:1], BIG, jnp.float32))
