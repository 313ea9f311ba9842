"""Min/max-brick volume traversal — the wavefront rebuild of the reference's
``VTree`` (src/vtree.h:7-45, src/vtree.cpp).

The reference builds a min/max kd-tree over 4^3 bricks of u16 data and
ray-marches scalar rays with empty-space skipping. A per-ray kd descent
is divergent, so the data-parallel shape of the same idea is a dense
**min/max brick pyramid** (level 0 = 4^3 bricks, level 1 = 16^3) sampled
inside a vectorized ``lax.while_loop`` march: every step, each ray looks
up the brick max at its position and either skips a whole brick (empty
space) or takes fine voxel steps (occupied) — same skip structure, data-
parallel control flow.

Render modes mirror the viewer (dicom_viewer.cpp + vrender_opengl.cpp):
- ``iso``: first crossing of a density threshold, gradient normal,
  headlight N.L shade
- ``mip``: maximum-intensity projection
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .data import VolumeData

BRICK = 4  # reference brick size (vtree.h)


@dataclasses.dataclass
class VTree:
    vol: jnp.ndarray       # [D, H, W] f32 normalized density
    brick_max: jnp.ndarray  # [D/4, H/4, W/4] f32
    brick_min: jnp.ndarray
    coarse_max: jnp.ndarray  # [D/16, H/16, W/16] f32
    shape: Tuple[int, int, int]

    def tree_flat(self):
        return (self.vol, self.brick_max, self.brick_min, self.coarse_max)


def _pool_minmax(a: np.ndarray, k: int):
    d, h, w = a.shape
    pd, ph, pw = (-d) % k, (-h) % k, (-w) % k
    amax = np.pad(a, ((0, pd), (0, ph), (0, pw)), constant_values=0)
    amin = np.pad(a, ((0, pd), (0, ph), (0, pw)), constant_values=1e9)
    r = amax.reshape(amax.shape[0] // k, k, amax.shape[1] // k, k,
                     amax.shape[2] // k, k)
    rmin = amin.reshape(r.shape)
    return r.max(axis=(1, 3, 5)), rmin.min(axis=(1, 3, 5))


def build_vtree(vd: VolumeData) -> VTree:
    """Min/max pyramid build (the VTree construction, vtree.cpp)."""
    vol = vd.data.astype(np.float32) / 65535.0
    bmax, bmin = _pool_minmax(vol, BRICK)
    cmax, _ = _pool_minmax(bmax, BRICK)
    return VTree(
        vol=jnp.asarray(vol),
        brick_max=jnp.asarray(bmax),
        brick_min=jnp.asarray(bmin),
        coarse_max=jnp.asarray(cmax),
        shape=vol.shape,
    )


def _sample(vol, p, shape):
    """Trilinear density sample at voxel-space position p [R, 3] (zyx)."""
    d, h, w = shape
    q = p - 0.5
    q0 = jnp.floor(q)
    f = q - q0
    q0 = q0.astype(jnp.int32)

    def fetch(oz, oy, ox):
        iz = jnp.clip(q0[:, 0] + oz, 0, d - 1)
        iy = jnp.clip(q0[:, 1] + oy, 0, h - 1)
        ix = jnp.clip(q0[:, 2] + ox, 0, w - 1)
        return vol[iz, iy, ix]

    fz, fy, fx = f[:, 0], f[:, 1], f[:, 2]
    c00 = fetch(0, 0, 0) * (1 - fx) + fetch(0, 0, 1) * fx
    c01 = fetch(0, 1, 0) * (1 - fx) + fetch(0, 1, 1) * fx
    c10 = fetch(1, 0, 0) * (1 - fx) + fetch(1, 0, 1) * fx
    c11 = fetch(1, 1, 0) * (1 - fx) + fetch(1, 1, 1) * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def _cell_lookup(table, p, shape, cell):
    d, h, w = shape
    iz = jnp.clip((p[:, 0] / cell).astype(jnp.int32), 0, (d + cell - 1) // cell - 1)
    iy = jnp.clip((p[:, 1] / cell).astype(jnp.int32), 0, (h + cell - 1) // cell - 1)
    ix = jnp.clip((p[:, 2] / cell).astype(jnp.int32), 0, (w + cell - 1) // cell - 1)
    return table[iz, iy, ix]


def _exit_dist(p, dirn, cell):
    """Distance along dirn from p to the exit plane of its ``cell``-voxel
    grid cell, plus an epsilon so the next step lands inside the neighbor
    (the reference computes exact per-node t intervals, vtree.cpp:147-181)."""
    ib = jnp.floor(p / cell)
    nxt = (ib + (dirn > 0.0)) * cell
    safe = jnp.where(jnp.abs(dirn) < 1e-9,
                     jnp.where(dirn >= 0, 1e-9, -1e-9), dirn)
    tax = jnp.where(jnp.abs(dirn) < 1e-9, 1e30, (nxt - p) / safe)
    return jnp.maximum(tax.min(axis=1), 0.0) + 1e-2


@partial(jax.jit, static_argnames=("shape", "mode", "max_steps"))
def _march(vol, brick_max, brick_min, coarse_max, o, dirn, t0, t1, iso,
           shape, mode: str, max_steps: int):
    """Vectorized march with two-level empty-space skipping. o/dirn in
    voxel space [R,3] (zyx); t in voxel units.

    Skips step to the EXACT exit plane of the current (coarse or fine)
    brick, so no sample position is ever jumped over (reference
    VTree::Trace computes per-node t intervals, vtree.cpp:147-181):
    - coarse level (16^3 voxels): skipped when ``coarse_max`` can't beat
      the threshold/current best;
    - brick level (4^3): same with ``brick_max``;
    - iso early-accept: a brick with ``brick_min >= iso`` is entirely
      above the threshold, so the crossing is at the current position
      without needing the trilinear sample.
    """
    fine = 0.5
    coarse_cell = BRICK * BRICK

    def cond(c):
        t, done, _, _, k = c
        return jnp.any(~done) & (k < max_steps)

    def body(c):
        t, done, best, hit_t, k = c
        p = o + dirn * t[:, None]
        bmax = _cell_lookup(brick_max, p, shape, BRICK)
        cmax = _cell_lookup(coarse_max, p, shape, coarse_cell)
        brick_exit = _exit_dist(p, dirn, BRICK)
        coarse_exit = _exit_dist(p, dirn, coarse_cell)
        if mode == "iso":
            bmin = _cell_lookup(brick_min, p, shape, BRICK)
            occupied = bmax >= iso
            rho = jnp.where(occupied, _sample(vol, p, shape), 0.0)
            newly = (~done) & occupied & ((rho >= iso) | (bmin >= iso))
            hit_t = jnp.where(newly & (hit_t < 0), t, hit_t)
            done = done | newly
            step = jnp.where(
                occupied, fine,
                jnp.where(cmax < iso, coarse_exit, brick_exit),
            )
        else:  # mip
            worth = bmax > best
            rho = jnp.where(worth, _sample(vol, p, shape), 0.0)
            best = jnp.maximum(best, rho)
            step = jnp.where(
                worth, fine,
                jnp.where(cmax <= best, coarse_exit, brick_exit),
            )
        t = jnp.where(done, t, t + step)
        done = done | (t >= t1)
        return t, done, best, hit_t, k + 1

    r = o.shape[0]
    init = (jnp.maximum(t0, 0.0), t0 > t1, jnp.zeros(r),
            jnp.full(r, -1.0), jnp.int32(0))
    t, done, best, hit_t, _ = jax.lax.while_loop(cond, body, init)
    return best, hit_t


def _entry_exit(o, dirn, shape):
    """Ray/box clip against the volume bounds (voxel space)."""
    hi = jnp.asarray(shape, jnp.float32)
    idir = 1.0 / jnp.where(jnp.abs(dirn) < 1e-9, 1e-9, dirn)
    ta = (0.0 - o) * idir
    tb = (hi[None] - o) * idir
    tn = jnp.minimum(ta, tb).max(axis=1)
    tf = jnp.maximum(ta, tb).min(axis=1)
    return jnp.maximum(tn, 0.0), tf


def render_volume(vt: VTree, camera, width: int, height: int,
                  iso: float = 0.05, mode: str = "iso",
                  max_steps: int = 2048):
    """Render the volume with the given camera (world = voxel space,
    volume spanning [0, shape]). Returns [H, W, 3] float32."""
    from ..render.raygen import primary_rays

    origin, dirs = primary_rays(camera, width, height)
    d = dirs.reshape(-1, 3)
    o = jnp.broadcast_to(origin, d.shape)
    # camera xyz -> volume zyx
    o = o[:, ::-1]
    d = d[:, ::-1]
    t0, t1 = _entry_exit(o, d, vt.shape)
    best, hit_t = _march(vt.vol, vt.brick_max, vt.brick_min, vt.coarse_max,
                         o, d, t0, t1, iso, vt.shape, mode, max_steps)
    if mode == "mip":
        img = jnp.stack([best] * 3, axis=-1)
        return img.reshape(height, width, 3) * (1.0 / jnp.maximum(
            best.max(), 1e-6))
    hit = hit_t >= 0.0
    p = o + d * jnp.where(hit, hit_t, 0.0)[:, None]
    # gradient normal (central differences), headlight shade
    eps = 1.0
    def g(axis):
        dp = jnp.zeros((1, 3)).at[0, axis].set(eps)
        return _sample(vt.vol, p + dp, vt.shape) - _sample(
            vt.vol, p - dp, vt.shape)
    n = jnp.stack([g(0), g(1), g(2)], axis=-1)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
    ndl = jnp.abs(jnp.sum(n * d, axis=-1))
    shade = jnp.where(hit, 0.1 + 0.9 * ndl, 0.0)
    img = jnp.stack([shade, shade * 0.95, shade * 0.9], axis=-1)
    return img.reshape(height, width, 3)
