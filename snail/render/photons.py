"""Photon mapping (experimental, like the reference's) — the rebuild of
src/photons.{h,cpp}:

- ``trace_photons``  <- ``TracePhotons`` (photons.cpp:197-250): stratified
  sphere sampling from each light, batch intersection through the
  wavefront closest-hit (the ``BVH::WideTrace`` callsite photons.cpp:239
  maps to our ray-wavefront kernels — WideTrace IS the reference's
  wavefront-with-compaction design, SURVEY.md §2.4 P2), hit compaction.
- ``build_photon_kdtree`` <- ``MakePhotonTree`` median build
  (photons.cpp:15-66); kept host-side exactly like the reference.
- ``gather_photons_kd`` <- ``GatherPhotons`` (photons.cpp:68-195): range
  gather weighting by distance and normal agreement. Host/NumPy — this
  is the oracle.
- ``photon_grid`` / ``gather_photons_grid``: the vectorized radiance
  estimate. Per-query kd-walks are divergent (a poor fit for a lockstep
  wavefront), so photon powers are splatted into a dense power grid
  once per map and shading does ONE trilinear fetch per query — the
  whole gather becomes vectorized loads. Validated against the kd oracle.
- ``render_photon_preview`` <- the OGL photon point-cloud preview
  (render_opengl.h:20 DrawPhotons).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.vecmath import BIG
from ..ops import dispatch


# ---------------------------------------------------------------------------
# Photon tracing
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PhotonMap:
    pos: np.ndarray     # [P, 3] f32 hit positions
    power: np.ndarray   # [P, 3] f32 rgb power
    normal: np.ndarray  # [P, 3] f32 geometric normal at hit
    dirn: np.ndarray    # [P, 3] f32 incident direction

    @property
    def count(self) -> int:
        return len(self.pos)


def _stratified_sphere(n: int, key) -> jnp.ndarray:
    """Stratified directions over the sphere (the reference stratifies
    its photon directions per batch, photons.cpp:212-230)."""
    i = jnp.arange(n, dtype=jnp.float32)
    k1, k2 = jax.random.split(key)
    u = (i + jax.random.uniform(k1, (n,))) / n          # cos(theta) strata
    v = jax.random.uniform(k2, (n,))
    z = 1.0 - 2.0 * u
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * jnp.pi * v
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def trace_photons(scene, n_per_light: int = 8192,
                  seed: int = 0) -> PhotonMap:
    """Shoot ``n_per_light`` photons from every scene light (the 8K-photon
    batches of photons.cpp:197-250), intersect the whole batch as one
    wavefront, keep hits."""
    lights = scene.lights
    assert lights is not None, "scene has no lights"
    key = jax.random.PRNGKey(seed)
    pos_all, pow_all, nrm_all, dir_all = [], [], [], []
    n_lights = lights.pos.shape[0]
    for li in range(n_lights):
        key, sub = jax.random.split(key)
        d = _stratified_sphere(n_per_light, sub)
        o = jnp.broadcast_to(lights.pos[li], d.shape)
        tmax = jnp.full((n_per_light,), BIG, jnp.float32)
        dist, tri, bary = dispatch.closest_hit(scene, o, d, tmax)
        hit = (dist > 0.0) & (dist < BIG)

        p = o + d * dist[:, None]
        sh = jnp.take(scene.sh_pack, jnp.where(hit, tri, 0), axis=0)
        u, v = bary[:, 0], bary[:, 1]
        nx = sh[:, 0] + sh[:, 3] * u + sh[:, 6] * v
        ny = sh[:, 1] + sh[:, 4] * u + sh[:, 7] * v
        nz = sh[:, 2] + sh[:, 5] * u + sh[:, 8] * v
        nrm = jnp.stack([nx, ny, nz], axis=-1)
        nrm = nrm / jnp.maximum(
            jnp.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)

        # power: light color / photon count (photons.cpp power scaling)
        pw = jnp.broadcast_to(lights.color[li] / n_per_light, p.shape)

        m = np.asarray(hit)
        pos_all.append(np.asarray(p)[m])
        pow_all.append(np.asarray(pw)[m])
        nrm_all.append(np.asarray(nrm)[m])
        dir_all.append(np.asarray(d)[m])
    return PhotonMap(
        pos=np.concatenate(pos_all).astype(np.float32),
        power=np.concatenate(pow_all).astype(np.float32),
        normal=np.concatenate(nrm_all).astype(np.float32),
        dirn=np.concatenate(dir_all).astype(np.float32),
    )


# ---------------------------------------------------------------------------
# kd-tree (host, parity with MakePhotonTree) + oracle gather
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PhotonKd:
    """Median-split kd-tree over photons in flat arrays
    (photons.cpp:15-66: node = median photon on the widest axis)."""

    axis: np.ndarray    # [N] split axis, -1 for leaf
    index: np.ndarray   # [N] photon index at this node
    left: np.ndarray    # [N] child ids (-1 none)
    right: np.ndarray


def build_photon_kdtree(pmap: PhotonMap) -> PhotonKd:
    n = pmap.count
    axis = np.full(n, -1, np.int32)
    index = np.zeros(n, np.int32)
    left = np.full(n, -1, np.int32)
    right = np.full(n, -1, np.int32)
    order = np.arange(n)
    next_node = [0]

    def rec(ids: np.ndarray) -> int:
        if len(ids) == 0:
            return -1
        node = next_node[0]
        next_node[0] += 1
        pts = pmap.pos[ids]
        ax = int(np.argmax(pts.max(axis=0) - pts.min(axis=0)))
        srt = ids[np.argsort(pts[:, ax], kind="stable")]
        mid = len(srt) // 2
        axis[node] = ax
        index[node] = srt[mid]
        left[node] = rec(srt[:mid])
        right[node] = rec(srt[mid + 1:])
        return node

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        rec(order)
    finally:
        sys.setrecursionlimit(old)
    return PhotonKd(axis=axis, index=index, left=left, right=right)


def gather_photons_kd(kd: PhotonKd, pmap: PhotonMap, point, normal,
                      radius: float) -> np.ndarray:
    """Stack-based range gather (photons.cpp:68-195): photons within
    ``radius`` weighted by (1 - d/r) and by normal agreement
    max(0, n.n_p). Returns rgb irradiance estimate."""
    point = np.asarray(point, np.float32)
    normal = np.asarray(normal, np.float32)
    acc = np.zeros(3, np.float32)
    r2 = radius * radius
    stack = [0] if kd.axis.size else []
    while stack:
        node = stack.pop()
        if node < 0:
            continue
        pi = kd.index[node]
        dvec = pmap.pos[pi] - point
        d2 = float(dvec @ dvec)
        if d2 < r2:
            w = 1.0 - np.sqrt(d2) / radius
            na = max(0.0, float(normal @ pmap.normal[pi]))
            acc += pmap.power[pi] * (w * na)
        ax = kd.axis[node]
        if ax < 0:
            continue
        delta = point[ax] - pmap.pos[pi][ax]
        near, far = ((kd.left[node], kd.right[node]) if delta < 0
                     else (kd.right[node], kd.left[node]))
        stack.append(near)
        if delta * delta < r2:
            stack.append(far)
    return acc / (np.pi * r2)


# ---------------------------------------------------------------------------
# Vectorized gather: photon power grid + trilinear fetch
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PhotonGrid:
    grid: jnp.ndarray   # [G, G, G, 3] power density (power / cell volume)
    lo: jnp.ndarray     # [3]
    inv_cell: jnp.ndarray  # [3]
    res: int


jax.tree_util.register_dataclass(
    PhotonGrid, data_fields=["grid", "lo", "inv_cell"], meta_fields=["res"])


def photon_grid(pmap: PhotonMap, scene_lo, scene_hi,
                res: int = 64) -> PhotonGrid:
    """Splat photon powers into a dense density grid (host scatter —
    once per photon map, like the kd build)."""
    lo = np.asarray(scene_lo, np.float32) - 1e-4
    hi = np.asarray(scene_hi, np.float32) + 1e-4
    cell = (hi - lo) / res
    idx = np.clip(((pmap.pos - lo) / cell).astype(np.int64), 0, res - 1)
    flat = (idx[:, 0] * res + idx[:, 1]) * res + idx[:, 2]
    grid = np.zeros((res * res * res, 3), np.float32)
    np.add.at(grid, flat, pmap.power)
    vol = float(cell[0] * cell[1] * cell[2])
    grid = grid.reshape(res, res, res, 3) / vol
    return PhotonGrid(grid=jnp.asarray(grid), lo=jnp.asarray(lo),
                      inv_cell=jnp.asarray(1.0 / cell), res=res)


def gather_photons_grid(pg: PhotonGrid, points: jnp.ndarray) -> jnp.ndarray:
    """Trilinear density fetch: [R, 3] points -> [R, 3] irradiance-ish.
    One 8-corner gather per query — the vectorized GatherPhotons."""
    g = pg.res
    q = (points - pg.lo[None]) * pg.inv_cell[None] - 0.5
    q0 = jnp.floor(q)
    f = q - q0
    q0 = q0.astype(jnp.int32)

    def fetch(ox, oy, oz):
        ix = jnp.clip(q0[:, 0] + ox, 0, g - 1)
        iy = jnp.clip(q0[:, 1] + oy, 0, g - 1)
        iz = jnp.clip(q0[:, 2] + oz, 0, g - 1)
        return pg.grid[ix, iy, iz]

    fx, fy, fz = f[:, 0:1], f[:, 1:2], f[:, 2:3]
    c00 = fetch(0, 0, 0) * (1 - fz) + fetch(0, 0, 1) * fz
    c01 = fetch(0, 1, 0) * (1 - fz) + fetch(0, 1, 1) * fz
    c10 = fetch(1, 0, 0) * (1 - fz) + fetch(1, 0, 1) * fz
    c11 = fetch(1, 1, 0) * (1 - fz) + fetch(1, 1, 1) * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx


def render_photon_preview(scene, camera, width: int, height: int,
                          pg: PhotonGrid, exposure: float = 1.0):
    """Primary-hit render colored by photon density — the DrawPhotons
    OGL preview (render_opengl.h:20) as an image."""
    from ..render.raygen import primary_rays, tile_rays, untile_image

    origin, dirs = primary_rays(camera, width, height)
    th = 32 if height % 32 == 0 else 1
    tw = 32 if width % 32 == 0 else 1
    d = tile_rays(dirs, th, tw).reshape(-1, 3)
    o = jnp.broadcast_to(origin, d.shape)
    tmax = jnp.full(d.shape[:1], BIG, jnp.float32)
    dist, tri, bary = dispatch.closest_hit(scene, o, d, tmax)
    hit = (dist > 0.0) & (dist < BIG)
    p = o + d * jnp.where(hit, dist, 0.0)[:, None]
    rad = gather_photons_grid(pg, p) * exposure
    color = jnp.where(hit[:, None], rad, 0.0)
    return untile_image(color.reshape(-1, th * tw, 3), height, width,
                        th, tw)
