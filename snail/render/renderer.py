"""Frame renderer: camera -> tiled wavefronts -> integrator -> RGB image.

Rebuild of the reference's ``Render`` frame scheduler (src/render.cpp:214-267)
and ``RenderTask::Work`` (render.cpp:47-211). Where the reference cuts the
image into 64x64 thread-pool tasks and 8x8 ray packets, here the whole frame
is one jit-compiled wavefront launch — XLA owns the device the way the
thread pool owned the cores — and the tile structure survives only as the
ray ordering that gives each warp of the traversal kernel neighbouring
pixels.

Also here: 2x2 supersampling (gVals[9], render.cpp:60-110: renders at 2x
resolution and box-averages 4 samples/pixel) and RGB8 conversion
(ConvColor clamp*255, render.cpp:155-159).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import Camera, RenderOpts
from ..core.vecmath import BIG
from .integrator import render_wavefront
from .raygen import TILE_H, TILE_W, primary_rays, tile_rays, untile_image


@partial(jax.jit, static_argnames=("width", "height"))
def render_frame(scene, camera: Camera, width: int, height: int,
                 opts: RenderOpts = RenderOpts(), photon_grid=None):
    """Render a full frame; returns float32 [height, width, 3] linear color.

    One path for every device: the (differentiable) wavefront integrator.
    ``photon_grid`` (render/photons.py PhotonGrid) + opts.photons adds the
    photon-map radiance term."""
    scale = 2 if opts.supersample else 1
    w, h = width * scale, height * scale
    th = TILE_H if h % TILE_H == 0 else 1
    tw = TILE_W if w % TILE_W == 0 else 1
    origin, dirs = primary_rays(camera, w, h)
    d = tile_rays(dirs, th, tw).reshape(-1, 3)
    o = jnp.broadcast_to(origin, d.shape)
    tmax = jnp.full(d.shape[:1], BIG, jnp.float32)

    color = render_wavefront(scene, o, d, tmax, opts, tile_hw=(th, tw),
                             photon_grid=photon_grid)
    img = untile_image(color.reshape(-1, th * tw, 3), h, w, th, tw)
    if opts.supersample:
        img = (
            img[0::2, 0::2] + img[1::2, 0::2] + img[0::2, 1::2] + img[1::2, 1::2]
        ) * 0.25
    return img


def to_rgb8(img) -> np.ndarray:
    """ConvColor (render.cpp:155-159): clamp to [0,255] and truncate."""
    arr = np.asarray(jnp.clip(img * 255.0, 0.0, 255.0)).astype(np.uint8)
    return arr


class Renderer:
    """Convenience stateful wrapper (the rtracer draw loop,
    rtracer.cpp:357-386): holds scene + opts, renders frames, tracks FPS."""

    def __init__(self, scene, width: int, height: int,
                 opts: RenderOpts = RenderOpts()):
        self.scene = scene
        self.width = width
        self.height = height
        self.opts = opts
        from ..utils.frame_counter import FrameCounter

        self.fps = FrameCounter()

    def render(self, camera: Camera) -> np.ndarray:
        img = render_frame(
            self.scene, camera, self.width, self.height, self.opts
        )
        img.block_until_ready()
        self.fps.tick()
        return np.asarray(img)

    def render_rgb8(self, camera: Camera) -> np.ndarray:
        return to_rgb8(self.render(camera))
