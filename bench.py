"""Benchmark of render_frame and the differentiable step on one GPU.

Mirrors the reference's benchmark methodology (benchmark.txt: frame time at
a fixed resolution, MRays/s counting primary + shadow rays, client stat
accumulation client.cpp:215-252) on the seeded 100 k-triangle terrain of
``scene.procedural.smoke_scene`` at 1024x1024, one point light, shadows
and reflections on.

    python bench.py [section ...]     # default: every section

Sections, all through the public entry points (render_frame, or
jax.value_and_grad over it):

  fwd         forward frame, the CUDA traversal kernel
  fwd_ref     the same frame with traverse_ref under XLA
  tex         forward with a procedural checker texture
  multilight  4 lights and 2x2 supersampling (the reference's abrams row,
              benchmark.txt:126-129)
  bwd         value_and_grad of an L2 image loss over vertices, materials,
              light and camera (BASELINE config 4)
  bwd_min     value_and_grad over tri_a and mat_diffuse, no secondary rays
  leaf        the fwd frame for BVH leaf sizes 8, 16 and 32

Every row is one JSON line with the median, min and max over the timed
frames, the device as JAX reports it and the card's name and power limit
as nvidia-smi reports them. The script fails when JAX finds no GPU.
"""

import dataclasses
import json
import statistics
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from snail.core.types import Light, RenderOpts
from snail.render.renderer import render_frame
from snail.scene.procedural import smoke_scene
from snail.utils.device import (device_record, gpu_name_and_power,
                                require_gpu, setup_compile_cache)

WIDTH = HEIGHT = 1024
FRAMES = 10
OPTS = RenderOpts(shadows=True, reflections=True, transparency=False,
                  textures=False)

_CARD = None


def emit(metric, ms, rays, **extra):
    row = {
        "metric": metric,
        "median_ms": statistics.median(ms),
        "min_ms": min(ms),
        "max_ms": max(ms),
        "frames": len(ms),
        "mrays_per_s": rays / statistics.median(ms) / 1e3,
        "device": device_record(),
        "card": _CARD,
        **extra,
    }
    print(json.dumps(row), flush=True)


def timed(fn, frames=FRAMES):
    """One warm-up call (compile), then ``frames`` calls each ending in
    block_until_ready; returns the times in ms."""
    jax.block_until_ready(fn())
    out = []
    for _ in range(frames):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _rays(scene, samples=1):
    """Primary + one shadow ray per light and sample (the reference's
    client accounting, client.cpp:374-379)."""
    return WIDTH * HEIGHT * samples * (1 + scene.lights.pos.shape[0])


def _fwd(scene, cam, opts, name, **extra):
    ms = timed(lambda: render_frame(scene, cam, WIDTH, HEIGHT, opts))
    samples = 4 if opts.supersample else 1
    emit(name, ms, _rays(scene, samples), tris=scene.num_tris, **extra)


def section_fwd():
    scene, cam = smoke_scene()
    _fwd(scene, cam, OPTS, "terrain100k_1024_fwd")


def section_fwd_ref():
    scene, cam = smoke_scene(backend="reference")
    _fwd(scene, cam, OPTS, "terrain100k_1024_fwd_traverse_ref")


def section_tex():
    from snail.scene.textures import checker_atlas

    scene, cam = smoke_scene()
    _fwd(checker_atlas(scene), cam, dataclasses.replace(OPTS, textures=True),
         "terrain100k_1024_fwd_tex")


def section_multilight():
    scene, cam = smoke_scene()
    lights = Light(
        pos=np.array([[60.0, 20.0, 20.0], [-60.0, 20.0, 20.0],
                      [20.0, 20.0, -60.0], [-20.0, 30.0, 60.0]], np.float32),
        color=np.full((4, 3), 0.8, np.float32),
        radius=np.full((4,), 200.0, np.float32),
    )
    _fwd(scene.with_lights(lights), cam,
         dataclasses.replace(OPTS, supersample=True),
         "terrain100k_1024_4light_4xAA_fwd")


def _step(params, scene, cam, target, opts):
    lights = scene.lights
    if "light_pos" in params:
        lights = Light(pos=params["light_pos"], color=params["light_color"],
                       radius=lights.radius)
    fields = {k: v for k, v in params.items()
              if k in ("tri_a", "tri_ba", "tri_ca", "mat_diffuse",
                       "mat_specular")}
    s = dataclasses.replace(scene, lights=lights, **fields)
    c = dataclasses.replace(cam, pos=params.get("cam_pos", cam.pos))
    color = render_frame(s, c, WIDTH, HEIGHT, opts)
    return jnp.mean((color - target) ** 2)


def _bwd(name, keys, opts):
    scene, cam = smoke_scene()
    target = jax.lax.stop_gradient(render_frame(
        dataclasses.replace(scene, mat_diffuse=scene.mat_diffuse * 0.8),
        cam, WIDTH, HEIGHT, opts))
    every = {
        "tri_a": scene.tri_a, "tri_ba": scene.tri_ba, "tri_ca": scene.tri_ca,
        "mat_diffuse": scene.mat_diffuse,
        "mat_specular": scene.mat_specular,
        "light_pos": scene.lights.pos, "light_color": scene.lights.color,
        "cam_pos": cam.pos,
    }
    params = {k: every[k] for k in keys}
    # scene/target are jit arguments: closed over, they would be inlined
    # as constants into the program
    vg = jax.jit(jax.value_and_grad(_step))
    loss, grads = vg(params, scene, cam, target, opts)
    if not np.isfinite(float(loss)):
        raise AssertionError(f"loss {loss}")
    for k, g in grads.items():
        if not np.isfinite(np.asarray(g)).all():
            raise AssertionError(f"non-finite gradient {k}")
    ms = timed(lambda: vg(params, scene, cam, target, opts), frames=5)
    emit(name, ms, _rays(scene), grad_params=sorted(params))


def section_bwd():
    _bwd("terrain100k_1024_fwd_bwd",
         ("tri_a", "tri_ba", "tri_ca", "mat_diffuse", "mat_specular",
          "light_pos", "light_color", "cam_pos"), OPTS)


def section_bwd_min():
    _bwd("terrain100k_1024_fwd_bwd_minimal", ("tri_a", "mat_diffuse"),
         dataclasses.replace(OPTS, reflections=False))


def section_leaf():
    for leaf in (8, 16, 32):
        for backend in ("auto", "reference"):
            scene, cam = smoke_scene(backend=backend, leaf_size=leaf)
            _fwd(scene, cam, OPTS, f"terrain100k_1024_fwd_leaf{leaf}",
                 leaf_size=leaf, traversal=backend, nodes=scene.num_nodes,
                 depth=scene.depth)


SECTIONS = {
    "fwd": section_fwd,
    "fwd_ref": section_fwd_ref,
    "tex": section_tex,
    "multilight": section_multilight,
    "bwd_min": section_bwd_min,
    "bwd": section_bwd,
    "leaf": section_leaf,
}


def main(argv):
    global _CARD
    names = argv or [n for n in SECTIONS if n != "leaf"]
    unknown = [n for n in names if n not in SECTIONS]
    if unknown:
        raise SystemExit(f"unknown section(s) {unknown}; "
                         f"choose from {sorted(SECTIONS)}")
    setup_compile_cache()
    require_gpu()
    _CARD = gpu_name_and_power()
    print(f"# {_CARD}", file=sys.stderr, flush=True)
    for name in names:
        SECTIONS[name]()


if __name__ == "__main__":
    main(sys.argv[1:])
