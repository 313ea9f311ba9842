"""snail — a differentiable Whitted-style ray tracing framework in JAX.

A from-scratch rebuild of the capabilities of nadult/Snail:

- ``snail.core``     — math primitives & pytree types (replaces veclib/ +
  src/rtbase*.h: the SIMD abstraction is jnp; masks are bool arrays).
- ``snail.scene``    — scene assembly: OBJ/MTL loaders, normals, materials,
  textures, lights, cameras (replaces src/base_scene.*, src/formats/,
  src/shading/, src/sampling/, src/camera.*, src/light.h).
- ``snail.bvh``      — SAH BVH build (binned + sweep) into flat
  device-friendly arrays, disk cache, two-level instancing
  (replaces src/bvh/, src/dbvh/, dump/ cache).
- ``snail.ops``      — the device compute path: the CUDA traversal kernel
  (closest-hit + any-hit, native/traverse.cu) and the pure-jnp reference
  traversal it is checked against (replaces src/bvh/traverse.cpp,
  src/triangle.cpp, src/spu/ kernels).
- ``snail.render``   — ray generation, the Whitted integrator, frame
  renderer, debug shaders (replaces src/scene_inl.h, src/scene_trace.cpp,
  src/render.*, src/ray_generator.*).
- ``snail.diff``     — gradients: custom VJP through traversal
  (no reference counterpart; BASELINE.json north star).
- ``snail.parallel`` — device meshes, tile sharding, multi-host init,
  the render service (replaces src/comm*, src/server.cpp, src/node.cpp,
  src/client.cpp, src/compression.*).
- ``snail.utils``    — stats counters, runtime debug toggles, image IO &
  comparison (replaces src/tree_stats.*, gVals, tools/compare_img.cpp).
"""

__version__ = "0.1.0"
