"""BVH traversal as a CUDA kernel called through ``jax.ffi``.

The kernel (``native/traverse.cu``) runs one thread per ray with its stack
in local memory and reads node and triangle rows through the read-only
cache. It follows :mod:`snail.ops.traverse_ref` step for step, which
stays the oracle and the CPU path (:mod:`snail.ops.dispatch` picks
between them when the program is lowered).

The shared library is compiled with ``nvcc`` at first use into the
checkout's ``build/`` directory, keyed by a hash of the source. To build it
ahead of time::

    python -m snail.ops.traverse_cuda

A failed build or load raises; there is no fallback on a GPU.

No VJP is defined: every caller runs traversal under ``stop_gradient`` and
recomputes the continuous outputs differentiably (``snail.diff``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import jax
import jax.numpy as jnp

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "traverse.cu")
BUILD_DIR = os.path.join(_REPO, "build")

# -fmad=false: no contraction into FMAs, so the intersection terms round
# like traverse_ref's separate multiplies and adds
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

CLOSEST_TARGET = "snail_closest_hit"
ANY_TARGET = "snail_any_hit"

_registered = False


def library_path() -> str:
    """Build output for the current source and flags (a stale library can
    never shadow an edited ``traverse.cu``)."""
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    h = h.hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libsnail_traverse-{h}.so")


def _nvcc() -> str:
    cand = "/usr/local/cuda/bin/nvcc"
    found = shutil.which("nvcc") or (cand if os.path.exists(cand) else None)
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build native/traverse.cu")
    return found


def build() -> str:
    """Compile the kernel library if it is not built yet; return its path."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", jax.ffi.include_dir(), "-o", tmp,
           _SRC]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, so)
    return so


def _cuda_present() -> bool:
    try:
        return len(jax.devices("cuda")) > 0
    except RuntimeError:
        return False


def ensure_registered() -> None:
    """Build, load and register the FFI targets once, when a CUDA backend
    exists (tracing on a CPU-only host needs no library: the CUDA branch
    of the dispatch is never lowered there)."""
    global _registered
    if _registered or not _cuda_present():
        return
    lib = ctypes.CDLL(build())
    jax.ffi.register_ffi_target(
        CLOSEST_TARGET, jax.ffi.pycapsule(lib.SnailClosestHit),
        platform="CUDA")
    jax.ffi.register_ffi_target(
        ANY_TARGET, jax.ffi.pycapsule(lib.SnailAnyHit), platform="CUDA")
    _registered = True


def pack_nodes(scene) -> jnp.ndarray:
    """f32[N, 8] rows: lo.xyz, child | hi.xyz, count << 3 | first << 2 |
    axis (int fields as bit patterns)."""
    bits = lambda x: jax.lax.bitcast_convert_type(
        x.astype(jnp.int32), jnp.float32)
    meta = ((scene.node_count.astype(jnp.int32) << 3)
            | (scene.node_first.astype(jnp.int32) << 2)
            | scene.node_axis.astype(jnp.int32))
    return jnp.concatenate([
        scene.node_lo.astype(jnp.float32), bits(scene.node_child)[:, None],
        scene.node_hi.astype(jnp.float32), bits(meta)[:, None],
    ], axis=1)


def pack_tris(a, ba, ca) -> jnp.ndarray:
    """f32[T, 12] rows a.xyz, 0 | ba.xyz, 0 | ca.xyz, 0: three float4
    loads per triangle, packed from the current (possibly trained)
    vertices."""
    z = jnp.zeros((a.shape[0], 1), jnp.float32)
    return jnp.concatenate([a, z, ba, z, ca, z], axis=1).astype(jnp.float32)


def _operands(scene, orig, dirn, tmax):
    ensure_registered()
    return (pack_nodes(scene),
            pack_tris(scene.tri_a, scene.tri_ba, scene.tri_ca),
            orig.astype(jnp.float32), dirn.astype(jnp.float32),
            tmax.astype(jnp.float32))


def closest_hit(scene, orig, dirn, tmax):
    """(dist [R], tri [R] int32, bary [R, 2]); ``orig`` is [R, 3] or one
    shared [3] origin."""
    r = tmax.shape[0]
    out = (jax.ShapeDtypeStruct((r,), jnp.float32),
           jax.ShapeDtypeStruct((r,), jnp.int32),
           jax.ShapeDtypeStruct((r, 2), jnp.float32))
    return jax.ffi.ffi_call(CLOSEST_TARGET, out)(
        *_operands(scene, orig, dirn, tmax))


def any_hit(scene, orig, dirn, tmax):
    """blocked [R] bool; ``orig`` is [R, 3] or one shared [3] origin."""
    out = jax.ShapeDtypeStruct(tmax.shape, jnp.bool_)
    return jax.ffi.ffi_call(ANY_TARGET, out)(
        *_operands(scene, orig, dirn, tmax))


if __name__ == "__main__":
    print(build())
