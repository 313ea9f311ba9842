"""Multi-host distribution: the rebuild of the reference's MPI layer.

The reference scales across machines with OpenMPI: rank 0 (the server)
broadcasts the scene/BVH once per connection and per-frame config every
frame, render nodes send compressed tiles back point-to-point
(reference src/comm_mpi.cpp:7-28, src/server.cpp:178-265,
src/node.cpp:210-359).  The mapping here:

  reference                          ->  here
  -------------------------------------------------------------------
  mpirun -np N node.sh                   one process per host, each
  (readme_distributed.txt:2-10)          calling :func:`initialize`
                                         (jax.distributed handshake =
                                         the MPI_Init + rank exchange)
  MPI_Bcast scene/BVH chunks             scene pytree replicated onto
  (server.cpp:120-164)                   the global mesh (host staging
                                         + device_put, XLA moves bytes
                                         over NVLink/network, no manual
                                         chunks)
  rank 0 relays tiles to the client      framebuffer shards all-gathered
  (server.cpp:389-401)                   over the mesh inside the jit
                                         (NVLink >> quicklz-over-GbE)
  per-node TreeStats + render times      per-device stats shards from the
  (server.cpp:406-418)                   same launch
  heterogeneous x86/PPC byte swap        N/A — one ISA, XLA owns layout

Single-process (the common case in tests and the driver's CPU dryrun)
needs none of this: :func:`initialize` is a no-op unless a multi-process
environment is configured, and :func:`global_mesh` degrades to the local
mesh.  Multi-process-on-one-box (the reference's ``mpirun -np N`` on a
single machine, SURVEY.md §4.5) is exercised by
``tests/test_distributed.py`` via two CPU subprocesses.
"""

from __future__ import annotations

import os
from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import AXIS

_initialized = False


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> bool:
    """Join (or skip) the multi-process JAX runtime.

    Arguments default to the ``SNAIL_COORD`` / ``SNAIL_NPROCS`` /
    ``SNAIL_PROC_ID`` environment variables (the mpirun-style launch:
    every host runs the same binary with its rank in the environment,
    reference node.sh:1-7).  Returns True when a multi-process runtime
    was joined, False for the single-process fast path.

    Nothing is autodetected: a multi-process launch must give the
    coordinator address (``localhost:<port>`` on one host), the process
    count and this process's id.
    """
    global _initialized
    if _initialized:
        return True

    coordinator_address = coordinator_address or os.environ.get("SNAIL_COORD")
    if num_processes is None and "SNAIL_NPROCS" in os.environ:
        num_processes = int(os.environ["SNAIL_NPROCS"])
    if process_id is None and "SNAIL_PROC_ID" in os.environ:
        process_id = int(os.environ["SNAIL_PROC_ID"])

    if coordinator_address is None and num_processes is None:
        return False  # single-process
    if num_processes is not None and num_processes <= 1:
        return False

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    _initialized = True
    return True


def is_initialized() -> bool:
    return _initialized


def process_count() -> int:
    return jax.process_count()


def process_index() -> int:
    return jax.process_index()


def global_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over every device of every process (the 'rays' axis).

    With a single process this is exactly ``parallel.mesh.make_mesh``;
    with N processes the mesh spans all N hosts' devices and shard_map
    launches run SPMD across them (the MPI world communicator)."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (AXIS,))


def replicate_scene(scene, mesh: Mesh):
    """Replicate the scene pytree onto every device of the mesh — the
    BVH/material/texture broadcast (SendBVH + SendMatDescs + SendTexDict,
    server.cpp:90-164) as one device_put."""
    rep = NamedSharding(mesh, P())
    return jax.tree.map(
        lambda x: jax.device_put(x, rep) if isinstance(x, jnp.ndarray) else x,
        scene,
    )


@partial(jax.jit, static_argnames=("width", "height", "mesh"))
def _render_sharded(scene, camera, width, height, opts, mesh):
    from .mesh import render_frame_sharded

    return render_frame_sharded(scene, camera, width, height, opts, mesh)


def render_frame_multihost(scene, camera, width: int, height: int, opts,
                           mesh: Optional[Mesh] = None) -> np.ndarray:
    """Render with rays sharded over the global mesh; return the full
    frame on every process as a host numpy array.

    The jit output is a global array whose shards live on each host's
    devices; ``process_allgather`` plays the role of the reference's
    node->server tile relay + client reassembly (server.cpp:389-401,
    client.cpp:307-333)."""
    mesh = mesh or global_mesh()
    img = _render_sharded(scene, camera, width, height, opts, mesh)
    if jax.process_count() == 1:
        return np.asarray(img)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(img, tiled=True))


def scaling_report(scene, camera, width: int, height: int, opts,
                   device_counts: Sequence[int], frames: int = 4,
                   rays_per_pixel: int = 2):
    """MRays/s at each device count + parallel efficiency — the rebuild of
    the reference's node-scaling tables (benchmark.txt:76-129).

    Returns a list of dicts: {devices, ms, mrays, efficiency}."""
    import time

    rows = []
    base = None
    for n in device_counts:
        if n > len(jax.devices()):
            continue
        mesh = global_mesh(n)
        s = replicate_scene(scene, mesh)
        img = _render_sharded(s, camera, width, height, opts, mesh)
        img.block_until_ready()  # compile + warmup
        t0 = time.perf_counter()
        for _ in range(frames):
            img = _render_sharded(s, camera, width, height, opts, mesh)
        img.block_until_ready()
        dt = (time.perf_counter() - t0) / frames
        mrays = width * height * rays_per_pixel / dt / 1e6
        if base is None:
            base = mrays
        rows.append({
            "devices": n,
            "ms": round(dt * 1e3, 2),
            "mrays": round(mrays, 2),
            "efficiency": round(mrays / (base * n / device_counts[0]), 3),
        })
    return rows
