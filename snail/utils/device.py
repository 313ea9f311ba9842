"""Process set-up shared by the entry points that drive a GPU: the
persistent compile cache, the device check and the card's identity."""

from __future__ import annotations

import os
import subprocess

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def setup_compile_cache() -> str:
    """Use ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it
    itself); otherwise keep the cache in ``<checkout>/.jax_cache``.
    Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu(count: int = 1):
    """The first ``count`` devices; raises unless JAX sees at least that
    many GPUs (a measurement never falls back to the CPU)."""
    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < count:
        raise RuntimeError(
            f"needs {count} GPU(s); JAX sees {len(devs)} "
            f"{devs[0].platform} device(s)")
    return devs[:count]


def gpu_name_and_power() -> str:
    """``name, power.limit`` of each card as nvidia-smi reports them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return r.stdout.strip()


def device_record() -> dict:
    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}
