"""Entry-point hygiene that the CPU can check: the compile-cache helper
and chip_smoke.py refusing to run without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_config():
    import jax

    old = jax.config.jax_compilation_cache_dir
    yield jax.config
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_in_checkout_by_default(monkeypatch, cache_config):
    from snail.utils.device import setup_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = setup_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert cache_config.jax_compilation_cache_dir == path


def test_compile_cache_env_wins(monkeypatch, cache_config, tmp_path):
    from snail.utils.device import setup_compile_cache

    before = cache_config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert setup_compile_cache() == str(tmp_path)
    # the program sets no directory of its own: JAX reads the variable
    assert cache_config.jax_compilation_cache_dir == before


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    """No accelerator, or no program beside the script: a non-zero exit
    and no result line."""
    cwd = REPO
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    r = _run_smoke(cwd)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
