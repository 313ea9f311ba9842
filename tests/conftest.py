"""Test harness config.

Tests run on the CPU with 8 virtual XLA devices, the one-box stand-in for a
multi-GPU host (the same trick the reference uses by running ``mpirun -np
N`` on one machine, SURVEY.md §4.5). Tests that need a GPU carry the
``gpu`` marker and skip here; ``chip_smoke.py`` runs their substance on the
card.

Scene files are generated into temporary directories by the OBJ/MTL writer
of snail/scene/procedural.py, so no asset directory is needed.
"""

import os

# the CPU unless the caller picks a platform (JAX_PLATFORMS=cuda,cpu runs
# the gpu-marked tests on a card)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest

# An inline material library (the sponza.mtl shapes the loader must take:
# single-value colors, illum, d, Ns, texture maps, a commented line).
MTL = """# test library
newmtl leaf
Ka 0 0 0
Kd 0.58 0.58 0.58
Ks 0
illum 2
d 1
Ns 10
map_Kd textures/sponza_thorn_diff.tga
map_d textures/sponza_thorn_mask.tga

newmtl vase_round
Kd 0.6 0.5 0.4
Ks 0.3 0.3 0.3
Ns 20

newmtl Material__57
Kd 0.2
d 0.5
map_Kd textures/vase_plant.tga
"""


@pytest.fixture(scope="session")
def scene_dir(tmp_path_factory):
    """box.obj + box.mtl, terrain.obj (a seeded stand-in for feline.obj:
    10,368 triangles, no normals in the file) and test.mtl."""
    from snail.scene.materials import MaterialDesc
    from snail.scene.procedural import (box_obj_scene, terrain_scene,
                                        write_mtl, write_obj)

    d = tmp_path_factory.mktemp("scenes")
    write_obj(str(d / "box.obj"), box_obj_scene())
    write_mtl(str(d / "box.mtl"), [MaterialDesc(name="Material",
                                                diffuse=(0.8, 0.8, 0.8))])
    terrain = terrain_scene(72, extent=10.0, seed=0)
    for obj in terrain.objects:  # as a scanned mesh ships: no normals
        obj.normals = np.zeros((0, 3), np.float32)
        obj.tri_vn[:] = -1
    write_obj(str(d / "terrain.obj"), terrain)
    (d / "test.mtl").write_text(MTL)
    return d


@pytest.fixture(scope="session")
def box_path(scene_dir):
    return str(scene_dir / "box.obj")


@pytest.fixture(scope="session")
def box_scene(box_path):
    from snail.scene import load_wavefront_obj

    return load_wavefront_obj(box_path)


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test where there is none."""
    import jax

    try:
        return jax.devices("cuda")[0]
    except RuntimeError:
        pytest.skip("needs a CUDA GPU; chip_smoke.py runs this on the card")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
