"""Golden-image regression (the compare_img workflow, tools/compare_img.cpp
:15-29 + the reference's `k`-key output.tga dumps, rtracer.cpp:240-243).

The reference binaries can't be built (libfwk is an empty submodule), so the
goldens are OUR pinned renders: fixed scenes/cameras/options rendered through
render_frame with the jnp reference traversal, committed as small PNGs.
Kernel or perf work cannot silently change output: renders must keep
matching these within 1 uint8 LSB.

Regenerate (only for a deliberate, reviewed change of shading semantics):
    python tests/test_golden.py regen
"""

import os
import tempfile

import numpy as np
import pytest

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
NAMES = ("box64", "cornell64")


def _case(idx, tmp_dir):
    """Golden case ``idx``: (name, scene, camera, opts, w, h). Each case is
    built on its own, so one case's inputs cannot fail the other."""
    from snail.bvh import build_bvh
    from snail.core.types import Camera, Light, RenderOpts
    from snail.scene.materials import MaterialDesc
    from snail.scene.procedural import (box_obj_scene, cornell_scene,
                                        write_mtl, write_obj)
    from snail.scene.scene import load_scene, make_traced_scene

    if idx == 0:
        # box.obj through the loader + full Whitted with shadows (config 1
        # analogue)
        path = os.path.join(tmp_dir, "box.obj")
        write_obj(path, box_obj_scene())
        write_mtl(os.path.join(tmp_dir, "box.mtl"),
                  [MaterialDesc(name="Material", diffuse=(0.8, 0.8, 0.8))])
        scene = load_scene(path, cache_dir=None, backend="reference")
        cam = Camera.look_at(pos=(3.0, 2.5, 4.0), target=(0.0, 0.0, 0.0))
        opts = RenderOpts(reflections=False, transparency=False,
                          textures=False)
        return NAMES[0], scene, cam, opts, 64, 64

    # procedural cornell: reflections + transparency exercise bounces
    g = cornell_scene().flatten()
    lo, hi = g.bounds()
    bvh = build_bvh(lo, hi, leaf_size=8)
    lights = Light.make((0.0, 3.5, 0.0), (1.0, 0.9, 0.8), 30.0)
    cscene = make_traced_scene(g, bvh, lights=lights, backend="reference")
    ccam = Camera.look_at(pos=(0.0, 2.0, 6.0), target=(0.0, 1.5, 0.0))
    return NAMES[1], cscene, ccam, RenderOpts(textures=False), 64, 64


def _render(scene, cam, opts, w, h):
    from snail.render.renderer import render_frame, to_rgb8

    return to_rgb8(render_frame(scene, cam, w, h, opts))


@pytest.mark.parametrize("idx", [0, 1])
def test_golden_images(idx, tmp_path):
    from snail.utils.image import load_image

    name, scene, cam, opts, w, h = _case(idx, str(tmp_path))
    path = os.path.join(GOLD, f"{name}.png")
    assert os.path.exists(path), f"golden missing: {path} (run regen)"
    golden = (load_image(path) * 255.0).round().astype(np.int16)
    img = _render(scene, cam, opts, w, h).astype(np.int16)
    diff = np.abs(img - golden)
    # float->uint8 truncation may flip one LSB across compilers/backends
    assert diff.max() <= 1, (
        f"{name}: max err {diff.max()} LSB, "
        f"{(diff.max(axis=-1) > 1).mean():.4f} of pixels off"
    )


def regen():
    os.makedirs(GOLD, exist_ok=True)
    from snail.utils.image import save_image

    with tempfile.TemporaryDirectory() as tmp:
        for idx in range(len(NAMES)):
            name, scene, cam, opts, w, h = _case(idx, tmp)
            img = _render(scene, cam, opts, w, h)
            save_image(os.path.join(GOLD, f"{name}.png"), img)
            print("wrote", name, img.shape, img.mean())


if __name__ == "__main__":
    import sys

    os.environ["JAX_PLATFORMS"] = "cpu"
    if len(sys.argv) > 1 and sys.argv[1] == "regen":
        regen()
