"""Smoke test of the system on one NVIDIA GPU, through its public entry
points, at full size.

    python chip_smoke.py              # one card: the five phases below
    python chip_smoke.py --multi-gpu  # four cards: sharded render + step

Phases (each raises on failure; none is caught):

1. device     — JAX sees exactly one GPU; print the card and power limit.
2. forward    — render_frame at 1024x1024 on the 100 k-triangle terrain
                (shadows + reflections), 1 warm-up + 10 timed frames, with
                the CUDA traversal kernel and with scene.with_backend(
                "reference") (traverse_ref under XLA) in the same process.
3. traversal  — the kernel's closest hits and shadow occlusion over the
                full 1024^2 primary and shadow wavefronts against
                traverse_ref on the card.
4. gradient   — jax.value_and_grad of an L2 image loss w.r.t. vertices,
                materials, light and camera at 1024^2 (3 timed steps, all
                finite), and at 128^2 against the same step on the CPU.
5. server     — apps.server.serve_connection over a socketpair serves 4
                frames of 1120x640 with one light; each equals render_frame.

--multi-gpu runs only render_frame_sharded and train_step_sharded on four
cards against the one-card frame and step.

The last line of stdout is {"ok": true, "device": {...}}; any failure
exits non-zero before it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import statistics
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# phase 4 compiles for the CPU beside the GPU
_plat = os.environ.get("JAX_PLATFORMS")
if _plat and "cpu" not in _plat.split(","):
    os.environ["JAX_PLATFORMS"] = _plat + ",cpu"

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from snail.core.types import Light, RenderOpts  # noqa: E402
from snail.core.vecmath import BIG  # noqa: E402
from snail.utils.device import (  # noqa: E402
    device_record,
    gpu_name_and_power,
    require_gpu,
    setup_compile_cache,
)

W = H = 1024
OPTS = RenderOpts(shadows=True, reflections=True, transparency=False,
                  textures=False)


def log(*a):
    print(*a, flush=True)


def timed(fn, n):
    """Warm up once (compile), then time ``n`` calls that each end in
    block_until_ready. Returns the times in ms."""
    jax.block_until_ready(fn())
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def summary(ms):
    return (f"median {statistics.median(ms):.3f} ms "
            f"(min {min(ms):.3f}, max {max(ms):.3f}, n={len(ms)})")


# --------------------------------------------------------------------- 1
def phase_device(count):
    devs = require_gpu(count)
    if len(jax.devices()) != count:
        raise RuntimeError(f"expected exactly {count} GPU(s), JAX sees "
                           f"{len(jax.devices())}")
    card = gpu_name_and_power()
    log(f"[device] {devs[0].device_kind} x{len(devs)}; nvidia-smi: {card}")
    return card


# --------------------------------------------------------------------- 2
def phase_forward(scene, cam, card):
    from snail.render.renderer import render_frame

    res = {}
    for name, s in (("kernel", scene),
                    ("reference", scene.with_backend("reference"))):
        t0 = time.perf_counter()
        img = render_frame(s, cam, W, H, OPTS)
        img.block_until_ready()
        compile_s = time.perf_counter() - t0
        ms = timed(lambda: render_frame(s, cam, W, H, OPTS), 10)
        img = np.asarray(render_frame(s, cam, W, H, OPTS))
        if img.shape != (H, W, 3) or not np.isfinite(img).all():
            raise AssertionError(f"{name}: bad frame {img.shape}")
        if img.max() <= 0.0:
            raise AssertionError(f"{name}: black frame")
        res[name] = (ms, img)
        log(f"[forward] {name}: first call {compile_s:.1f} s; {summary(ms)}")
    diff = np.abs(res["kernel"][1] - res["reference"][1])
    log(f"[forward] kernel vs reference image: max |d| {diff.max():.3g}, "
        f"pixels off by >1/255: {(diff.max(-1) > 1 / 255).mean():.2e}")
    mk = statistics.median(res["kernel"][0])
    mr = statistics.median(res["reference"][0])
    log(f"[forward] {W}x{H} shadows+reflections, {scene.num_tris} tris: kernel "
        f"{mk:.3f} ms, traverse_ref {mr:.3f} ms, ratio {mr / mk:.2f}x "
        f"on {card}")
    return mk, mr


# --------------------------------------------------------------------- 3
def phase_traversal(scene, cam):
    from snail.ops import dispatch
    from snail.render.raygen import TILE_H, TILE_W, primary_rays, tile_rays

    origin, dirs = primary_rays(cam, W, H)
    d = tile_rays(dirs, TILE_H, TILE_W).reshape(-1, 3)
    o = jnp.broadcast_to(origin, d.shape)
    tmax = jnp.full(d.shape[:1], BIG, jnp.float32)
    lp = scene.lights.pos[0]

    @jax.jit
    def run(s, o, d, tmax):
        dist, tri, bary = dispatch.closest_hit(s, o, d, tmax)
        # the shadow wavefront of the reference's hits: from the light
        # toward each hit point (trace_light's geometry)
        hit = (dist > 0) & (dist < BIG)
        p = o + d * jnp.where(hit, dist, 0.0)[:, None]
        lv = p - lp
        ld = jnp.sqrt(jnp.sum(lv * lv, -1))
        sd = lv / jnp.maximum(ld, 1e-12)[:, None]
        stm = jnp.where(hit, ld * 0.9999, -BIG)
        return dist, tri, bary, sd, stm

    @jax.jit
    def shadow(s, sd, stm):
        return dispatch.any_hit_from(s, lp, sd, stm)

    ref = scene.with_backend("reference")
    kd, kt, kb, _, _ = map(np.asarray, run(scene, o, d, tmax))
    rd, rt, rb, sd, stm = run(ref, o, d, tmax)
    kblk = np.asarray(shadow(scene, sd, stm))
    rblk = np.asarray(shadow(ref, sd, stm))
    rd, rt, rb = map(np.asarray, (rd, rt, rb))

    n = rd.size
    khit = (kd > 0) & (kd < BIG)
    rhit = (rd > 0) & (rd < BIG)
    agree = (khit == rhit).mean()
    both = khit & rhit
    same = both & (kt == rt)
    tri_eq = same.sum() / max(both.sum(), 1)
    ddist = np.abs(kd - rd)[same]
    dlim = 1e-4 * np.maximum(1.0, rd[same])
    dbary = np.abs(kb - rb)[same].max(initial=0.0)
    sh_agree = (kblk == rblk).mean()
    over_b = int((np.abs(kb - rb)[same].max(-1, initial=0.0) > 1e-4).sum())
    log(f"[traversal] {n} primary rays, {rhit.sum()} hits: hit/miss agree "
        f"{agree:.6f}, same triangle {tri_eq:.6f} of hits, max |d dist| "
        f"{ddist.max(initial=0.0):.3g} ({int((ddist > dlim).sum())} over "
        f"1e-4*max(1,dist)), max |d bary| {dbary:.3g} ({over_b} over 1e-4); "
        f"{int((stm >= 0).sum())} shadow rays, blocked agree {sh_agree:.6f} "
        f"({rblk.sum()} blocked)")
    if agree < 0.9999:
        raise AssertionError(f"hit/miss agreement {agree} < 0.9999")
    if tri_eq < 0.999:
        raise AssertionError(f"same-triangle share {tri_eq} < 0.999")
    if (ddist > dlim).any():
        raise AssertionError("distance beyond 1e-4 * max(1, dist)")
    if dbary > 1e-4:
        raise AssertionError(f"barycentric difference {dbary} > 1e-4")
    if sh_agree < 0.9999:
        raise AssertionError(f"shadow agreement {sh_agree} < 0.9999")
    if not rhit.any() or not rblk.any():
        raise AssertionError("degenerate wavefront: no hits or no shadow")


# --------------------------------------------------------------------- 4
GRAD_KEYS = ("tri_a", "tri_ba", "tri_ca", "mat_diffuse", "mat_specular",
             "light_pos", "light_color", "cam_pos")


def _grad_params(scene, cam):
    return {
        "tri_a": scene.tri_a, "tri_ba": scene.tri_ba, "tri_ca": scene.tri_ca,
        "mat_diffuse": scene.mat_diffuse,
        "mat_specular": scene.mat_specular,
        "light_pos": scene.lights.pos, "light_color": scene.lights.color,
        "cam_pos": cam.pos,
    }


def _loss(params, scene, cam, target):
    from snail.render.renderer import render_frame

    lights = Light(pos=params["light_pos"], color=params["light_color"],
                   radius=scene.lights.radius)
    s = dataclasses.replace(
        scene, tri_a=params["tri_a"], tri_ba=params["tri_ba"],
        tri_ca=params["tri_ca"], mat_diffuse=params["mat_diffuse"],
        mat_specular=params["mat_specular"], lights=lights)
    c = dataclasses.replace(cam, pos=params["cam_pos"])
    h, w = target.shape[:2]
    return jnp.mean((render_frame(s, c, w, h, OPTS) - target) ** 2)


_value_and_grad = jax.jit(jax.value_and_grad(_loss))


def _target(scene, cam, w, h):
    """A different image to fit: the frame with darker materials."""
    from snail.render.renderer import render_frame

    s = dataclasses.replace(scene, mat_diffuse=scene.mat_diffuse * 0.8)
    return jax.lax.stop_gradient(render_frame(s, cam, w, h, OPTS))


def phase_gradient(scene, cam):
    params = _grad_params(scene, cam)
    target = _target(scene, cam, W, H)
    ms = timed(lambda: _value_and_grad(params, scene, cam, target), 3)
    loss, grads = _value_and_grad(params, scene, cam, target)
    if not np.isfinite(float(loss)):
        raise AssertionError(f"loss {loss}")
    for k in GRAD_KEYS:
        g = np.asarray(grads[k])
        if not np.isfinite(g).all():
            raise AssertionError(f"non-finite gradient {k}")
    log(f"[gradient] 1024x1024 value_and_grad over {len(GRAD_KEYS)} groups: "
        f"loss {float(loss):.6g}; {summary(ms)}")

    # 128^2: the same step on the GPU and on the CPU
    cpu = jax.devices("cpu")[0]
    tgt = _target(scene, cam, 128, 128)
    lg, gg = _value_and_grad(params, scene, cam, tgt)
    args = jax.device_put((params, scene, cam, tgt), cpu)
    lc, gc = _value_and_grad(*args)
    worst = 0.0
    for k in GRAD_KEYS:
        a, b = np.asarray(gg[k], np.float64), np.asarray(gc[k], np.float64)
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        worst = max(worst, rel)
        log(f"[gradient] 128x128 {k}: |g| {np.linalg.norm(b):.4g}, "
            f"rel L2 GPU vs CPU {rel:.3g}")
        if not rel <= 1e-3:
            raise AssertionError(f"{k}: GPU vs CPU relative L2 {rel} > 1e-3")
    log(f"[gradient] 128x128 loss GPU {float(lg):.8g} CPU {float(lc):.8g}; "
        f"worst rel L2 {worst:.3g}")


# --------------------------------------------------------------------- 5
def phase_server():
    from snail.apps.server import _opts_from_gvals, serve_connection
    from snail.core.types import Camera
    from snail.net import protocol
    from snail.render.renderer import render_frame, to_rgb8
    from snail.scene.procedural import (SMOKE_LIGHT, smoke_base,
                                        smoke_camera, smoke_material,
                                        write_mtl, write_obj)
    from snail.scene.scene import load_scene

    sdir = os.path.join(REPO, "build", "smoke_scene")
    os.makedirs(sdir, exist_ok=True)
    write_obj(os.path.join(sdir, "terrain.obj"), smoke_base())
    write_mtl(os.path.join(sdir, "terrain.mtl"), [smoke_material()])

    rw, rh = 1120, 640
    srv, cli = socket.socketpair()
    err = []

    def serve():
        try:
            serve_connection(srv, sdir, cache_dir=None)
        except Exception as e:  # reported by the client side below
            err.append(e)
        finally:
            srv.close()

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    protocol.send_json(cli, protocol.LoadModel("terrain.obj", rw, rh)
                       .to_json())
    ready = protocol.recv_json(cli)
    if ready.get("type") != "model_ready":
        raise AssertionError(f"server: {ready}")
    light = {"pos": list(SMOKE_LIGHT[0]), "color": list(SMOKE_LIGHT[1]),
             "radius": SMOKE_LIGHT[2]}
    gvals = {"reflections": True, "transparency": False, "textures": False}

    scene = load_scene(os.path.join(sdir, "terrain.obj"), cache_dir=None)
    scene = scene.with_lights(Light.make(*SMOKE_LIGHT))
    lo, hi = np.asarray(scene.node_lo[0]), np.asarray(scene.node_hi[0])
    base_cam = smoke_camera(lo, hi)
    target = (lo + hi) * 0.5
    frames = []
    for f in range(4):
        ang = 0.15 * f
        off = np.asarray(base_cam.pos) - target
        pos = target + np.array([off[0] * np.cos(ang) + off[2] * np.sin(ang),
                                 off[1],
                                 -off[0] * np.sin(ang) + off[2] * np.cos(ang)])
        req = protocol.FrameRequest(cam_pos=tuple(map(float, pos)),
                                    cam_target=tuple(map(float, target)),
                                    lights=[light], gvals=gvals)
        t0 = time.perf_counter()
        protocol.send_json(cli, req.to_json())
        img = protocol.assemble(protocol.recv_parts(cli), rh, rw)
        stats = protocol.recv_json(cli)
        dt = (time.perf_counter() - t0) * 1e3
        frames.append((pos, img))
        log(f"[server] frame {f}: {dt:.1f} ms at the client, server render "
            f"{stats['render_ms']:.1f} ms, encode {stats['encode_ms']:.1f} ms")
    protocol.send_json(cli, {"type": "finish", "finish": True})
    th.join(timeout=60)
    cli.close()
    if err:
        raise err[0]

    opts = _opts_from_gvals(gvals)
    for f, (pos, img) in enumerate(frames):
        cam = Camera.look_at(pos=tuple(map(float, pos)),
                             target=tuple(map(float, target)))
        ref = to_rgb8(render_frame(scene, cam, rw, rh, opts))
        if img.shape != ref.shape or not np.array_equal(img, ref):
            bad = np.mean(np.any(img != ref, axis=-1))
            raise AssertionError(f"served frame {f} differs from "
                                 f"render_frame on {bad:.2e} of pixels")
    log(f"[server] 4 frames of {rw}x{rh} equal render_frame's")


# ------------------------------------------------------------- multi-GPU
def phase_multi_gpu(scene, cam):
    from snail.parallel.mesh import (make_mesh, render_frame_sharded,
                                     train_step_sharded)

    n = len(jax.devices())
    one, many = make_mesh(1), make_mesh(n)
    ms = {}
    imgs = {}
    for name, mesh in (("1", one), (str(n), many)):
        fn = lambda: render_frame_sharded(scene, cam, W, H, OPTS, mesh)
        ms[name] = timed(fn, 10)
        imgs[name] = np.asarray(fn())
        log(f"[multi-gpu] render_frame_sharded on {name} card(s): "
            f"{summary(ms[name])}")
    diff = np.abs(imgs["1"] - imgs[str(n)]).max(-1)
    off = (diff > 1 / 255).mean()
    log(f"[multi-gpu] frame {n} cards vs 1: max |d| {diff.max():.3g}, "
        f"pixels off by >1/255: {off:.2e}")
    if not np.isfinite(imgs[str(n)]).all() or off > 1e-4:
        raise AssertionError(f"sharded frame differs on {off} of pixels")

    params = {"tri_a": scene.tri_a, "mat_diffuse": scene.mat_diffuse}
    target = _target(scene, cam, W, H)
    out = {}
    for name, mesh in (("1", one), (str(n), many)):
        step = jax.jit(lambda s, p, t, mesh=mesh: train_step_sharded(
            s, p, t, cam, W, H, OPTS, mesh, lr=1e-3)).lower(
                scene, params, target).compile()
        if name != "1":
            hlo = step.as_text()
            rays = W * H // n
            calls = [ln for ln in hlo.splitlines()
                     if "snail_closest_hit" in ln and "custom-call" in ln]
            if not calls or not all(f"f32[{rays}]" in ln for ln in calls):
                raise AssertionError(
                    f"traversal calls not on {rays} rays per card: "
                    + "\n".join(calls[:4]))
            log(f"[multi-gpu] compiled step: {len(calls)} closest-hit "
                f"custom calls, each on f32[{rays}] rays per card")
        ms_step = timed(lambda: step(scene, params, target), 3)
        out[name] = jax.tree.map(np.asarray, step(scene, params, target))
        log(f"[multi-gpu] train_step_sharded on {name} card(s): "
            f"loss {float(out[name][0]):.8g}; {summary(ms_step)}")
    (l1, p1), (ln, pn) = out["1"], out[str(n)]
    if not abs(l1 - ln) <= 1e-5 * max(1.0, abs(l1)):
        raise AssertionError(f"loss {l1} vs {ln}")
    for k in p1:
        np.testing.assert_allclose(pn[k], p1[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    log(f"[multi-gpu] step on {n} cards matches 1 card "
        f"(loss {l1:.8g} vs {ln:.8g})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi-gpu", action="store_true",
                    help="run only the four-card sharded render and step")
    args = ap.parse_args(argv)

    setup_compile_cache()
    from snail.scene.procedural import smoke_scene

    t0 = time.perf_counter()
    card = phase_device(4 if args.multi_gpu else 1)
    scene, cam = smoke_scene()
    log(f"[setup] terrain {scene.num_tris} tris, {scene.num_nodes} nodes, "
        f"depth {scene.depth}, leaf max {scene.leaf_max}: "
        f"{time.perf_counter() - t0:.1f} s")
    if args.multi_gpu:
        phase_multi_gpu(scene, cam)
    else:
        phase_forward(scene, cam, card)
        phase_traversal(scene, cam)
        phase_gradient(scene, cam)
        phase_server()
    log(f"[done] {time.perf_counter() - t0:.1f} s on {card}")
    print(json.dumps({"ok": True, "device": device_record()}), flush=True)


if __name__ == "__main__":
    main()
