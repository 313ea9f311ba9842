"""Render server: owns the local devices, serves frames to a TCP client.

Rebuild of the reference's server+node pair (server.cpp:192-429,
node.cpp:210-390). Where the reference splits the image into 16x64 parts
and round-robins them over MPI ranks (DivideImage server.cpp:178-190),
here XLA shards the frame over the local device mesh
(snail.parallel.mesh) and the server compresses finished 64x64 parts
with the native codec and streams them to the client — the quicklz tile
relay (server.cpp:389-401) without the MPI hop.

Run: ``python -m snail.apps.server [--port 20002] [--scene-dir DIR]``
"""

from __future__ import annotations

import argparse
import os
import queue
import socket
import threading
import time

import numpy as np

from ..core.types import Camera, Light, RenderOpts
from ..net import protocol
from ..net.codec import encode_tile
from ..render.renderer import render_frame, to_rgb8
from ..scene.scene import load_scene
from ..utils.device import setup_compile_cache
from ..utils.stats import TreeStats


def _opts_from_gvals(gvals: dict) -> RenderOpts:
    """gVals (rtbase.h:31, F-key toggles broadcast per frame,
    client.cpp:283-292) -> RenderOpts. Known slots follow the observed
    semantics in SURVEY.md §5: [2]=stats, [4]=no-shading distance view,
    [5]=reflections, [9]=supersampling."""
    return RenderOpts(
        stats=bool(gvals.get("2", gvals.get("stats", False))),
        shading=not gvals.get("4", gvals.get("no_shading", False)),
        reflections=bool(gvals.get("5", gvals.get("reflections", True))),
        supersample=bool(gvals.get("9", gvals.get("supersample", False))),
        shadows=bool(gvals.get("shadows", True)),
        transparency=bool(gvals.get("transparency", True)),
        textures=bool(gvals.get("textures", True)),
    )


def _split_parts(rgb8: np.ndarray):
    """Cut the frame into PART_W x PART_H tiles + encode (DivideImage,
    server.cpp:178-190; per-part headers compression.h:6-9)."""
    h, w, _ = rgb8.shape
    pw, ph = protocol.PART_W, protocol.PART_H
    for y in range(0, h, ph):
        for x in range(0, w, pw):
            tile = rgb8[y:y + ph, x:x + pw]
            cid, raw_len, payload = encode_tile(tile)
            yield x, y, tile.shape[1], tile.shape[0], cid, raw_len, payload


def serve_connection(conn: socket.socket, scene_dir: str,
                     cache_dir: str = "dump") -> None:
    """One client session: LoadNewModel handshake then the frame loop
    (server.cpp:217, 356-418)."""
    msg = protocol.recv_json(conn)
    if msg.get("type") != "load_model":
        protocol.send_json(conn, {"type": "error",
                                  "error": "expected load_model"})
        raise protocol.ProtocolError(f"bad handshake: {msg.get('type')!r}")
    # Scene names resolve strictly inside scene_dir: a client-supplied
    # absolute or ..-escaping path must not become an arbitrary file read.
    name = msg["name"]
    base = os.path.realpath(scene_dir)
    path = os.path.realpath(os.path.join(base, name))
    if not (path == base or path.startswith(base + os.sep)):
        protocol.send_json(conn, {"type": "error",
                                  "error": "scene outside scene_dir"})
        raise protocol.ProtocolError(f"scene path escape: {name!r}")
    resx, resy = int(msg["resx"]), int(msg["resy"])

    t0 = time.perf_counter()
    scene = load_scene(path, cache_dir=cache_dir,
                       flip_normals=msg.get("flip_normals", True))
    build_time = time.perf_counter() - t0
    protocol.send_json(conn, {"type": "model_ready",
                              "build_time": build_time,
                              "num_tris": int(scene.num_tris)})

    # Encode/send pipeline: a worker thread converts, compresses and
    # streams frame n's parts while the DEVICE renders frame n+1 — the
    # reference overlaps quicklz compression of finished tiles with the
    # rendering of later tiles the same way (render_spu.cpp:31-33,
    # readme_distributed.txt:20-22: "run 4 logical nodes per blade so
    # the PPU compresses while the SPUs render"). JAX dispatch is
    # asynchronous, so the main loop only LAUNCHES the render and hands
    # the device future to the worker; protocol order is preserved by
    # the single worker draining its queue in order.
    work_q: "queue.Queue" = queue.Queue(maxsize=2)

    def _encoder():
        while True:
            item = work_q.get()
            if item is None:
                return
            img, t0f, n_lights, build_time = item
            te0 = time.perf_counter()
            rgb8 = to_rgb8(img)  # blocks on the device future
            render_ms = (time.perf_counter() - t0f) * 1e3
            protocol.send_parts(conn, _split_parts(rgb8))
            encode_ms = (time.perf_counter() - te0) * 1e3
            # the traversal keeps no work counters yet: only the ray count
            # is known, and the reply says the counters were not measured
            stats = TreeStats(rays=resx * resy * (1 + n_lights))
            protocol.send_json(conn, {
                "type": "stats", "render_ms": render_ms,
                "encode_ms": encode_ms, "pipelined": True,
                "measured": False,
                "build_ms": build_time * 1e3, **stats.to_dict(),
            })

    enc = threading.Thread(target=_encoder, daemon=True)
    enc.start()
    try:
        _frame_loop(conn, scene, resx, resy, build_time, work_q)
    finally:
        work_q.put(None)
        enc.join(timeout=10)


def _frame_loop(conn, scene, resx, resy, build_time, work_q):
    while True:
        req = protocol.recv_json(conn)
        if req.get("finish") or req["type"] == "finish":
            break
        cam = Camera.look_at(pos=tuple(req["cam_pos"]),
                             target=tuple(req["cam_target"]))
        lights = req.get("lights") or []
        if lights:
            scene = scene.with_lights(Light.stack(
                [Light.make(tuple(l["pos"]), tuple(l["color"]),
                            float(l["radius"])) for l in lights]))
        opts = _opts_from_gvals(req.get("gvals", {}))

        t0 = time.perf_counter()
        img = render_frame(scene, cam, resx, resy, opts)
        # hand the (async) device result to the encoder worker and go
        # straight back to recv — frame n's encode overlaps frame n+1's
        # device render
        work_q.put((img, t0, len(lights), build_time))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="snail render server")
    ap.add_argument("--port", type=int, default=protocol.DEFAULT_PORT)
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address (loopback by default; pass 0.0.0.0 "
                         "explicitly to expose the unauthenticated server)")
    ap.add_argument("--scene-dir", default="scenes")
    ap.add_argument("--cache-dir", default="dump")
    ap.add_argument("--once", action="store_true",
                    help="serve one connection then exit (tests)")
    args = ap.parse_args(argv)
    setup_compile_cache()

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((args.host, args.port))
    srv.listen(1)
    print(f"[server] listening on :{args.port}", flush=True)
    while True:  # survive client disconnects (server.cpp:210 outer loop)
        conn, addr = srv.accept()
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        print(f"[server] client {addr}", flush=True)
        try:
            serve_connection(conn, args.scene_dir, args.cache_dir)
        except (ConnectionError, BrokenPipeError) as e:
            print(f"[server] client dropped: {e}", flush=True)
        finally:
            conn.close()
        if args.once:
            break
    srv.close()


if __name__ == "__main__":
    main()
