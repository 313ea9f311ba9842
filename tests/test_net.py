"""Network layer: native codec roundtrips + loopback render service
(reference extern/quicklz + compression.cpp; server.cpp/client.cpp
frame protocol — SURVEY.md §2.5)."""

import socket
import threading

import numpy as np
import pytest

from snail.net import codec, protocol


def test_rgb_delta_roundtrip(rng):
    img = rng.integers(0, 256, (16, 24, 3)).astype(np.uint8)
    planar = codec.rgb_delta(img)
    back = codec.rgb_undelta(planar, 16, 24)
    np.testing.assert_array_equal(back, img)


def test_compress_roundtrip_compressible():
    data = (b"snailsnailsnail" * 500) + bytes(range(256)) * 4
    cid, payload = codec.compress(data)
    assert codec.decompress(cid, payload, len(data)) == data
    if codec.native_available():
        assert cid == codec.CODEC_LZ
        assert len(payload) < len(data)


def test_compress_roundtrip_random(rng):
    data = rng.integers(0, 256, 10_000).astype(np.uint8).tobytes()
    cid, payload = codec.compress(data)  # incompressible -> raw ok
    assert codec.decompress(cid, payload, len(data)) == data


def test_native_codec_builds():
    """The C++ LZSS must actually compile and load in this image."""
    assert codec.native_available()


def test_tile_roundtrip(rng):
    tile = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    tile[10:40, 10:40] = 128  # a compressible flat region
    cid, raw_len, payload = codec.encode_tile(tile)
    out = codec.decode_tile(cid, raw_len, payload, 64, 64)
    np.testing.assert_array_equal(out, tile)


def test_parts_stream_roundtrip(rng):
    a, b = socket.socketpair()
    tiles = []
    parts = []
    for i, (x, y) in enumerate([(0, 0), (64, 0), (0, 64)]):
        t = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
        tiles.append((x, y, t))
        cid, raw_len, payload = codec.encode_tile(t)
        parts.append((x, y, 64, 64, cid, raw_len, payload))

    def sender():
        protocol.send_parts(a, parts)
        a.close()

    th = threading.Thread(target=sender)
    th.start()
    img = protocol.assemble(protocol.recv_parts(b), 128, 128)
    th.join()
    b.close()
    for (x, y, t) in tiles:
        np.testing.assert_array_equal(img[y:y + 64, x:x + 64], t)


def test_loopback_render_service(scene_dir, box_path):
    """Full client/server session over a socketpair: LoadNewModel
    handshake, two frames, stats trailer — then compare the streamed
    frame against a direct local render (the compare_img pattern)."""
    from snail.apps.server import serve_connection
    from snail.core.types import Camera, Light, RenderOpts
    from snail.render.renderer import render_frame, to_rgb8
    from snail.scene.scene import load_scene

    srv_sock, cli_sock = socket.socketpair()
    err = []

    def server():
        try:
            serve_connection(srv_sock, str(scene_dir), cache_dir=None)
        except Exception as e:  # surface server-side failures
            err.append(e)
        finally:
            srv_sock.close()

    th = threading.Thread(target=server)
    th.start()

    protocol.send_json(cli_sock,
                       protocol.LoadModel("box.obj", 64, 64).to_json())
    ready = protocol.recv_json(cli_sock)
    assert ready["type"] == "model_ready" and ready["num_tris"] > 0

    light = {"pos": [0.0, 8.0, 0.0], "color": [1, 1, 1], "radius": 40.0}
    req = protocol.FrameRequest(
        cam_pos=(3.0, 2.5, 4.0), cam_target=(0.0, 0.0, 0.0),
        lights=[light],
        gvals={"reflections": False, "transparency": False,
               "textures": False},
    )
    protocol.send_json(cli_sock, req.to_json())
    parts = list(protocol.recv_parts(cli_sock))
    stats = protocol.recv_json(cli_sock)
    assert stats["type"] == "stats" and stats["render_ms"] > 0
    img = protocol.assemble(parts, 64, 64)

    protocol.send_json(cli_sock, {"type": "finish", "finish": True})
    th.join()
    cli_sock.close()
    assert not err, err

    scene = load_scene(
        box_path, cache_dir=None,
        lights=Light.make((0.0, 8.0, 0.0), (1, 1, 1), 40.0),
    )
    cam = Camera.look_at(pos=(3.0, 2.5, 4.0), target=(0.0, 0.0, 0.0))
    ref = to_rgb8(render_frame(
        scene, cam, 64, 64,
        RenderOpts(reflections=False, transparency=False, textures=False),
    ))
    # u8 equality modulo rounding (compare_img mean check + stronger)
    assert np.mean(np.abs(img.astype(int) - ref.astype(int))) < 1.0


def test_loopback_measured_stats(scene_dir):
    """gVals[2] (stats toggle): the traversal keeps no work counters, so
    the server must say so (measured: false) and report only the ray
    count it knows — no fabricated TreeStats on the wire."""
    from snail.apps.server import serve_connection

    srv_sock, cli_sock = socket.socketpair()
    err = []

    def server():
        try:
            serve_connection(srv_sock, str(scene_dir), cache_dir=None)
        except Exception as e:
            err.append(e)
        finally:
            srv_sock.close()

    th = threading.Thread(target=server)
    th.start()

    protocol.send_json(cli_sock,
                       protocol.LoadModel("box.obj", 64, 64).to_json())
    ready = protocol.recv_json(cli_sock)
    assert ready["type"] == "model_ready"

    light = {"pos": [0.0, 8.0, 0.0], "color": [1, 1, 1], "radius": 40.0}
    req = protocol.FrameRequest(
        cam_pos=(3.0, 2.5, 4.0), cam_target=(0.0, 0.0, 0.0),
        lights=[light],
        gvals={"2": True, "reflections": False, "transparency": False,
               "textures": False},
    )
    protocol.send_json(cli_sock, req.to_json())
    list(protocol.recv_parts(cli_sock))
    stats = protocol.recv_json(cli_sock)
    protocol.send_json(cli_sock, {"type": "finish", "finish": True})
    th.join()
    cli_sock.close()
    assert not err, err

    assert stats["measured"] is False
    assert stats["rays"] == 64 * 64 * 2  # primary + one shadow per pixel
    assert stats["loop_iters"] == 0 and stats["intersects"] == 0
