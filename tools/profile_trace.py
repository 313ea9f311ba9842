"""Per-operation device time of the benchmark frame, from a JAX profiler
trace on the GPU.

    python tools/profile_trace.py [out_dir]    # default build/trace

Renders the smoke scene (scene/procedural.py) at 1024x1024 with shadows
and reflections, traces 4 frames after a warm-up, and prints the device
time of each operation per frame, largest first, with the device's busy
share of the traced window.
"""

import glob
import gzip
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import jax

    from snail.core.types import RenderOpts
    from snail.render.renderer import render_frame
    from snail.scene.procedural import smoke_scene
    from snail.utils.device import (gpu_name_and_power, require_gpu,
                                    setup_compile_cache)

    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        "build", "trace")
    setup_compile_cache()
    require_gpu()
    print("#", gpu_name_and_power())
    frames, w, h = 4, 1024, 1024
    scene, cam = smoke_scene()
    opts = RenderOpts(shadows=True, reflections=True, transparency=False,
                      textures=False)
    render_frame(scene, cam, w, h, opts).block_until_ready()

    with jax.profiler.trace(out, create_perfetto_trace=True):
        for _ in range(frames):
            img = render_frame(scene, cam, w, h, opts)
        img.block_until_ready()

    path = max(glob.glob(os.path.join(out, "**", "*.trace.json.gz"),
                         recursive=True), key=os.path.getmtime)
    with gzip.open(path, "rt") as f:
        tr = json.load(f)
    # device tracks are the processes whose name mentions the GPU
    pids = {ev["pid"] for ev in tr.get("traceEvents", [])
            if ev.get("ph") == "M" and ev.get("name") == "process_name"
            and "/device:GPU" in ev.get("args", {}).get("name", "")}
    durs, spans = {}, []
    for ev in tr.get("traceEvents", []):
        if ev.get("ph") != "X" or ev.get("pid") not in pids:
            continue
        name = ev.get("name", "?")
        durs.setdefault(name, [0.0, 0])
        durs[name][0] += ev["dur"] / 1e3
        durs[name][1] += 1
        spans.append((ev["ts"], ev["ts"] + ev["dur"]))
    spans.sort()
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    print(f"device busy {busy / 1e3 / frames:.3f} ms/frame of a "
          f"{window / 1e3 / frames:.3f} ms/frame window "
          f"({busy / max(window, 1e-9):.3f} busy)")
    total = sum(v[0] for v in durs.values())
    for name, (ms, n) in sorted(durs.items(), key=lambda kv: -kv[1][0])[:30]:
        print(f"{ms / frames:9.4f} ms/frame {ms / total:6.1%} "
              f"x{n // frames:4d}  {name[:100]}")


if __name__ == "__main__":
    main()
