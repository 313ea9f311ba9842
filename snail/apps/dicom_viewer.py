"""DICOM volume viewer CLI — rebuild of src/dicom_viewer.cpp (288 LoC):
loads a DICOM slice directory (or raw u16 volume), builds the min/max
brick structure and renders iso/MIP views to PNG.

Run: ``python -m snail.apps.dicom_viewer DIR --mode iso --iso 0.05``
"""

from __future__ import annotations

import argparse

import numpy as np

from ..core.types import Camera
from ..utils.image import save_image
from ..volume import build_vtree, load_dicom_dir, load_raw, render_volume


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="snail DICOM viewer")
    ap.add_argument("path", help="DICOM directory or .raw file")
    ap.add_argument("--raw-shape", default=None,
                    help="D,H,W when loading a raw u16 volume")
    ap.add_argument("--res", default="512x512")
    ap.add_argument("--mode", choices=("iso", "mip"), default="iso")
    ap.add_argument("--iso", type=float, default=0.05)
    ap.add_argument("--out", default="/tmp/dicom_view.png")
    args = ap.parse_args(argv)

    if args.raw_shape:
        shape = tuple(map(int, args.raw_shape.split(",")))
        vd = load_raw(args.path, shape)
    else:
        vd = load_dicom_dir(args.path)
    print(f"[dicom] volume {vd.shape} spacing {vd.spacing}", flush=True)

    vt = build_vtree(vd)
    d, h, w = vd.shape
    center = np.array([w, h, d], np.float64) * 0.5  # camera is xyz
    pos = center + np.array([0.9, 0.35, 0.45]) * max(d, h, w) * 1.6
    cam = Camera.look_at(pos=tuple(pos), target=tuple(center))
    resx, resy = map(int, args.res.split("x"))
    img = np.asarray(render_volume(vt, cam, resx, resy, iso=args.iso,
                                   mode=args.mode))
    save_image(args.out, img)
    print(f"[dicom] wrote {args.out} (mean {img.mean():.4f})", flush=True)


if __name__ == "__main__":
    main()
