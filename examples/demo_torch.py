#!/usr/bin/env python
"""Demo driver of the PyTorch port: render any built-in scene to PNG
frames, or present them live, through FrameLoop.

  python examples/demo_torch.py --scene reference_sphere --frames 8 --out out/
  python examples/demo_torch.py --scene config4 --width 1920 --height 1080
  python examples/demo_torch.py --scene config4 --frames 600 --serve
  python examples/demo_torch.py --list

Runs on the card; ``--device cpu`` runs the kernels' plain versions on
the CPU instead.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from software_renderer_tpu_torch.models import scenes  # noqa: E402
from software_renderer_tpu_torch.utils.config import RenderConfig  # noqa: E402
from software_renderer_tpu_torch.utils.display import FrameLoop  # noqa: E402

SCENES = {
    "reference_sphere": scenes.reference_sphere,
    "rotating_triangle": scenes.rotating_triangle,
    "wireframe_cube": scenes.wireframe_cube,
    "intersecting_triangles": scenes.intersecting_triangles,
    "config1": scenes.config1_flat_cube,
    "config2": scenes.config2_textured_cube,
    "config3": scenes.config3_phong_mesh,
    "config4": scenes.config4_many_objects,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="reference_sphere",
                    choices=sorted(SCENES))
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--out", default="out/demo")
    ap.add_argument("--serve", action="store_true",
                    help="present live at http://127.0.0.1:PORT/ instead "
                         "of writing PNGs")
    ap.add_argument("--port", type=int, default=0,
                    help="--serve port (0 = pick a free one)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args()
    if args.list:
        print("\n".join(sorted(SCENES)))
        return

    builder = SCENES[args.scene]

    def scene_fn(t):
        kw = {"device": args.device}
        if args.width:
            kw["width"] = args.width
        if args.height:
            kw["height"] = args.height
        return builder(t, **kw)

    rp0 = scene_fn(0.0)
    config = RenderConfig(width=rp0.width, height=rp0.height,
                          backend=args.backend, scene=args.scene)

    def transform_fn(t):
        return scene_fn(t).transform

    loop = FrameLoop(scene_fn, transform_fn=transform_fn, config=config)
    if args.serve:
        from software_renderer_tpu_torch.utils.present import PresentServer
        with PresentServer(port=args.port) as srv:
            fps = loop.run(args.frames, present=srv)
            print(f"{args.scene}: {args.frames} frames presented at "
                  f"{srv.url} ({fps:.1f} FPS incl. encode)")
    else:
        fps = loop.run(args.frames, out_dir=args.out)
        print(f"{args.scene}: {args.frames} frames -> {args.out} "
              f"({fps:.1f} FPS incl. encode)")


if __name__ == "__main__":
    main()
