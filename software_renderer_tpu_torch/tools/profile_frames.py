"""Device time and kernel launches of the main path, and the times of the
front-end and the windowed sampler, for the package of a given tree.

    python software_renderer_tpu_torch/tools/profile_frames.py [--root DIR]

Imports ``software_renderer_tpu_torch`` from DIR (default: the tree that
holds this file), so that one script measures two versions of the
package in one call, in turns: for example the parent commit unpacked
with ``git archive`` into a git-ignored directory, then this tree.

At config 4's full size (1920x1080, 99,936 triangles) it reports:

* for chip_smoke.py's 8 main-path frames under ``SR_TEX_WINDOWED`` "0"
  and "1": device ms, device kernels, and copies and memsets per frame
  (one torch.profiler run of the 8 frames after a warm-up frame), and
  each frame's wall ms (CUDA events around render(), with a synchronize
  after each frame);
* by CUDA-graph replay at frame 0: the front-end kernel alone (its 24
  rows) and the windowed sampler K7 on its inputs (on planar tables where
  that tree's sampler takes them);
* device ms and kernels (one profiled call after a warm-up) of the
  front-end with the stream table as the main path builds it, from the
  corner columns to the setup and the table (in a tree without
  ``planar_front_table``: the kernel, then the planes and the table from
  torch ops), and of the mode-"1" texture tail
  (``sample_texture_planes_compacted``).

Prints each result as it is measured, then the card line and one JSON
line. Runs on the card only.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

MAIN_FRAMES = (0, 100, 120, 240, 300, 400, 600, 700)
REPS = 50
# The render path's pair budget for culled scenes (render.py).
BUDGET = 0.85


def _profile(torch, fn):
    """(device ms, kernels, copies and memsets) of one profiled ``fn()``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
                 for e in evts)
    copies = sum(e.count for e in evts
                 if e.key.startswith(("Memcpy", "Memset")))
    return dev_us / 1e3, sum(e.count for e in evts) - copies, copies


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[2],
                    help="the tree whose package is measured")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_frames: no CUDA device")
    import software_renderer_tpu_torch as pkg
    from software_renderer_tpu_torch import render
    from software_renderer_tpu_torch.models import scenes
    from software_renderer_tpu_torch.ops import binning as tb
    from software_renderer_tpu_torch.ops import frontend as fe
    from software_renderer_tpu_torch.ops import texture as ttex
    from software_renderer_tpu_torch.ops import texture_kernel as ttk
    from software_renderer_tpu_torch.ops import transforms as tf
    from software_renderer_tpu_torch.ops.frontend_kernel import fe_kernel
    from software_renderer_tpu_torch.render import triangle_inputs
    from software_renderer_tpu_torch.tools.probe_dyngather import graph_ms

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rp = scenes.config4_many_objects(0.0, device=dev)
    w, h = rp.width, rp.height
    axis = tf.normalize(torch.tensor([1.0, 1.0, 0.0], device=dev))
    passes = [dataclasses.replace(rp, transform=rp.transform @ tf.
                                  rotation_matrix(tf.quat_from_axis_angle(
                                      axis, torch.tensor(i / 60.0,
                                                         device=dev))))
              for i in MAIN_FRAMES]
    res = {"card": card, "package": str(Path(pkg.__file__).parent),
           "frames": list(MAIN_FRAMES), "modes": {}}
    _profile(torch, lambda: None)  # the profiler's slow first start
    for mode in ("0", "1"):
        ttex.TEX_WINDOWED = mode
        render(passes[0])
        torch.cuda.synchronize()
        wall = []
        for p in passes:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            render(p)
            end.record()
            torch.cuda.synchronize()
            wall.append(start.elapsed_time(end))
        ms, kernels, copies = _profile(torch, lambda: [render(p)
                                                       for p in passes])
        n = len(passes)
        res["modes"][mode] = dict(device_ms_per_frame=ms / n,
                                  kernels_per_frame=kernels / n,
                                  copies_per_frame=copies / n,
                                  wall_ms=wall, wall_ms_mean=sum(wall) / n)
        print(f"SR_TEX_WINDOWED={mode}: {json.dumps(res['modes'][mode])}",
              flush=True)

    ps, chans, attrs, prm, lit, textured = triangle_inputs(rp)
    cc = fe.corner_cols(rp.mesh.positions[rp.mesh.triangles().long()])
    cols = torch.stack([c for corner in cc for c in corner]).contiguous()
    m16 = rp.transform.reshape(16).contiguous()
    if hasattr(fe, "planar_front_table"):
        def front():
            return fe.planar_front_table(cc, rp.transform, attrs, w, h,
                                         cull_backfaces=True)
    else:
        def front():
            ps_ = fe.planar_front(cc, rp.transform, w, h,
                                  cull_backfaces=True)
            return fe.stream_table_planar(ps_, fe.attribute_plane_cols(
                ps_, attrs))
    res["fe_rows_ms"] = graph_ms(lambda: fe_kernel(
        cols, m16, w, h, cull_backfaces=True), REPS)
    front()
    res["front_end_with_table"] = dict(zip(
        ("device_ms", "kernels", "copies"), _profile(torch, front)))
    print(f"front-end rows {res['fe_rows_ms']} ms; with the table "
          f"{json.dumps(res['front_end_with_table'])}", flush=True)

    _, ids, out = tb.fused_pipeline(ps, attrs, prm, width=w, height=h,
                                    chans=chans, has_light=lit,
                                    has_texture=textured,
                                    pair_budget_factor=BUDGET)
    tex, u, v, covered = rp.texture, out[-2], out[-1], ids != -1
    th, tw, c = tex.data.shape
    ns = h * w // ttk.LANES
    prep = ttk.windowed_prep(u.reshape(ns, -1), v.reshape(ns, -1),
                             covered.reshape(ns, -1), th=th, tw=tw,
                             wrap=tex.wrap)
    geo = dict(th=th, tw=tw, wrap=tex.wrap)
    if hasattr(ttk, "windowed_texels"):
        texels = ttk.windowed_texels(tex.data, tex.wrap)
        sampler = lambda: ttk.sampler_kernel(texels, *prep, c=c, **geo)
    else:
        tabs = ttk.windowed_tables(tex.data, tex.wrap)
        sampler = lambda: ttk.sampler_kernel(tabs, *prep, **geo)
    res["sampler_ms"] = graph_ms(sampler, REPS)
    print(f"K7 {res['sampler_ms']} ms", flush=True)
    ttex.TEX_WINDOWED = "1"
    tail = lambda: ttex.sample_texture_planes_compacted(tex, u, v, covered)
    tail()
    res["texture_tail_mode1"] = dict(zip(
        ("device_ms", "kernels", "copies"), _profile(torch, tail)))
    res["segments"] = dict(total=ns, with_window=int((prep[5] > 0).sum()))
    print(card, flush=True)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
