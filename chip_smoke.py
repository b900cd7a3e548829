#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (software_renderer_tpu_torch) on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each ending in torch.cuda.synchronize(); any failure raises and
the script exits non-zero without printing a result:

1. the card's name and power limit (nvidia-smi);
2. build every kernel of the render path from csrc/ (nvcc, at first use);
3. each kernel against its plain PyTorch version on the same CUDA inputs
   at config-4 shapes (1920x1080, ~100k triangles): coverage, triangle id
   and depth bit-equal, the front-end's rows and stream table bit-equal,
   shaded planes within PLANE_TOL; each kernel's time by CUDA-graph replay
   (and of back-to-back calls), the plain version's by CUDA events; the
   texture tail kernel against finish_fused bit for bit, on config 4's
   frame 0 at 1920x1080 textured and at 3840x2160 untextured, both timed
   by graph replay, with the launches of two frames through render();
4. a forced spill (config 2 at 512x512 with kmax=1): the overflow kernels
   and the seeded fused kernel launch, and the frame equals the spill-free
   one;
5. the main path: launch counters reset, then 8 frames of the config-4
   animation (bench.py's transform; frames 120, 240 and 600 spill, so the
   overflow kernels run on the path too) through render(); counters,
   coverage, finiteness and ms/frame from CUDA events; device ms and
   device kernels per frame from a profile of the same frames;
6. the same small scene rendered on the card and on the CPU (plain
   versions) with the auto, reference and pallas backends: alpha and
   depth bit-equal, color within 1e-3;
7. the other backends at config 4's full size on the frames that spill
   (0, 120, 240, 600): render(backend="pallas"), render(backend="binned"),
   flat shading (binned_pipeline without attributes) and
   binned_pipeline(ps, attrs), each with the counters reset just before
   it and read just after; ms/frame of each (CUDA events; device
   ms/frame from a profile); (depth, id) bit-equal across
   the record walk (K3'), the binned pass (K5, K3 on spills) and the fused
   path (K2); on the frame with the most spills, binned_pipeline's
   G-buffer bit-equal to K6's planes with the plain K4 applied on the
   inputs of the pipeline's own K4 call, and K4 timed on them in place
   against the out-of-place form;
8. the texture tail's routes: the 8 main-path frames through render()
   under SR_TEX_WINDOWED "0", "1" and "adaptive" (counters reset per
   mode); in "1" the windowed sampler (K7) launches once per frame and
   every frame equals mode "0"'s in alpha and depth bit for bit; a
   profile of each mode's 8 frames splits device (kernel) time from host
   time;
9. texture training at full size: config 4 at 1920x1080, 4 frames of the
   animation, targets from render_batch with the true texture, 5 steps of
   texture_train_step from a flat 0.5 texture in modes "0" and "1"; the
   loss falls at every step, K7 launches 4 times a step in "1", and the
   two modes' first steps agree;
10. the gather probe (K8) through its entry point, with the counters
   reset just before it;
11. the camera path at full size: config 4 (99,936 triangles, 1920x1080)
   under a perspective camera inside the object cloud
   (``scenes.config4_camera``) at t = 0, 0.5, 1, 1.5, 2 s, each frame with
   over 1,000 triangles across the eye plane, through render() with (a)
   clip_near + perspective_correct on ``auto`` in SR_TEX_WINDOWED "0"
   and "1", (b) perspective_correct alone (K1's perspective flag), (c)
   clip + perspective on ``pallas``, (d) clip + flat shading (K5), each
   with the counters reset just before it and read just after; per frame
   the straddling and clipped triangles, the bins' pairs and spills; per
   path ms/frame (CUDA events) and device ms and kernels per frame (a
   profile); (depth, id) bit-equal across K2 and K3' on every frame,
   every color finite, and the case-0 no-op: config 4's own frame
   (every corner in front) with and without the clip bit for bit;
12. the rest of the public surface at config 4's full width, each path
   with the counters reset just before it and read just after (K1 and K2
   must launch on each triangle path): (a) the 8 main-path frames with a
   trilinear texture on auto (alpha and depth equal to the bilinear
   frames', colors finite) and frame 0 on pallas, card vs CPU at phase
   6's size, the trilinear tail's device time against mode "0"'s; (b)
   render_rows of frames 0 and 120 in four 270-row bands and rows
   [37, 240) on auto and pallas, frame 0 flat (K5): alpha and ids equal
   the full frame's, depth and color in the JAX package's tie class, and
   whether bit for bit; (c) render_msaa x2 (3840x2160 inside) of frames
   0 and 120: depth the 2x2 min and color the box of the 4K frame, card
   vs CPU at small size; (d) the wireframe cube at 8 times, config 4's
   first 16,384 indices as lines and its 299,808 vertices as points, card
   frames equal to the CPU's bit for bit; (e) every pixel format, resize
   to 1280x720 and 3840x2160 and the 2D primitives, card vs CPU;
13. the host surface at config 4's full width, each part with the
   counters reset just before it and read just after (K1 and K2 must
   launch on each): (a) FrameLoop over 16 frames of bench.py's animation
   with the PNG sink (native runtime, which must have built), the live
   viewer (PresentServer on 127.0.0.1, its /frame.png fetched over HTTP)
   and no sink, each decoded frame equal to to_rgba8 of the card frame
   bit for bit, FPS and ms/frame of each, and one frame's PNG encode
   native vs Python; (b) render_batch_chunked of 16 frames (vmap_chunk
   4) equal to render_batch bit for bit, with the peak memory of each;
   (c) render_sharded of the 8 main-path frames on make_mesh(2, 4) of
   the one card with the split front-end on and off and on
   make_mesh(1, 1): alpha and ids equal to render_batch's, depth and
   color in the tie class (and whether bit for bit), the gathered
   front-end and stream table equal to the unsplit K1 launch's bit for
   bit, ms/frame of each;
   (d) one texture_train_step in mode "1" on make_mesh(2, 2) against
   mesh=None (loss within rel 1e-5, texels within 1e-5); (e) config 3
   from the teapot generator at 1024x1024, card vs CPU at phase 6's
   size; (f) profiling.trace around two main-path frames, the Chrome
   trace holding the program's spans (sr.render and its layers) and
   K2's launches; (g) bench_frame of
   the main path (20 iterations) beside phase 5's ms/frame;
14. the compiled frame, config 4 at 1920x1080: (a) host syncs per frame
   of the eager routes under torch.cuda.set_sync_debug_mode (counted in
   "warn" mode, then run again in "error" mode): the main path's 8
   frames in modes "0" and "1", flat shading and binned_pipeline with
   attributes, the camera path (clip + perspective) in both modes,
   render_rows bands and render_sharded; 0 on each, and at most the one
   predicate read of
   "adaptive"; (b) render_batch of the 8 main-path frames, captured on
   frame 0 and replayed on the rest (spill frames 120, 240 and 600
   included), in modes "0" and "1": alpha, depth and color bit-equal to
   the eager frames and the launch counters equal to theirs; the main
   path's geometry captured on frame 0 and replayed: ids, depth and
   planes bit-equal; (c) FrameLoop with a transform_fn and render_batch
   of camera frames replay bit for bit; (d) the eager route (the
   "adaptive" sampler, a texture that requires grad) counted; (e)
   ms/frame eager against replayed (CUDA events and the host clock, in
   turns) with device ms and kernels per frame of each (profiled), in
   modes "0" and "1"; (f) the peak memory of render_batch with the graph
   against the same 16 frames rendered eagerly.

Phase 3 runs K2, K3 and K4 as the main path calls them: K2 seeded with
the frame's overflow count, which must equal the static walk bit for
bit and read no seed at a count of 0 (timed against the static launch
in turns), K3 and K4 over the static overflow list with the device
count (K3 equal to its run over the compact list, and both returning
their seeds at a count of 0). It also holds K1 with its perspective
flag and K2's perspective plan (static, and seeded from K3 and K4 at 9
channels on the camera frame's own spills) against their plain versions
at the camera path's t = 0 shapes, with their times and bounds. It
holds K3' on large triangles (config 2's cube at 1920x1080) against its
plain version, K7 (at config-4 frame-0 shapes, against its
plain version and the quad-table sampler) and K8 (at the probe's shapes)
with their times, bounds and library times; it times the seeded K2 on the
kmax=1 spill set, prints the records per bin of K2's and K5's inputs
(p50, p99, max), and prints the redesigned kernels' times beside their
previous design's (EARLIER_MS).

Each kernel's bound is the larger of the bytes it must move over the
card's memory rate and the float32 operations this run's data needs over
the card's float32 rate (NVIDIA's H100 SXM data sheet, at 700 W); its
least time (``least_ms``) also counts the launch floor, a one-element
torch add by CUDA-graph replay measured before phase 3 builds any
kernel's inputs. K4's bound counts what the function moves: every
pixel's id, and per live winner its slot and its plane writes, and the
winning rows' planes; at a count of 0 it moves nothing, so its least
time is the launch floor. Phase 3 times K4 on the kmax=1 spill, at a
count of 0 and at 9 channels on the camera spill; phase 7 holds
binned_pipeline's G-buffer against K6's planes with the plain K4 applied
on the inputs of the pipeline's own K4 call, and times K4 on them in
place against the out-of-place form. The last lines are the card line, one JSON line describing the
kernels, and {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import urllib.request
import warnings

import numpy as np
import torch

from software_renderer_tpu_torch import (PIXEL_FORMATS, _cuda,
                                         decode_pixels, encode_pixels,
                                         render, render_msaa, render_rows,
                                         runtime, to_rgba8)
from software_renderer_tpu_torch.models import scenes
from software_renderer_tpu_torch.models.mesh import Mesh
from software_renderer_tpu_torch.ops import primitives2d as p2
from software_renderer_tpu_torch.ops.msaa import downsample_box
from software_renderer_tpu_torch.ops.resize import (resize_bilinear,
                                                    resize_nearest)
from software_renderer_tpu_torch.ops import binning as tb
from software_renderer_tpu_torch.ops import clip as tclip
from software_renderer_tpu_torch.ops import frontend as fe
from software_renderer_tpu_torch.ops import texture as ttex
from software_renderer_tpu_torch.ops import texture_kernel as ttk
from software_renderer_tpu_torch.ops import transforms as tf
from software_renderer_tpu_torch.ops.frontend_kernel import (
    fe_kernel, fe_plain, fe_table_kernel, fe_table_plain)
from software_renderer_tpu_torch.ops.rasterize_kernel import (
    _poison_row, visibility_kernel, visibility_merge_kernel,
    visibility_merge_plain, visibility_pallas, visibility_plain)
from software_renderer_tpu_torch.ops import shading as tsh
from software_renderer_tpu_torch.ops.shading import fused_output_channels
from software_renderer_tpu_torch.parallel import frame_graph as fg
from software_renderer_tpu_torch.parallel.batch import (render_batch,
                                                       render_batch_chunked)
from software_renderer_tpu_torch.parallel.sharding import (
    make_mesh, render_sharded, sharded_front, texture_train_step)
from software_renderer_tpu_torch.render import (_pad_cols, clip_inputs,
                                               planar_front_of,
                                               planar_front_table_of,
                                               shading_inputs,
                                               triangle_inputs)
from software_renderer_tpu_torch.tools import probe_dyngather as probe
from software_renderer_tpu_torch.tools.probe_dyngather import graph_ms
from software_renderer_tpu_torch.tools.sweep_binned import percentiles
from software_renderer_tpu_torch.utils import image_io, profiling
from software_renderer_tpu_torch.utils.config import RenderConfig
from software_renderer_tpu_torch.utils.display import FrameLoop
from software_renderer_tpu_torch.utils.present import PresentServer
from software_renderer_tpu_torch.utils.timing import bench_frame

# Shaded planes (kernel vs plain on the same card): both round every
# operation the same way; only powf may differ from torch.pow by an ulp
# or two, amplified at most by the color range 0..1.
PLANE_TOL = 1e-5
MAIN_FRAMES = (0, 100, 120, 240, 300, 400, 600, 700)
BACKEND_FRAMES = (0, 120, 240, 600)
TRAIN_FRAMES = (0, 100, 120, 240)
TRAIN_STEPS = 5
# Training step size at 1080p: the loss is a mean over B*H*W*4 entries,
# so a texel's gradient is of order 1e-7; this moves texels by a few
# hundredths per step, far below the step that would overshoot.
TRAIN_LR = 1e5
# The two modes' first-step textures differ only by the gradient's
# index-add order (atomics), scaled by TRAIN_LR.
TRAIN_TOL = 1e-5
# grid_sample against K7 on the clamp variant: both compute clamp-to-edge
# bilinear at x = u * tw - 0.5; grid_sample rounds its coordinate another
# way (((2u - 1) + 1) * tw - 1) / 2.
LIBRARY_TOL = 1e-5
# The render path's pair budget for culled scenes (render.py).
BUDGET = 0.85
# Times (ms) of the previous design of the kernels that were redesigned
# for this card, as PERF.md section 6 records them (NVIDIA H100 80GB
# HBM3, 700.00 W): the record walk that staged every record for each
# 16x16 block (K3 on the overflow set, K3' on every record), the window
# lookup that staged an [8, 256] window per segment (K8), the bin walk
# that tested every record of a bin on every pixel of its slab (K2 static,
# K5), the front-end that wrote the 24 rows alone, one 256-thread block
# per 256 triangles (K1, by graph replay, tools/profile_frames.py), and
# the sampler that ran one thread per lane on planar tables (K7), and the
# overflow resolve that binary-searched each pixel's id among the rows'
# ids on a grid of one thread per pixel (K4: the kmax=1 spill, a count of
# 0, the camera spill at 9 channels). Printed beside this run's times in
# phase 3, never in the kernels line; K1's earlier_ms is the previous
# design's whole front-end as this run times it (the rows, then the torch
# planes and stream table).
EARLIER_MS = {"visibility_merge": 10.59, "visibility": 69.68,
              "window_lookup": 0.0175, "fused": 0.460, "binned_vis": 0.818,
              "fe": 0.00593, "sampler": 0.0241, "resolve_merge": 0.0142,
              "resolve_merge_count0": 0.0061, "resolve_merge_camera": 0.0104}

# Peak rates of one H100 SXM (NVIDIA's data sheet, 700 W): float32
# outside the tensor cores, and HBM3.
F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
# Float32 operations per (pixel, record) test: two edge functions and the
# depth plane (2 mul + 2 add each), e2 (2 sub), three edge compares and
# the depth compare; the record walks' bbox clamp adds 4 compares and
# 2 adds.
OPS_TEST = 18
OPS_TEST_CLAMPED = 24
# Per pixel, beyond 4 per attribute plane: the fused epilogue's lighting
# (normalise, two dots, pow, combine), counted from fused.cu.
OPS_EPILOGUE = 40
# Per triangle in the front-end: corner transform and divide, screen
# mapping, edges, depth plane, bbox and certificate, counted from fe.cu;
# per attribute channel, three planes of 3 multiplies, 2 adds and the
# multiply by 1/|D|.
OPS_FE = 200
OPS_FE_CHANNEL = 18
# Per texture channel and lane in the bilinear lerp: three subtractions,
# three multiplications, three additions.
OPS_LERP = 9
# The camera path (phase 11): config 4 under scenes.config4_camera at
# these times (s); every frame has over 1,000 straddling triangles.
CAMERA_TIMES = (0.0, 0.5, 1.0, 1.5, 2.0)
MIN_STRADDLERS = 500
# Phase 12, the rest of the public surface at full width: render_rows'
# bands of config 4 at 1080p (four of 270 rows, and a ragged one) on the
# frames below, render_msaa x2 on these frames, the wireframe cube at
# these times, config 4's first LINE_INDICES indices as lines, and
# resize targets.
ROW_BANDS = ((0, 270), (270, 270), (540, 270), (810, 270))
RAGGED_BAND = (37, 203)
ROW_FRAMES = (0, 120)
MSAA_FRAMES = (0, 120)
CUBE_TIMES = tuple(0.25 * i for i in range(8))
LINE_INDICES = 16_384
RESIZE_SIZES = ((720, 1280), (2160, 3840))
# Resize card vs CPU: one einsum in float32 whose summation order the two
# libraries choose.
RESIZE_TOL = 1e-5
# Phase 13: frames through FrameLoop (each sink) and the chunked batch,
# render_batch_chunked's group size, bench_frame's timed iterations.
LOOP_FRAMES = 16
CHUNK_FRAMES = 16
VMAP_CHUNK = 4
BENCH_ITERS = 20


def sync():
    torch.cuda.synchronize()


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` runs (CUDA events,
    after one warm-up run)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def max_err(a, b):
    """Max |a - b| over entries finite in both (NaN and inf positions
    must agree exactly)."""
    a, b = a.float(), b.float()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not bool((same | fin).all()):
        raise AssertionError("non-finite entries differ")
    return float((a - b)[fin].abs().max()) if bool(fin.any()) else 0.0


def assert_bit_equal(a, b, what):
    same = (a == b) | (torch.isnan(a) & torch.isnan(b)) \
        if a.is_floating_point() else (a == b)
    if not bool(same.all()):
        raise AssertionError(f"{what}: {int((~same).sum())} entries differ")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


# The least time of any launch on this card: a one-element torch add by
# CUDA-graph replay, measured by measure_launch_floor before phase 3
# builds any kernel's inputs.
launch_floor_ms = None


def measure_launch_floor(dev):
    global launch_floor_ms
    one = torch.zeros(1, device=dev)
    launch_floor_ms = graph_ms(lambda: one.add_(1.0), 200)
    print(f"launch floor (one-element torch add, CUDA-graph replay): "
          f"{launch_floor_ms} ms", flush=True)


def bound(n_bytes, n_ops, library_ms=None):
    """The least time (ms) the card could take to move ``n_bytes`` and do
    ``n_ops`` float32 operations, which of the two bounds it, and the
    time of one PyTorch call computing the same function (None where no
    one call does, as for K1-K6). ``least_ms`` also counts the launch
    floor, the third term below which no launch goes (``least_by``
    "launch" where it dominates)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    ms = max(t_bytes, t_ops)
    return dict(bound_ms=ms, bound_by=by,
                least_ms=max(ms, launch_floor_ms),
                least_by=by if ms >= launch_floor_ms else "launch",
                library_ms=library_ms)


def bbox_pixels(bbox, width, height):
    """Frame pixels inside each inclusive (x0, y0, x1, y1) box, summed:
    the (pixel, record) tests a rasterizer needs at least."""
    bb = bbox.to(torch.int64)
    w = (bb[:, 2].clamp(max=width - 1) - bb[:, 0].clamp(min=0) + 1)
    h = (bb[:, 3].clamp(max=height - 1) - bb[:, 1].clamp(min=0) + 1)
    return int((w.clamp(min=0) * h.clamp(min=0)).sum())


def resolve_bytes(rows, n_won, n_channels, *ts):
    """Bytes a resolve that binary-searches the rows' ids must move: the
    id column, the planes of the ``n_won`` rows that win a pixel, and the
    tensors ``ts`` (read or written once)."""
    return (nbytes(rows[:, tb.REC_BASE - 1], *ts)
            + n_won * 3 * n_channels * 4)


def resolve_merge_work(tid, slots, n_live, n_channels):
    """(bytes, operations) K4 must handle on this data: every pixel's id;
    per live winner (a pixel whose id's slot is below the count) its
    slot (4 bytes: ids travel as float32, so below 2^24) and its A plane
    writes, 4 operations a plane; and the planes of each distinct winning
    row. Returns the live winners' count too."""
    q = tid.long()
    won = (q >= 0) & (slots[q.clamp(min=0)] < n_live)
    n_won = int(won.sum())
    n_rows = torch.unique(q[won]).numel()
    n_bytes = (nbytes(tid) + n_won * (4 + 4 * n_channels)
               + n_rows * 3 * n_channels * 4)
    return n_bytes, 4 * n_channels * n_won, n_won


def sampler_work(tabs, prep, out):
    """(bytes, lanes) K7 must handle on this data: the tables, every
    segment's y0 and nwin, dy on the lanes of segments with a window,
    xa, fx and fy on the lanes inside a window, and the whole output; and
    the count of lanes inside a window, each of which lerps."""
    xa, dy, fx, fy, y0, nwin = prep
    n_seg = int((nwin > 0).sum())
    lanes = int(((dy >= 0) & (dy < ttk.WIN_STRIDE * nwin[:, None])).sum())
    n_bytes = (nbytes(tabs, y0, nwin, out)
               + n_seg * ttk.LANES * dy.element_size()
               + lanes * (xa.element_size() + fx.element_size()
                          + fy.element_size()))
    return n_bytes, lanes


def live_pairs(info):
    """The live pairs of a bin build (its ids past them are -1)."""
    return int(info.bin_start[-1])


def binned_ids(info):
    """The distinct binned triangle ids of a bin build (int64)."""
    return torch.unique(info.ids[:live_pairs(info)]).long()


def junk_seeds(dev, a, h, w):
    """(z, id, gb) seeds no render makes: a kernel told that no triangle
    spilled must neither read nor change them."""
    return (torch.full((h, w), -5.0, device=dev),
            torch.full((h, w), 7, dtype=torch.int32, device=dev),
            torch.full((a, h, w), 3.0, device=dev))


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bench_transform(base, i):
    """bench.py's animation: base @ rotation(i / 60 s about (1, 1, 0))."""
    axis = tf.normalize(torch.tensor([1.0, 1.0, 0.0], device=base.device))
    q = tf.quat_from_axis_angle(axis, torch.tensor(i / 60.0,
                                                   device=base.device))
    return base @ tf.rotation_matrix(q)


def phase_kernels(dev):
    """K1-K4 against their plain versions at config-4 shapes."""
    rp = scenes.config4_many_objects(0.0, device=dev)
    w, h = rp.width, rp.height
    ps, chans, attrs, prm, _, _ = triangle_inputs(rp)
    t = ps.num_triangles
    print(f"kernels at config-4 shapes: {w}x{h}, T={t}", flush=True)
    res = {}

    cc = fe.corner_cols(rp.mesh.positions[rp.mesh.triangles().long()])
    cols = torch.stack([c for corner in cc for c in corner]).contiguous()
    m16 = rp.transform.reshape(16).contiguous()
    vals = torch.stack([v for chan in attrs for v in chan]).contiguous()
    fe_args = (cols, m16, vals, w, h)
    rk, tk = fe_table_kernel(*fe_args, cull_backfaces=True)
    rpl, tpl = fe_table_plain(*fe_args, cull_backfaces=True)
    rows_only = fe_kernel(cols, m16, w, h, cull_backfaces=True)
    sync()
    assert_bit_equal(rk, rpl, "K1 front-end rows")
    assert_bit_equal(tk, tpl, "K1 stream table")
    assert_bit_equal(rows_only, rpl, "K1 front-end rows, rows alone")

    def earlier_front():
        # The previous design: the rows, then the planes and the table
        # from torch ops.
        ps_ = fe.planar_setup_from_rows(fe_kernel(cols, m16, w, h,
                                                  cull_backfaces=True))
        return fe.stream_table_planar(ps_, fe.attribute_plane_cols(ps_,
                                                                   attrs))

    # Every kernel by CUDA-graph replay (most are shorter than their
    # wrappers' host overhead); launch_loop_ms is back-to-back calls.
    res["fe"] = dict(
        max_abs_err=max(max_err(rk, rpl), max_err(tk, tpl)),
        ms=graph_ms(lambda: fe_table_kernel(*fe_args, cull_backfaces=True),
                    50),
        launch_loop_ms=cuda_ms(lambda: fe_table_kernel(
            *fe_args, cull_backfaces=True), 50),
        rows_only_ms=graph_ms(lambda: fe_kernel(cols, m16, w, h,
                                                cull_backfaces=True), 50),
        earlier_ms=graph_ms(earlier_front, 20),
        plain_ms=cuda_ms(lambda: fe_table_plain(
            *fe_args, cull_backfaces=True), 5),
        shape=f"T={t}, A={len(attrs)}",
        **bound(nbytes(cols, m16, vals, rk, tk),
                (OPS_FE + OPS_FE_CHANNEL * len(attrs)) * t))
    bbox = fe.bbox_table(ps)

    table, a, poison = fe.stream_table_planar(
        ps, fe.attribute_plane_cols(ps, attrs))
    assert_bit_equal(table, tk, "stream table of the plain composition")
    kw = dict(width=w, height=h, chans=chans, has_light=True,
              has_texture=True, bands=4, bbox=bbox)
    info = tb.build_bins(ps, width=w, height=h, kmax=48,
                         pair_budget_factor=0.85, bands=4)
    n_pairs = live_pairs(info)
    rows = tb.gather_stream(table, info.ids, poison).contiguous()
    zk, ik, ok = tb.fused_kernel(rows, info.bin_start, prm, **kw)
    zp, ip, op = tb.fused_plain(rows, info.bin_start, prm, **kw)
    sync()
    assert_bit_equal(ik, ip, "K2 ids")
    assert_bit_equal(zk, zp, "K2 depth")
    err2 = max_err(ok, op)
    assert err2 <= PLANE_TOL, f"K2 planes differ by {err2}"
    # The main path's launch: seeded from the overflow pass with the
    # frame's overflow count, which frame 0 leaves at 0, so the launch
    # must read no seed (these would show) and equal the static walk.
    assert int(info.n_overflow) == 0, "frame 0 spills"
    junk = junk_seeds(dev, a, h, w)
    zc, ic, oc = tb.fused_kernel(rows, info.bin_start, prm, seeds=junk,
                                 n_overflow=info.n_overflow, **kw)
    zcp, icp, ocp = tb.fused_plain(rows, info.bin_start, prm, seeds=junk,
                                   n_overflow=info.n_overflow, **kw)
    sync()
    for got, want, what in ((zc, zk, "depth"), (ic, ik, "ids"),
                            (oc, ok, "planes"), (zcp, zp, "plain depth"),
                            (icp, ip, "plain ids"), (ocp, op, "plain planes")):
        assert_bit_equal(got, want, f"K2 with the count at 0 vs static, "
                                    f"{what}")
    # In turns, static, count, count, static: the same call and card.
    t2 = {"static": [], "count": []}
    for which in ("static", "count", "count", "static"):
        extra = {} if which == "static" else dict(
            seeds=junk, n_overflow=info.n_overflow)
        t2[which].append(graph_ms(lambda: tb.fused_kernel(
            rows, info.bin_start, prm, **extra, **kw), 20))
    k2_ms = sum(t2["count"]) / 2
    k2_static = sum(t2["static"]) / 2
    print(f"K2 on frame 0 (no spill), by graph replay in turns: static "
          f"{t2['static']} ms, seeded with the count at 0 {t2['count']} "
          f"ms; ratio {k2_ms / k2_static}", flush=True)
    res["fused"] = dict(
        max_abs_err=err2,
        ms=k2_ms,
        static_ms=k2_static,
        count_vs_static=k2_ms / k2_static,
        launch_loop_ms=cuda_ms(lambda: tb.fused_kernel(
            rows, info.bin_start, prm, seeds=junk,
            n_overflow=info.n_overflow, **kw), 20),
        plain_ms=cuda_ms(lambda: tb.fused_plain(rows, info.bin_start, prm,
                                                **kw), 2),
        shape=f"{n_pairs} pairs in {info.bin_start.numel() - 1} bins "
              f"(capacity {info.ids.numel()})",
        **bound(nbytes(rows[:n_pairs], info.bin_start, prm, zk, ik, ok),
                OPS_TEST * bbox_pixels(bbox[binned_ids(info)], w, h)
                + w * h * (4 * a + OPS_EPILOGUE)))

    # Overflow set: kmax=1 spills every triangle spanning two bins or more.
    # As the main path runs it: the static overflow list (ids ascending,
    # then -1) and the device count.
    info1 = tb.build_bins(ps, width=w, height=h, kmax=1,
                          pair_budget_factor=0.85, bands=4)
    n1 = info1.n_overflow
    n_ov = int(n1)
    ov, slots = tb.overflow_ids(info1.overflow_mask)
    ov_rows = tb.gather_stream(table, ov, poison).contiguous()
    rec = tb.raster_records(ov_rows, bbox, ov)
    z0 = torch.full((h, w), float("inf"), device=dev)
    i0 = torch.full((h, w), -1, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    k3 = dict(width=w, height=h, n_live=n1)
    z3, i3 = visibility_merge_kernel(rec, z0, i0, **k3)
    z3p, i3p = visibility_merge_plain(rec, z0, i0, **k3)
    # The compact list of the spilled triangles' records, with no count.
    rec_c = tb.gather_stream(fe.pack_records_planar(ps, 128), ov[:n_ov],
                             _poison_row(dev)).contiguous()
    z3c, i3c = visibility_merge_kernel(rec_c, z0, i0, width=w, height=h)
    z30, i30 = visibility_merge_kernel(rec, junk[0], junk[1], width=w,
                                       height=h, n_live=zero)
    sync()
    assert_bit_equal(i3, i3p, "K3 ids")
    assert_bit_equal(z3, z3p, "K3 depth")
    assert_bit_equal(i3, i3c, "K3 ids, static list vs compact list")
    assert_bit_equal(z3, z3c, "K3 depth, static list vs compact list")
    assert_bit_equal(i30, junk[1], "K3 with the count at 0: ids")
    assert_bit_equal(z30, junk[0], "K3 with the count at 0: depth")
    res["visibility_merge"] = dict(
        max_abs_err=max_err(z3, z3p),
        ms=graph_ms(lambda: visibility_merge_kernel(rec, z0, i0, **k3), 20),
        count0_ms=graph_ms(lambda: visibility_merge_kernel(
            rec, z0, i0, width=w, height=h, n_live=zero), 20),
        compact_ms=graph_ms(lambda: visibility_merge_kernel(
            rec_c, z0, i0, width=w, height=h), 20),
        launch_loop_ms=cuda_ms(lambda: visibility_merge_kernel(
            rec, z0, i0, **k3), 20),
        plain_ms=cuda_ms(lambda: visibility_merge_plain(
            rec, z0, i0, **k3), 1),
        shape=f"{n_ov} overflow records of a {rec.shape[0]}-row list",
        **bound(nbytes(rec[:n_ov], z0, i0, z3, i3),
                OPS_TEST_CLAMPED * bbox_pixels(rec[:n_ov, 10:14], w, h)))

    # With no seed K4 defines the overflow winners' pixels only (all
    # that K2 reads of its seed planes); the main path passes the slot map
    # of the static list.
    k4 = dict(width=w, height=h, n_live=n1, slots=slots)
    won = i3 >= 0
    g4 = tb.resolve_merge_kernel(ov_rows, i3, None, **k4)
    g4p = tb.resolve_merge_plain(ov_rows, i3, None, **k4)
    g4s = tb.resolve_merge_kernel(ov_rows, i3, torch.zeros_like(g4), **k4)
    g4sp = tb.resolve_merge_plain(ov_rows, i3, torch.zeros_like(g4), **k4)
    g40 = tb.resolve_merge_kernel(ov_rows, i3, junk[2], width=w, height=h,
                                  n_live=zero, slots=slots)
    g40i = junk[2].clone()
    tb.resolve_merge_kernel(ov_rows, i3, g40i, width=w, height=h,
                            n_live=zero, slots=slots, inplace=True)
    sync()
    err4 = max(max_err(g4[:, won], g4p[:, won]), max_err(g4s, g4sp))
    assert err4 <= PLANE_TOL, f"K4 planes differ by {err4}"
    assert_bit_equal(g4s[:, won], g4[:, won], "K4 with a zero seed vs none")
    assert_bit_equal(g40, junk[2], "K4 with the count at 0")
    assert_bit_equal(g40i, junk[2], "K4 in place with the count at 0")
    k4_bytes, k4_ops, k4_won = resolve_merge_work(i3, slots, n_ov, a)
    assert k4_won == int(won.sum())
    res["resolve_merge"] = dict(
        max_abs_err=err4,
        bit_equal=bool(((g4 == g4p)[:, won]).all() and (g4s == g4sp).all()),
        ms=graph_ms(lambda: tb.resolve_merge_kernel(ov_rows, i3, None,
                                                    **k4), 50),
        count0_ms=graph_ms(lambda: tb.resolve_merge_kernel(
            ov_rows, i3, None, width=w, height=h, n_live=zero,
            slots=slots), 50),
        seed_ms=graph_ms(lambda: tb.resolve_merge_kernel(
            ov_rows, i3, g4s, **k4), 50),
        launch_loop_ms=cuda_ms(lambda: tb.resolve_merge_kernel(
            ov_rows, i3, None, **k4), 20),
        plain_ms=cuda_ms(lambda: tb.resolve_merge_plain(
            ov_rows, i3, None, **k4), 5),
        shape=f"{n_ov} overflow rows of a {ov_rows.shape[0]}-row list, "
              f"{k4_won} winner pixels",
        **bound(k4_bytes, k4_ops))
    r4 = res["resolve_merge"]
    r4["count0_earlier_ms"] = EARLIER_MS["resolve_merge_count0"]
    # At a count of 0 with no seed the function moves nothing: its least
    # time is the launch floor.
    r4["count0_least_ms"] = bound(0, 0)["least_ms"]
    r4["count0_vs_floor"] = r4["count0_ms"] / launch_floor_ms
    r4["share_of_bound"] = r4["least_ms"] / r4["ms"]
    print(f"K4 (kmax=1 spill, no seed): {r4['ms']} ms (earlier "
          f"{EARLIER_MS['resolve_merge']}), bound {r4['bound_ms']} "
          f"({r4['bound_by']}), {r4['share_of_bound']} of it; count 0 "
          f"{r4['count0_ms']} ms (earlier {r4['count0_earlier_ms']}), "
          f"{r4['count0_vs_floor']} x the launch floor; seed out of place "
          f"{r4['seed_ms']} ms; bit-equal {r4['bit_equal']}", flush=True)

    rows1 = tb.gather_stream(table, info1.ids, poison).contiguous()
    seeds = (z3, i3, g4)
    kw1 = dict(seeds=seeds, n_overflow=n1, **kw)
    zs, is_, os_ = tb.fused_kernel(rows1, info1.bin_start, prm, **kw1)
    zsp, isp, osp = tb.fused_plain(rows1, info1.bin_start, prm, **kw1)
    sync()
    assert_bit_equal(is_, isp, "K2 seeded ids")
    assert_bit_equal(zs, zsp, "K2 seeded depth")
    errs = max_err(os_, osp)
    assert errs <= PLANE_TOL, f"K2 seeded planes differ by {errs}"
    # The seeded all-spill frame must equal the spill-free one.
    assert_bit_equal(is_, ik, "seeded vs binned ids")
    assert_bit_equal(zs, zk, "seeded vs binned depth")
    res["fused"]["max_abs_err"] = max(err2, errs)
    res["fused"]["seeded_max_abs_err_vs_binned"] = max_err(os_, ok)
    res["fused"]["seeded_ms"] = graph_ms(lambda: tb.fused_kernel(
        rows1, info1.bin_start, prm, **kw1), 20)
    res["fused"]["seeded_shape"] = (f"{live_pairs(info1)} pairs, "
                                    f"{n_ov} spilled")
    print(f"seeded fused (kmax=1, {n_ov} spilled) equals the binned "
          f"frame; planes max |d| {res['fused']['seeded_max_abs_err_vs_binned']}",
          flush=True)
    print(f"K3 and K4 with the count at 0 return their seeds; K3 over the "
          f"static list equals K3 over the compact list", flush=True)

    # K3' (the clear mode) on every record of the frame, as the pallas
    # backend gives them, against its plain version.
    rec_all = fe.pack_records_planar(ps, 128)
    zc, ic = visibility_kernel(rec_all, width=w, height=h)
    zcp, icp = visibility_plain(rec_all, width=w, height=h)
    sync()
    assert_bit_equal(ic, icp, "K3' ids")
    assert_bit_equal(zc, zcp, "K3' depth")
    # From the clear buffer with records in ascending id, K3' must equal
    # K3's lex merge: on the overflow records above.
    zo, io = visibility_kernel(rec[:n_ov], width=w, height=h)
    sync()
    assert_bit_equal(io, i3, "K3' vs K3 ids")
    assert_bit_equal(zo, z3, "K3' vs K3 depth")
    # K3' on large triangles: config 2's cube at the same 1920x1080 frame,
    # each of its records over many tiles.
    cube = scenes.config2_textured_cube(0.7, width=w, height=h, device=dev)
    rec_cube = fe.pack_records_planar(triangle_inputs(cube)[0], 128)
    zb, ib = visibility_kernel(rec_cube, width=w, height=h)
    zbp, ibp = visibility_plain(rec_cube, width=w, height=h)
    sync()
    assert bool((ib >= 0).any())
    assert_bit_equal(ib, ibp, "K3' ids, cube at 1080p")
    assert_bit_equal(zb, zbp, "K3' depth, cube at 1080p")
    print(f"K3' on config 2's cube at {w}x{h} ({rec_cube.shape[0]} records, "
          f"coverage {float((ib >= 0).float().mean())}) equals its plain "
          f"version", flush=True)
    res["visibility"] = dict(
        max_abs_err=max(max_err(zc, zcp), max_err(zb, zbp)),
        ms=graph_ms(lambda: visibility_kernel(rec_all, width=w, height=h),
                    20),
        launch_loop_ms=cuda_ms(lambda: visibility_kernel(
            rec_all, width=w, height=h), 20),
        cube_1080p_ms=graph_ms(lambda: visibility_kernel(
            rec_cube, width=w, height=h), 20),
        plain_ms=cuda_ms(lambda: visibility_plain(rec_all, width=w,
                                                  height=h), 1),
        shape=f"{rec_all.shape[0]} records, {int(ps.valid.sum())} valid",
        **bound(nbytes(rec_all, zc, ic),
                OPS_TEST_CLAMPED * bbox_pixels(rec_all[:, 10:14], w, h)))

    # K5 and K6 on binned_pipeline's inputs: whole tiles, config 4's
    # channels, the render path's budget.
    info_b = tb.build_bins(ps, width=w, height=h, pair_budget_factor=BUDGET)
    rows_b = tb.gather_stream(table, info_b.ids, poison).contiguous()
    starts = info_b.bin_start
    geo5 = dict(width=w, height=h, bbox=bbox)
    z5, i5 = tb.binned_vis_kernel(rows_b, starts, **geo5)
    z5p, i5p = tb.binned_vis_plain(rows_b, starts, **geo5)
    sync()
    assert_bit_equal(i5, i5p, "K5 ids")
    assert_bit_equal(z5, z5p, "K5 depth")
    res["binned_vis"] = dict(
        max_abs_err=max_err(z5, z5p),
        ms=graph_ms(lambda: tb.binned_vis_kernel(rows_b, starts, **geo5),
                    20),
        launch_loop_ms=cuda_ms(lambda: tb.binned_vis_kernel(
            rows_b, starts, **geo5), 20),
        plain_ms=cuda_ms(lambda: tb.binned_vis_plain(rows_b, starts, **geo5),
                         2),
        shape=f"{live_pairs(info_b)} pairs in {starts.numel() - 1} bins",
        **bound(live_pairs(info_b) * tb.REC_BASE * 4
                + nbytes(starts, z5, i5),
                OPS_TEST * bbox_pixels(bbox[binned_ids(info_b)], w, h)))

    g6 = tb.resolve_kernel(rows_b, starts, i5, n_channels=a, width=w,
                           height=h)
    g6p = tb.resolve_plain(rows_b, starts, i5, n_channels=a, width=w,
                           height=h)
    sync()
    err6 = max_err(g6, g6p)
    assert err6 <= PLANE_TOL, f"K6 planes differ by {err6}"
    longest = int((starts[1:] - starts[:-1]).max())
    # Rows whose planes are read: one per distinct (bin, winner) pair.
    pix_bin = ((torch.arange(h, device=dev)[:, None] // tb.TILE_H)
               * -(-w // tb.TILE_W)
               + torch.arange(w, device=dev)[None, :] // tb.TILE_W)
    hit = i5 >= 0
    n_won = torch.unique(pix_bin[hit] * tb.ID_SPAN + i5[hit].long()).numel()
    res["resolve"] = dict(
        max_abs_err=err6,
        ms=graph_ms(lambda: tb.resolve_kernel(rows_b, starts, i5,
                                              n_channels=a, width=w,
                                              height=h), 20),
        launch_loop_ms=cuda_ms(lambda: tb.resolve_kernel(
            rows_b, starts, i5, n_channels=a, width=w, height=h), 20),
        plain_ms=cuda_ms(lambda: tb.resolve_plain(
            rows_b, starts, i5, n_channels=a, width=w, height=h), 5),
        shape=f"{live_pairs(info_b)} rows, {a} channels, {n_won} won",
        **bound(resolve_bytes(rows_b[:live_pairs(info_b)], n_won, a, starts,
                              i5, g6),
                w * h * (4 * a + math.ceil(math.log2(longest + 1)))))
    # The bin walks' inputs: records per bin (a few long bins set their
    # time).
    for what, starts_ in (("K2 static", info.bin_start),
                          ("K2 seeded (kmax=1)", info1.bin_start),
                          ("K5", starts)):
        print(f"records per bin, {what}: {json.dumps(percentiles(starts_))}",
              flush=True)
    res["fe"]["earlier_kernel_ms"] = EARLIER_MS["fe"]
    for name, r in res.items():
        if name in EARLIER_MS:
            r.setdefault("earlier_ms", EARLIER_MS[name])
        print(f"  {name}: {json.dumps(r)}", flush=True)
    _cuda.reset_launches()
    return res


def phase_spill(dev):
    """config 2 at 512x512 with kmax=1 vs the default: the overflow
    kernels and the seeded fused kernel run, and the frames are equal."""
    rp = scenes.config2_textured_cube(0.7, device=dev)
    ps, chans, attrs, prm, _, _ = triangle_inputs(rp)
    kw = dict(width=rp.width, height=rp.height, chans=chans, has_light=True,
              has_texture=True, pair_budget_factor=0.85)
    d0, i0, o0 = tb.fused_pipeline(ps, attrs, prm, **kw)
    sync()
    _cuda.reset_launches()
    d1, i1, o1 = tb.fused_pipeline(ps, attrs, prm, kmax=1, **kw)
    sync()
    counts = dict(_cuda.launches)
    print(f"spill scene (config2 512x512, kmax=1) launches: "
          f"{json.dumps(counts)}", flush=True)
    for k in ("visibility_merge", "resolve_merge", "fused_seeded"):
        assert counts[k] > 0, f"{k} did not launch on the spill scene"
    assert bool((i0 >= 0).any())
    assert_bit_equal(i0, i1, "spill ids")
    assert_bit_equal(d0, d1, "spill depth")
    err = max_err(o0, o1)
    assert err <= PLANE_TOL, f"spill planes differ by {err}"
    print(f"spill frame equals the spill-free frame (planes max |d| {err})",
          flush=True)


def phase_main(dev, card):
    """The main path: render() of config-4 frames at 1920x1080."""

    rp = scenes.config4_many_objects(0.0, device=dev)
    n_tri = rp.mesh.indices.numel() // 3
    render(rp)  # warm-up (allocator, first launches)
    sync()
    passes = [dataclasses.replace(rp, transform=bench_transform(
        rp.transform, i)) for i in MAIN_FRAMES]
    _cuda.reset_launches()
    times, cov, finite = [], [], True
    for p in passes:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fb = render(p)
        end.record()
        sync()
        times.append(start.elapsed_time(end))
        assert fb.color.shape == (rp.height, rp.width, 4)
        assert fb.depth.shape == (rp.height, rp.width)
        finite = finite and bool(torch.isfinite(fb.color).all())
        cov.append(float(fb.color[..., 3].mean()))
    launches = dict(_cuda.launches)
    print(f"main path: {len(passes)} frames of config4 {rp.width}x"
          f"{rp.height}, T={n_tri}, frames {list(MAIN_FRAMES)}", flush=True)
    print(f"  launches: {json.dumps(launches)}", flush=True)
    print(f"  coverage per frame: {cov}", flush=True)
    print(f"  finite: {finite}", flush=True)
    print(f"  ms/frame (CUDA events, {card}): {times}; mean "
          f"{sum(times) / len(times)}", flush=True)
    dev_ms, n_kernels, n_copies = top_device_ops(
        lambda: [render(p) for p in passes], f"{len(passes)} main-path frames")
    print(f"  device ms/frame (profiled kernels, {card}): "
          f"{dev_ms / len(passes)}; device kernels/frame "
          f"{n_kernels / len(passes)}, copies and memsets/frame "
          f"{n_copies / len(passes)}", flush=True)
    assert finite, "non-finite color"
    assert all(c > 0 for c in cov), "a frame covered nothing"
    for k in ("fe", "fused", "visibility_merge", "resolve_merge",
              "fused_seeded"):
        assert launches[k] > 0, f"kernel {k} never launched on the main path"
    return launches, sum(times) / len(times)


def phase_small_reference(dev):
    """The same small scene on the card and on the CPU (plain versions),
    through each backend that runs at this size."""
    rp_c = scenes.config4_many_objects(0.3, width=320, height=192,
                                       triangles=3000, device="cpu")
    for backend in ("auto", "reference", "pallas"):
        fb_c = render(rp_c, backend=backend)
        fb_g = render(rp_c.to(dev), backend=backend)
        sync()
        cg, dg = fb_g.color.cpu(), fb_g.depth.cpu()
        what = f"small {backend}"
        assert_bit_equal(cg[..., 3], fb_c.color[..., 3], f"{what}: alpha")
        assert_bit_equal(dg, fb_c.depth, f"{what}: depth")
        err = max_err(cg, fb_c.color)
        assert err <= 1e-3, f"{what}: color differs by {err}"
        print(f"small scene (config4 3000 tris 320x192, {backend}): card == "
              f"CPU plain, coverage {float(cg[..., 3].mean())}, color max "
              f"|d| {err}", flush=True)


def phase_backends(dev, card):
    """The other backends at config 4's full size on the frames that
    spill. Each path runs with the counters reset just before it and read
    just after; then (depth, id) must agree bit for bit across the record
    walk, the binned pass and the fused path on every frame."""
    rp = scenes.config4_many_objects(0.0, device=dev)
    w, h = rp.width, rp.height
    passes = [dataclasses.replace(rp, transform=bench_transform(
        rp.transform, i)) for i in BACKEND_FRAMES]

    def gbuffer(p):
        ps, _, attrs, _, _, _ = triangle_inputs(p)
        return tb.binned_pipeline(ps, attrs, width=w, height=h,
                                  pair_budget_factor=BUDGET)

    paths = {
        "pallas": lambda p: render(p, backend="pallas"),
        "binned": lambda p: render(p, backend="binned"),
        "flat": lambda p: render(dataclasses.replace(p, shading="flat")),
        "binned_pipeline": gbuffer,
    }
    launches, ms = {}, {}
    for name, fn in paths.items():
        fn(passes[0])  # warm-up
        sync()
        _cuda.reset_launches()
        times = []
        for p in passes:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(p)
            end.record()
            sync()
            times.append(start.elapsed_time(end))
            color = out.color if name != "binned_pipeline" else out[2]
            assert bool(torch.isfinite(color).all()), f"{name}: non-finite"
        launches[name] = dict(_cuda.launches)
        ms[name] = times
        print(f"backend {name}: frames {list(BACKEND_FRAMES)}, launches "
              f"{json.dumps(launches[name])}", flush=True)
        print(f"  ms/frame (CUDA events, {card}): {times}; mean "
              f"{sum(times) / len(times)}", flush=True)
        dev_ms, n_kernels, _ = top_device_ops(
            lambda: [fn(p) for p in passes], f"{len(passes)} {name} frames")
        print(f"  device ms/frame (profiled kernels, {card}): "
              f"{dev_ms / len(passes)}; device kernels/frame "
              f"{n_kernels / len(passes)}", flush=True)
    need = {"pallas": ("fe", "visibility"),
            "binned": ("fe", "fused", "visibility_merge", "resolve_merge"),
            "flat": ("fe", "binned_vis"),
            "binned_pipeline": ("binned_vis", "resolve")}
    for name, kernels in need.items():
        for k in kernels:
            assert launches[name][k] > 0, f"{k} never launched on {name}"
    assert launches["pallas"]["fused"] == 0
    assert launches["flat"]["fused"] == 0

    for i, p in zip(BACKEND_FRAMES, passes):
        ps, chans, attrs, prm, has_light, has_texture = triangle_inputs(p)
        d3, i3 = visibility_pallas(fe.to_setup(ps), width=w, height=h)
        d5, i5 = tb.visibility_binned(ps, width=w, height=h,
                                      pair_budget_factor=BUDGET)
        d2, i2, _ = tb.fused_pipeline(
            ps, attrs, prm, width=w, height=h, chans=chans,
            has_light=has_light, has_texture=has_texture,
            pair_budget_factor=BUDGET)
        sync()
        for what, d, ids in (("binned", d5, i5), ("fused", d2, i2)):
            assert_bit_equal(ids, i3, f"frame {i}: {what} vs pallas ids")
            assert_bit_equal(d, d3, f"frame {i}: {what} vs pallas depth")
        print(f"frame {i}: (depth, id) equal across K3', K5 + K3 and K2; "
              f"coverage {float((i3 >= 0).float().mean())}", flush=True)
    return launches, ms, binned_pipeline_k4(passes, w, h)


def binned_pipeline_k4(passes, w, h):
    """K4 as binned_pipeline launches it, on its own inputs: the pipeline
    runs on each frame of ``passes`` (and with kmax=1 on the first frame
    if none spills) with its K4 call recorded; on the frame with the most
    spills its G-buffer must equal K6's planes with the plain K4 applied
    in place on the recorded inputs, bit for bit, and K4 is timed in
    place on them against the out-of-place form (the wrapper's clone of
    the seed, then the same launch)."""
    calls = []
    kernel = tb.resolve_merge_kernel

    def record(rows, tid, gb_in, **kw):
        calls.append((rows, tid, gb_in.clone(), kw))
        return kernel(rows, tid, gb_in, **kw)

    def run(p, kmax=tb.KMAX):
        ps, _, attrs, _, _, _ = triangle_inputs(p)
        calls.clear()
        tb.resolve_merge_kernel = record
        try:
            out = tb.binned_pipeline(ps, attrs, width=w, height=h, kmax=kmax,
                                     pair_budget_factor=BUDGET)
        finally:
            tb.resolve_merge_kernel = kernel
        (call,) = calls
        return int(call[3]["n_live"]), kmax, out, call

    n_ov, kmax, out, call = max((run(p) for p in passes),
                                key=lambda f: f[0])
    if n_ov == 0:
        n_ov, kmax, out, call = run(passes[0], kmax=1)
    assert n_ov > 0, "no binned_pipeline frame spills"
    ov_rows, tid, g6, k4 = call
    assert k4.pop("inplace"), "binned_pipeline's K4 copies its seed"
    a = g6.shape[0]
    gp = tb.resolve_merge_plain(ov_rows, tid, g6.clone(), inplace=True,
                                **k4)
    gk = out[2].permute(2, 0, 1)
    sync()
    assert_bit_equal(gk, gp, "binned_pipeline's G-buffer vs K6 + plain K4")
    n_bytes, n_ops, n_won = resolve_merge_work(tid, k4["slots"], n_ov, a)
    buf = g6.clone()
    r = dict(
        max_abs_err=max_err(gk, gp),
        inplace_ms=graph_ms(lambda: tb.resolve_merge_kernel(
            ov_rows, tid, buf, inplace=True, **k4), 50),
        seed_copy_ms=graph_ms(lambda: tb.resolve_merge_kernel(
            ov_rows, tid, g6, **k4), 50),
        shape=f"{n_ov} overflow rows (kmax {kmax}), {n_won} winner "
              f"pixels, {int((tid >= 0).sum())} covered, {a} channels",
        **bound(n_bytes, n_ops))
    print(f"K4 in binned_pipeline (in place): {json.dumps(r)}", flush=True)
    return r


def frame0_uv(dev):
    """Config 4's frame 0 through the fused pipeline: the texture, the u
    and v planes and the covered mask that its texture tail samples."""
    rp = scenes.config4_many_objects(0.0, device=dev)
    ps, chans, attrs, prm, has_light, has_texture = triangle_inputs(rp)
    _, ids, out = tb.fused_pipeline(
        ps, attrs, prm, width=rp.width, height=rp.height, chans=chans,
        has_light=has_light, has_texture=has_texture,
        pair_budget_factor=BUDGET)
    assert fused_output_channels(rp.shading, chans, has_light,
                                 has_texture)[-1] == ("uv", 2)
    return rp.texture, out[-2], out[-1], ids != -1


def phase_texture_kernels(dev):
    """K7 at config-4 frame-0 shapes (16,200 segments of 128 lanes, C = 3,
    256x256 repeat texture) and K8 at the probe's shapes, each against
    its plain version, with times, bounds and library times."""
    tex, u, v, covered = frame0_uv(dev)
    th, tw, c = tex.data.shape
    h, w = u.shape
    ns = h * w // ttk.LANES
    u_s, v_s = u.reshape(ns, ttk.LANES), v.reshape(ns, ttk.LANES)
    cov_s = covered.reshape(ns, ttk.LANES)
    res = {}

    def route(wrap):
        prep = ttk.windowed_prep(u_s, v_s, cov_s, th=th, tw=tw, wrap=wrap)
        return ttk.windowed_texels(tex.data, wrap), prep

    geo = dict(c=c, th=th, tw=tw, wrap=tex.wrap)
    texels, prep = route(tex.wrap)
    tabs = ttk.windowed_tables(tex.data, tex.wrap)
    k7 = ttk.sampler_kernel(texels, *prep, **geo)
    p7 = ttk.sampler_plain(texels, *prep, **geo)
    quad = ttex.sample_texture_planes(tex, u, v)
    sync()
    assert_bit_equal(k7, p7, "K7 vs plain, every lane")
    assert_bit_equal(k7, ttk.sample_segments_windowed_plain(
        tabs, *prep, th=th, tw=tw, wrap=tex.wrap), "K7 vs planar plain")
    err_quad = max(max_err(k7[ch].reshape(h, w)[covered], quad[ch][covered])
                   for ch in range(c))
    assert err_quad <= PLANE_TOL, f"K7 vs quad-table sampler: {err_quad}"
    # The library call: grid_sample computes clamp-to-edge bilinear, so it
    # is held against K7's clamp variant, on covered lanes at or right of
    # the first texel centre and at or below it (left of it the TPU
    # sampler's clamp lerps toward texel 1, where grid_sample holds texel
    # 0).
    texels_c, prep_c = route("clamp")
    k7c = ttk.sampler_kernel(texels_c, *prep_c, **dict(geo, wrap="clamp"))
    img = tex.data.permute(2, 0, 1)[None].contiguous()
    grid = torch.stack([u_s * 2.0 - 1.0, v_s * 2.0 - 1.0], dim=-1)[None]

    def library():
        return torch.nn.functional.grid_sample(
            img, grid, mode="bilinear", padding_mode="border",
            align_corners=False)

    gs = library()[0]
    inner = cov_s & (u_s * tw - 0.5 >= 0.0) & (v_s * th - 0.5 >= 0.0)
    err_lib = max_err(k7c[:, inner], gs[:, inner])
    sync()
    assert err_lib <= LIBRARY_TOL, f"grid_sample vs K7 clamp: {err_lib}"
    n_cov = int(covered.sum())
    print(f"K7 at config-4 frame 0: {ns} segments, {n_cov} covered lanes, "
          f"{int((prep[5] > 0).sum())} covered segments, "
          f"{int(prep[5].sum())} windows; bit-equal to its plain version on "
          f"every lane; covered lanes vs sample_texture_planes max |d| "
          f"{err_quad}; grid_sample vs K7 (clamp) max |d| {err_lib} on "
          f"{int(inner.sum())} lanes ({n_cov - int(inner.sum())} covered "
          f"lanes at the left/top half texel left out)", flush=True)
    k7_bytes, k7_lanes = sampler_work(tabs, prep, k7)
    print(f"  K7 bound counts {k7_bytes} bytes and {k7_lanes} lanes inside "
          f"a window", flush=True)
    # Device times from CUDA-graph replays: K7, K8 and their library calls
    # are shorter than the host's launch overhead.
    res["sampler"] = dict(
        max_abs_err=max_err(k7, p7),
        ms=graph_ms(lambda: ttk.sampler_kernel(texels, *prep, **geo), 50),
        launch_loop_ms=cuda_ms(lambda: ttk.sampler_kernel(texels, *prep,
                                                          **geo), 50),
        plain_ms=graph_ms(lambda: ttk.sampler_plain(texels, *prep, **geo),
                          5),
        prep_ms=graph_ms(lambda: ttk.windowed_prep(
            u_s, v_s, cov_s, th=th, tw=tw, wrap=tex.wrap), 10),
        texels_ms=graph_ms(lambda: ttk.windowed_texels(tex.data, tex.wrap),
                           20),
        quad_sampler_ms=graph_ms(
            lambda: ttex.sample_texture_planes(tex, u, v), 20),
        grid_sample_max_abs_err=err_lib,
        shape=f"{ns}x{ttk.LANES} lanes, C={c}, {th}x{tw} {tex.wrap}",
        **bound(k7_bytes, OPS_LERP * c * k7_lanes,
                library_ms=graph_ms(library, 50)))

    rng = np.random.default_rng(0)
    err_tk = 0.0
    for s_, l_, axis in probe.SHAPES:
        x, idx = probe.shape_inputs(rng, s_, l_, axis, dev)
        ok = probe.take_along_axis(x, idx, axis)
        op = probe.take_along_axis_plain(x, idx, axis)
        sync()
        assert_bit_equal(ok, op, f"K8 take_along_axis [{s_},{l_}] axis "
                         f"{axis}")
        err_tk = max(err_tk, max_err(ok, op))
    # Timed at the probe's largest shape, [256, 128] on axis 0.
    x, idx = probe.shape_inputs(rng, 256, 128, 0, dev)
    plain_tk = graph_ms(lambda: probe.take_along_axis_plain(x, idx, 0), 50)
    res["take_along_axis"] = dict(
        max_abs_err=err_tk,
        ms=graph_ms(lambda: probe.take_along_axis(x, idx, 0), 50),
        plain_ms=plain_tk,
        shape="9 probe shapes exact; timed at [256,128] axis 0",
        **bound(nbytes(x, idx, x), 0, library_ms=plain_tk))
    tab, y0, ty, tx, _, _ = probe.lookup_inputs(rng, dev)
    lk = probe.window_lookup(tab, y0, ty, tx)
    lp = probe.window_lookup_plain(tab, y0, ty, tx)
    sync()
    assert_bit_equal(lk, lp, "K8 window lookup")
    plain_wl = graph_ms(lambda: probe.window_lookup_plain(tab, y0, ty, tx),
                        50)
    res["window_lookup"] = dict(
        max_abs_err=max_err(lk, lp),
        ms=graph_ms(lambda: probe.window_lookup(tab, y0, ty, tx), 50),
        plain_ms=plain_wl,
        shape=f"{probe.SEGS}x{probe.LANES} lanes, "
              f"{probe.TABLE}x{probe.TABLE} table",
        **bound(nbytes(tab, y0, ty, tx, lk), 0, library_ms=plain_wl))
    res["window_lookup"]["earlier_ms"] = EARLIER_MS["window_lookup"]
    # K8's shape_probe moves less than a launch costs: its least time is
    # the launch floor.
    print(f"launch floor {launch_floor_ms} ms; K8 take_along_axis "
          f"{res['take_along_axis']['ms']} ms, "
          f"{res['take_along_axis']['ms'] / launch_floor_ms} x the floor",
          flush=True)
    for name in ("sampler", "take_along_axis", "window_lookup"):
        print(f"  {name}: {json.dumps(res[name])}", flush=True)
    _cuda.reset_launches()
    return res


def tail_bytes(out_cf, tid, out_chans, texture=None):
    """Bytes the texture tail must move: every pixel's id and RGBA, the
    output planes of each covered pixel and, on a textured plan (a repeat
    texture), each quad-table row a covered pixel reads, once."""
    cov = tid != -1
    n_cov = int(cov.sum())
    n_bytes = nbytes(tid) + tid.numel() * 16 + n_cov * out_cf.shape[0] * 4
    if texture is not None:
        names = [n for n, _ in out_chans]
        uv = sum(size for _, size in out_chans[:names.index("uv")])
        u, v = out_cf[uv], out_cf[uv + 1]
        th, tw, _ = texture.data.shape
        xa = torch.remainder(torch.floor(u * tw - 0.5).to(torch.int32), tw)
        ya = torch.remainder(torch.floor(v * th - 0.5).to(torch.int32), th)
        rows = torch.unique((ya * tw + xa)[cov]).numel()
        n_bytes += rows * texture.table.shape[1] * 4
    return n_bytes, n_cov


def phase_tail_kernel(dev):
    """The texture tail kernel (csrc/tail.cu) against finish_fused, its
    plain version, on config 4's frame 0 at 1920x1080 (textured
    Blinn-Phong, the 256x256 repeat checkerboard) and at 3840x2160 in
    untextured Phong (the 4K cell's plan): bit for bit, times by graph
    replay, bounds, and the launches of two frames through render()."""
    res = {}
    for key, size, textured in (("tail", (1920, 1080), True),
                                ("tail_uhd", (3840, 2160), False)):
        rp = scenes.config4_many_objects(0.0, width=size[0], height=size[1],
                                         textured=textured, device=dev)
        ps, chans, attrs, prm, has_light, has_texture = triangle_inputs(rp)
        _, tid, out = tb.fused_pipeline(
            ps, attrs, prm, width=rp.width, height=rp.height, chans=chans,
            has_light=has_light, has_texture=has_texture,
            pair_budget_factor=BUDGET)
        oc = fused_output_channels(rp.shading, chans, has_light, has_texture)
        kw = dict(out_chans=oc, light=rp.light, texture=rp.texture)
        assert tsh.tail_kernel_plan(out, **kw) is not None, oc
        cov = tid != -1
        k = tsh.tail_kernel(out, tid, **kw)
        p = tsh.finish_fused(out, cov, **kw)
        sync()
        assert_bit_equal(k.view(torch.int32), p.view(torch.int32),
                         f"{key} vs finish_fused")
        n_bytes, n_cov = tail_bytes(out, tid, oc,
                                    rp.texture if textured else None)
        _cuda.reset_launches()
        for i in (0, 100):
            render(dataclasses.replace(rp, transform=bench_transform(
                rp.transform, i)))
        sync()
        launched = _cuda.launches["tail"]
        assert launched == 2 and _cuda.launches["fused"] == 2, launched
        res[key] = dict(
            max_abs_err=max_err(k, p),
            ms=graph_ms(lambda: tsh.tail_kernel(out, tid, **kw), 50),
            plain_ms=graph_ms(lambda: tsh.finish_fused(out, cov, **kw), 10),
            launches_2_frames=launched,
            shape=f"{rp.width}x{rp.height}, {n_cov} covered, planes "
                  f"{[n for n, _ in oc]}"
                  + (f", texture {tuple(rp.texture.data.shape)} "
                     f"{rp.texture.wrap}" if textured else ""),
            **bound(n_bytes, 0))
        print(f"  {key}: {json.dumps(res[key])}", flush=True)
        del out, tid, k, p
    _cuda.reset_launches()
    return res


def phase_windowed_modes(dev, card):
    """The 8 main-path frames through render() under each sampler route,
    counters reset per mode; mode "1" launches K7 once a frame and gives
    mode "0"'s frames in alpha and depth bit for bit."""
    rp = scenes.config4_many_objects(0.0, device=dev)
    passes = [dataclasses.replace(rp, transform=bench_transform(
        rp.transform, i)) for i in MAIN_FRAMES]
    frames, launches, ms = {}, {}, {}
    # The profiler's first start takes seconds (CUPTI set-up): start it
    # once before the profiled frames, so their host clocks compare.
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        sync()
    for mode in ("0", "1", "adaptive"):
        ttex.TEX_WINDOWED = mode
        render(passes[0])  # warm-up
        sync()
        _cuda.reset_launches()
        times, host, fbs = [], [], []
        for p in passes:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            fbs.append(render(p))
            end.record()
            sync()
            host.append((time.perf_counter() - t0) * 1e3)
            times.append(start.elapsed_time(end))
        launches[mode] = dict(_cuda.launches)
        frames[mode], ms[mode] = fbs, times
        print(f"SR_TEX_WINDOWED={mode}: {len(passes)} config-4 frames, "
              f"sampler launches {launches[mode]['sampler']}; ms/frame (CUDA "
              f"events, {card}): {times}; mean {sum(times) / len(times)}; "
              f"host clock to synchronize: {host}", flush=True)
        # Where the 8 frames' time goes, on the device and on the host, per
        # route (the adaptive route has had frames far slower than its
        # mean).
        top_device_ops(lambda: [render(p) for p in passes],
                       f"{len(passes)} frames, SR_TEX_WINDOWED={mode}")
    ttex.TEX_WINDOWED = "0"
    assert launches["0"]["sampler"] == 0
    assert launches["1"]["sampler"] == len(passes), launches["1"]
    for mode in ("1", "adaptive"):
        err = 0.0
        for i, a, b in zip(MAIN_FRAMES, frames["0"], frames[mode]):
            assert_bit_equal(b.color[..., 3], a.color[..., 3],
                             f"mode {mode} frame {i} alpha")
            assert_bit_equal(b.depth, a.depth, f"mode {mode} frame {i} depth")
            assert bool(torch.isfinite(b.color).all())
            err = max(err, max_err(b.color, a.color))
        print(f"  mode {mode} frames equal mode 0's in alpha and depth; "
              f"color max |d| {err}", flush=True)
    return launches, ms


def top_device_ops(fn, what, n=6):
    """Run ``fn`` once under torch.profiler and print the ``n`` operators
    with the most device time (self time, ms) and the device total, then
    the same for host (CPU self) time, with the host clock of the run.
    Returns the device total (ms of kernels and copies), the count of
    kernels run and the count of copies and memsets."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        sync()
    wall = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    def host_us(e):
        return e.self_cpu_time_total

    # The device side lists the kernels (and copies) only: an operator's
    # self device time repeats its kernels' and would count them twice.
    avgs = prof.key_averages()
    kernels = [e for e in avgs
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(dev_us(e) for e in kernels) / 1e3
    copies = sum(e.count for e in kernels
                 if e.key.startswith(("Memcpy", "Memset")))
    n_kernels = sum(e.count for e in kernels) - copies
    for side, key, evts in (("device", dev_us, kernels),
                            ("host", host_us, list(avgs))):
        evts = sorted(evts, key=key, reverse=True)
        total = sum(key(e) for e in evts) / 1e3
        top = [(e.key[:60], round(key(e) / 1e3, 3), e.count)
               for e in evts[:n]]
        print(f"  profile of one {what}: {side} self time {total} ms"
              f"{f' (host clock {wall} ms)' if side == 'host' else ''}; "
              f"top (op, ms, calls): {top}", flush=True)
    return device_ms, n_kernels, copies


def phase_training(dev, card):
    """Texture training at config 4's full size: 4 frames, targets from
    render_batch with the true texture, TRAIN_STEPS steps from a flat 0.5
    texture in modes "0" and "1"."""
    rp = scenes.config4_many_objects(0.0, device=dev)
    ts = torch.stack([bench_transform(rp.transform, i)
                      for i in TRAIN_FRAMES])
    targets = render_batch(rp, ts).color
    sync()
    first, launches, ms = {}, {}, {}
    for mode in ("0", "1"):
        ttex.TEX_WINDOWED = mode
        tex = torch.full_like(rp.texture.data, 0.5)
        losses, times, per_step = [], [], []
        for step in range(TRAIN_STEPS):
            _cuda.reset_launches()
            t0 = time.perf_counter()
            tex, loss = texture_train_step(tex, rp, ts, targets, lr=TRAIN_LR)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
            per_step.append(_cuda.launches["sampler"])
            losses.append(float(loss))
            if step == 0:
                first[mode] = tex.clone()
        top_device_ops(lambda: texture_train_step(
            tex, rp, ts, targets, lr=TRAIN_LR),
            f"training step, SR_TEX_WINDOWED={mode}")
        assert bool(torch.isfinite(tex).all())
        launches[mode], ms[mode] = per_step, times
        print(f"training SR_TEX_WINDOWED={mode}: config4 {rp.width}x"
              f"{rp.height}, {len(TRAIN_FRAMES)} frames, lr {TRAIN_LR}: "
              f"losses {losses}; "
              f"sampler launches per step {per_step}; ms/step (host clock "
              f"to synchronize, {card}): {times}", flush=True)
        for a, b in zip(losses, losses[1:]):
            assert b < a, f"mode {mode}: the loss rose {a} -> {b}"
    ttex.TEX_WINDOWED = "0"
    assert all(n == 0 for n in launches["0"])
    assert all(n == len(TRAIN_FRAMES) for n in launches["1"]), launches
    diff = max_err(first["1"], first["0"])
    moved = float((first["0"] - 0.5).abs().max())
    print(f"  first step: texels moved up to {moved}; modes 0 and 1 agree "
          f"within {diff}", flush=True)
    assert diff <= TRAIN_TOL, f"first steps differ by {diff}"
    return launches, ms


def phase_probe():
    """The gather probe (K8) through its entry point, counters reset just
    before it."""
    _cuda.reset_launches()
    res = probe.main()
    sync()
    launches = dict(_cuda.launches)
    assert all(s[3] for s in res["shapes"]) and res["lookup_exact"]
    for k in ("take_along_axis", "window_lookup"):
        assert launches[k] > 0, f"{k} never launched by the probe"
    return launches


def corner_w_counts(rp):
    """(straddling triangles, those with one corner behind, wholly
    behind) of a frame: corners against the clip's plane w = CLIP_EPS."""
    tris = rp.mesh.triangles().long()
    w = tclip.transform_corners_clip(rp.mesh.positions[tris],
                                     rp.transform)[:, :, 3]
    n = (w < tclip.CLIP_EPS).sum(dim=1)
    return (int(((n > 0) & (n < 3)).sum()), int((n == 1).sum()),
            int((n == 3).sum()))


def camera_bins(setup, w, h):
    """The render path's bins of a frame (4 bands, kmax 48, the culled
    budget)."""
    return tb.build_bins(setup, width=w, height=h, kmax=tb.KMAX * 4,
                         pair_budget_factor=BUDGET, bands=4)


def phase_camera_kernels(dev):
    """K1 with the perspective flag and K2's perspective plan (static and
    seeded; K4 at 9 channels) against their plain versions at the camera
    path's shapes: config 4 under scenes.config4_camera at t = 0."""
    rp = scenes.config4_camera(0.0, device=dev)
    w, h = rp.width, rp.height
    res = {}
    _, chans, attrs, prm, _, _ = triangle_inputs(
        dataclasses.replace(rp, clip_near=False))
    t = rp.mesh.indices.numel() // 3
    cc = fe.corner_cols(rp.mesh.positions[rp.mesh.triangles().long()])
    cols = torch.stack([c for corner in cc for c in corner]).contiguous()
    m16 = rp.transform.reshape(16).contiguous()
    vals = torch.stack([v for chan in attrs for v in chan]).contiguous()
    fe_args = (cols, m16, vals, w, h)
    kw1 = dict(cull_backfaces=True, perspective=True)
    rk, tk = fe_table_kernel(*fe_args, **kw1)
    rpl, tpl = fe_table_plain(*fe_args, **kw1)
    sync()
    assert_bit_equal(rk, rpl, "K1 (perspective) rows")
    assert_bit_equal(tk, tpl, "K1 (perspective) stream table")
    a1 = len(attrs) + 1
    res["fe_persp"] = dict(
        max_abs_err=max(max_err(rk, rpl), max_err(tk, tpl)),
        ms=graph_ms(lambda: fe_table_kernel(*fe_args, **kw1), 50),
        launch_loop_ms=cuda_ms(lambda: fe_table_kernel(*fe_args, **kw1), 50),
        plain_ms=cuda_ms(lambda: fe_table_plain(*fe_args, **kw1), 5),
        shape=f"T={t}, A={len(attrs)} + 1/w",
        # The flag's own work: 3 reciprocals and a multiply per corner
        # value.
        **bound(nbytes(cols, m16, vals, rk, tk),
                (OPS_FE + OPS_FE_CHANNEL * a1 + 3 + 3 * len(attrs)) * t))

    setup, pv, chans, prm, _, _ = clip_inputs(rp)
    ps = fe.from_setup(setup)
    table, a, poison = fe.stream_table_planar(
        ps, fe.attribute_plane_cols(ps, fe.attr_corner_cols(pv)))
    assert a == a1
    info = camera_bins(ps, w, h)
    rows = tb.gather_stream(table, info.ids, poison).contiguous()
    bbox = fe.bbox_table(ps)
    kw = dict(width=w, height=h, chans=chans, has_light=True,
              has_texture=True, bands=4, bbox=bbox, perspective=True)
    zk, ik, ok = tb.fused_kernel(rows, info.bin_start, prm, **kw)
    zp, ip, op = tb.fused_plain(rows, info.bin_start, prm, **kw)
    sync()
    assert_bit_equal(ik, ip, "K2 (perspective) ids")
    assert_bit_equal(zk, zp, "K2 (perspective) depth")
    err = max_err(ok, op)
    assert err <= PLANE_TOL, f"K2 (perspective) planes differ by {err}"
    assert bool(torch.isfinite(ok).all()), "K2 (perspective): non-finite"
    # Per pixel beyond the plan's: the reciprocal of 1/w and a multiply per
    # channel read.
    pix_ops = 4 * a + OPS_EPILOGUE + a
    binned_px = bbox_pixels(bbox[binned_ids(info)], w, h)
    res["fused_persp"] = dict(
        max_abs_err=err,
        ms=graph_ms(lambda: tb.fused_kernel(rows, info.bin_start, prm, **kw),
                    20),
        launch_loop_ms=cuda_ms(lambda: tb.fused_kernel(
            rows, info.bin_start, prm, **kw), 20),
        plain_ms=cuda_ms(lambda: tb.fused_plain(rows, info.bin_start, prm,
                                                **kw), 2),
        shape=f"{live_pairs(info)} pairs in {info.bin_start.numel() - 1} "
              f"bins, {a} channels, [2T] = {ps.num_triangles} slots",
        **bound(nbytes(rows[:live_pairs(info)], info.bin_start, prm, zk, ik,
                       ok),
                OPS_TEST * binned_px + w * h * pix_ops))

    # The frame's own spills, as the main path runs them (the static
    # overflow list and the device count): K3, K4 at A + 1 channels, the
    # seeded plan.
    n_ov = int(info.n_overflow)
    assert n_ov > 0, "the camera frame does not spill"
    ov, slots = tb.overflow_ids(info.overflow_mask)
    ov_rows = tb.gather_stream(table, ov, poison).contiguous()
    rec = tb.raster_records(ov_rows, bbox, ov)
    z0 = torch.full((h, w), float("inf"), device=dev)
    i0 = torch.full((h, w), -1, dtype=torch.int32, device=dev)
    count = dict(width=w, height=h, n_live=info.n_overflow)
    z3, i3 = visibility_merge_kernel(rec, z0, i0, **count)
    g4 = tb.resolve_merge_kernel(ov_rows, i3, None, slots=slots, **count)
    g4p = tb.resolve_merge_plain(ov_rows, i3, None, slots=slots, **count)
    sync()
    err4 = max_err(g4[:, i3 >= 0], g4p[:, i3 >= 0])
    assert err4 <= PLANE_TOL, f"K4 at {a} channels differs by {err4}"
    k4 = bound(*resolve_merge_work(i3, slots, n_ov, a)[:2])
    k4_ms = graph_ms(lambda: tb.resolve_merge_kernel(
        ov_rows, i3, None, slots=slots, **count), 50)
    print(f"K4 at {a} channels on the camera spill ({n_ov} rows): {k4_ms} "
          f"ms (earlier {EARLIER_MS['resolve_merge_camera']}), bound "
          f"{k4['bound_ms']} ({k4['bound_by']}), {k4['least_ms'] / k4_ms} "
          f"of it; max |d| {err4}", flush=True)
    seeds = (z3, i3, g4)
    zs, is_, os_ = tb.fused_kernel(rows, info.bin_start, prm, seeds=seeds,
                                   n_overflow=info.n_overflow, **kw)
    zsp, isp, osp = tb.fused_plain(rows, info.bin_start, prm, seeds=seeds,
                                   n_overflow=info.n_overflow, **kw)
    sync()
    assert_bit_equal(is_, isp, "K2 (perspective, seeded) ids")
    assert_bit_equal(zs, zsp, "K2 (perspective, seeded) depth")
    errs = max_err(os_, osp)
    assert errs <= PLANE_TOL, f"K2 (perspective, seeded) differs by {errs}"
    assert bool(torch.isfinite(os_).all())
    res["fused_persp_seeded"] = dict(
        max_abs_err=errs,
        ms=graph_ms(lambda: tb.fused_kernel(
            rows, info.bin_start, prm, seeds=seeds,
            n_overflow=info.n_overflow, **kw), 20),
        plain_ms=cuda_ms(lambda: tb.fused_plain(
            rows, info.bin_start, prm, seeds=seeds,
            n_overflow=info.n_overflow, **kw), 2),
        resolve_merge_ms=k4_ms,
        resolve_merge_earlier_ms=EARLIER_MS["resolve_merge_camera"],
        resolve_merge_bound_ms=k4["bound_ms"],
        resolve_merge_max_abs_err=err4,
        shape=f"{live_pairs(info)} pairs, {n_ov} spilled, {a} channels",
        # The seed planes are read where the seed's id won the pixel.
        **bound(nbytes(rows[:live_pairs(info)], info.bin_start, prm, zs,
                       is_, os_, z3, i3)
                + int(((is_ == i3) & (i3 >= 0)).sum()) * a * 4,
                OPS_TEST * binned_px + w * h * pix_ops))
    print(f"camera kernels (config4_camera t=0, {w}x{h}, {ps.num_triangles} "
          f"slots, {int(ps.valid.sum())} valid; {live_pairs(info)} pairs, "
          f"{n_ov} spilled): K1 with the flag, K2's perspective plan "
          f"static and seeded, K4 at {a} channels equal their plain "
          f"versions", flush=True)
    for name in ("fe_persp", "fused_persp", "fused_persp_seeded"):
        print(f"  {name}: {json.dumps(res[name])}", flush=True)
    _cuda.reset_launches()
    return res


def phase_camera(dev, card):
    """The camera path at full size (phase 11 of the module docstring).
    Returns each path's launches."""
    passes = [scenes.config4_camera(t, device=dev) for t in CAMERA_TIMES]
    w, h = passes[0].width, passes[0].height
    for t, p in zip(CAMERA_TIMES, passes):
        straddle, one_behind, behind = corner_w_counts(p)
        setup = clip_inputs(p)[0]
        info = camera_bins(setup, w, h)
        n_tri = p.mesh.indices.numel() // 3
        print(f"camera t={t}: {straddle} straddling triangles ({one_behind} "
              f"with one corner behind: {straddle + one_behind} clipped "
              f"triangles), {behind} wholly behind; {int(setup.valid.sum())} "
              f"of {2 * n_tri} slots drawn; {live_pairs(info)} pairs, "
              f"{int(info.n_overflow)} spilled", flush=True)
        assert straddle >= MIN_STRADDLERS, f"t={t}: {straddle} straddlers"
    paths = {
        "clip_persp_0": ("0", lambda p: render(p)),
        "clip_persp_1": ("1", lambda p: render(p)),
        "persp_only": ("0", lambda p: render(dataclasses.replace(
            p, clip_near=False))),
        "clip_persp_pallas": ("0", lambda p: render(p, backend="pallas")),
        "clip_flat": ("0", lambda p: render(dataclasses.replace(
            p, shading="flat"))),
    }
    launches, frames = {}, {}
    for name, (mode, fn) in paths.items():
        ttex.TEX_WINDOWED = mode
        fn(passes[0])  # warm-up
        sync()
        _cuda.reset_launches()
        times, fbs = [], []
        for p in passes:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fbs.append(fn(p))
            end.record()
            sync()
            times.append(start.elapsed_time(end))
        launches[name] = dict(_cuda.launches)
        frames[name] = fbs
        bad = [int((~torch.isfinite(fb.color)).any(-1).sum()) for fb in fbs]
        cov = [float(fb.color[..., 3].mean()) for fb in fbs]
        print(f"camera {name} (SR_TEX_WINDOWED={mode}): t {list(CAMERA_TIMES)}"
              f", launches {json.dumps(launches[name])}", flush=True)
        print(f"  coverage per frame {cov}; non-finite color pixels {bad}",
              flush=True)
        print(f"  ms/frame (CUDA events, {card}): {times}; mean "
              f"{sum(times) / len(times)}", flush=True)
        dev_ms, n_kernels, n_copies = top_device_ops(
            lambda: [fn(p) for p in passes], f"{len(passes)} camera frames, "
            f"{name}")
        print(f"  device ms/frame (profiled kernels, {card}): "
              f"{dev_ms / len(passes)}; device kernels/frame "
              f"{n_kernels / len(passes)}, copies and memsets/frame "
              f"{n_copies / len(passes)}", flush=True)
        assert all(n == 0 for n in bad), f"{name}: non-finite colors {bad}"
        assert all(c > 0 for c in cov), f"{name}: a frame covered nothing"
    ttex.TEX_WINDOWED = "0"
    n = len(passes)
    need = {"clip_persp_0": {"fused_persp": n},
            "clip_persp_1": {"fused_persp": n, "sampler": n},
            "persp_only": {"fe_persp": n, "fused_persp": n},
            "clip_persp_pallas": {"visibility": n},
            "clip_flat": {"binned_vis": n}}
    for name, counts in need.items():
        for k, v in counts.items():
            assert launches[name][k] == v, (name, k, launches[name])
    for name in ("clip_persp_0", "clip_persp_1", "clip_persp_pallas",
                 "clip_flat"):
        assert launches[name]["fe"] == 0, (name, launches[name])
    for k in ("fused_persp_seeded", "visibility_merge", "resolve_merge"):
        assert launches["clip_persp_0"][k] > 0, (k, launches["clip_persp_0"])
    assert launches["clip_persp_pallas"]["fused"] == 0
    assert launches["clip_flat"]["fused"] == 0

    for t, p, a, c, f in zip(CAMERA_TIMES, passes, frames["clip_persp_0"],
                             frames["clip_persp_pallas"],
                             frames["clip_flat"]):
        setup, pv, chans, prm, lit, tex = clip_inputs(p)
        d2, i2, _ = tb.fused_pipeline(setup, pv, prm, width=w, height=h,
                                      chans=chans, has_light=lit,
                                      has_texture=tex, perspective=True,
                                      pair_budget_factor=BUDGET)
        d3, i3 = visibility_pallas(setup, width=w, height=h)
        sync()
        assert_bit_equal(i2, i3, f"camera t={t}: K2 vs K3' ids")
        assert_bit_equal(d2, d3, f"camera t={t}: K2 vs K3' depth")
        for what, fb in (("pallas", c), ("flat", f)):
            assert_bit_equal(fb.depth, a.depth, f"camera t={t}: {what} depth")
            assert_bit_equal(fb.color[..., 3], a.color[..., 3],
                             f"camera t={t}: {what} alpha")
        print(f"camera t={t}: (depth, id) equal across K2 and K3'; coverage "
              f"{float((i3 >= 0).float().mean())}", flush=True)

    # Case 0 at full width: config 4's own frame has every corner in front
    # (w >= 1.44), so the clip changes no bit, with or without
    # perspective-correct attributes.
    rp = scenes.config4_many_objects(0.0, device=dev)
    assert corner_w_counts(rp) == (0, 0, 0)
    for persp in (False, True):
        base = dataclasses.replace(rp, perspective_correct=persp)
        fa = render(base)
        fb = render(dataclasses.replace(base, clip_near=True))
        sync()
        assert_bit_equal(fb.color, fa.color, f"case 0 color (persp {persp})")
        assert_bit_equal(fb.depth, fa.depth, f"case 0 depth (persp {persp})")
    print(f"case 0 at {rp.width}x{rp.height}: config 4 frame 0 with and "
          f"without clip_near bit-equal (perspective off and on)", flush=True)
    return launches


def timed_frames(fn, items):
    """(outputs, ms of each) of ``fn(item)`` per item, by CUDA events
    around each call (each ends in a synchronize)."""
    outs, times = [], []
    for it in items:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs.append(fn(it))
        end.record()
        sync()
        times.append(start.elapsed_time(end))
    return outs, times


def tie_class_diff(color_a, color_b, depth_a, depth_b, *, atol,
                   tie_rtol=1e-4, max_diff_frac=0.005):
    """The JAX package's testing/compare.py ``assert_tie_class_equal`` in
    torch: few pixels differ, and every pixel whose color or depth
    differs beyond ``atol`` has the same depth in both frames to
    ``tie_rtol`` (a flipped depth tie), never a different surface.
    Returns the count of differing pixels."""
    bad_c = ~torch.isclose(color_a, color_b, atol=atol).all(-1)
    bad_d = ~torch.isclose(depth_a, depth_b, atol=atol)
    assert float(bad_c.float().mean()) <= max_diff_frac, "color differs"
    assert float(bad_d.float().mean()) <= max_diff_frac, "depth differs"
    diff = bad_c | bad_d
    da, db = depth_a[diff], depth_b[diff]
    both_inf = torch.isinf(da) & torch.isinf(db)
    both_fin = torch.isfinite(da) & torch.isfinite(db)
    scale = torch.maximum(da.abs(), db.abs()).clamp(min=1e-6)
    tie = both_inf | (both_fin & ((da - db).abs() <= tie_rtol * scale))
    assert bool(tie.all()), f"{int((~tie).sum())} pixels are not ties"
    return int(diff.sum())


def profile_per_frame(fn, n, what, card):
    dev_ms, n_kernels, n_copies = top_device_ops(fn, what)
    print(f"  device ms/frame (profiled kernels, {card}): {dev_ms / n}; "
          f"device kernels/frame {n_kernels / n}, copies and memsets/frame "
          f"{n_copies / n}", flush=True)
    return dev_ms / n, n_kernels / n


def with_trilinear(rp):
    return dataclasses.replace(rp, texture=ttex.Texture(
        data=rp.texture.data, filter="trilinear", wrap=rp.texture.wrap))


def phase_trilinear(dev, card):
    """12a: the 8 main-path frames with the texture trilinear on auto,
    and frame 0 on pallas; alpha and depth equal the bilinear frames',
    card equals CPU at phase 6's size, and the trilinear tail's device
    time against mode "0"'s bilinear tail."""
    rp = scenes.config4_many_objects(0.0, device=dev)
    passes = [dataclasses.replace(rp, transform=bench_transform(
        rp.transform, i)) for i in MAIN_FRAMES]
    tri = [with_trilinear(p) for p in passes]
    ttex.TEX_WINDOWED = "0"
    render(tri[0])  # warm-up
    sync()
    _cuda.reset_launches()
    fbs, times = timed_frames(render, tri)
    launches = dict(_cuda.launches)
    bil, _ = timed_frames(render, passes)
    moved = 0.0
    for i, a, b in zip(MAIN_FRAMES, bil, fbs):
        assert_bit_equal(b.color[..., 3], a.color[..., 3],
                         f"trilinear frame {i} alpha")
        assert_bit_equal(b.depth, a.depth, f"trilinear frame {i} depth")
        assert bool(torch.isfinite(b.color).all()), f"frame {i}: non-finite"
        moved = max(moved, max_err(b.color, a.color))
    print(f"trilinear: {len(tri)} config-4 frames {list(MAIN_FRAMES)} on "
          f"auto, launches {json.dumps(launches)}; alpha and depth equal the "
          f"bilinear frames', color moved up to {moved}", flush=True)
    print(f"  ms/frame (CUDA events, {card}): {times}; mean "
          f"{sum(times) / len(times)}", flush=True)
    profile_per_frame(lambda: [render(p) for p in tri], len(tri),
                      f"{len(tri)} trilinear frames", card)
    _cuda.reset_launches()
    fb_p = render(tri[0], backend="pallas")
    sync()
    pallas_launches = dict(_cuda.launches)
    assert pallas_launches["fe"] == 1 and pallas_launches["visibility"] == 1
    assert_bit_equal(fb_p.color[..., 3], fbs[0].color[..., 3],
                     "trilinear pallas alpha")
    assert_bit_equal(fb_p.depth, fbs[0].depth, "trilinear pallas depth")
    assert bool(torch.isfinite(fb_p.color).all())
    print(f"  pallas frame 0: launches {json.dumps(pallas_launches)}; alpha "
          f"and depth equal auto's; color max |d| "
          f"{max_err(fb_p.color, fbs[0].color)}", flush=True)
    # The texture tails alone on frame 0's planes.
    tex, u, v, covered = frame0_uv(dev)
    tri_tex = with_trilinear(rp).texture
    tail_ms = graph_ms(lambda: ttex.sample_texture_planes_trilinear_compacted(
        tri_tex, u, v, covered), 10)
    bil_ms = graph_ms(lambda: ttex.sample_texture_planes_compacted(
        tex, u, v, covered), 10)
    print(f"  texture tail device ms (CUDA-graph replay, frame 0, {card}): "
          f"trilinear {tail_ms}, mode \"0\" bilinear {bil_ms}, ratio "
          f"{tail_ms / bil_ms}", flush=True)
    rp_c = with_trilinear(scenes.config4_many_objects(
        0.3, width=320, height=192, triangles=3000, device="cpu"))
    for backend in ("auto", "pallas"):
        fb_c = render(rp_c, backend=backend)
        fb_g = render(rp_c.to(dev), backend=backend)
        sync()
        cg = fb_g.color.cpu()
        assert_bit_equal(cg[..., 3], fb_c.color[..., 3], "small trilinear")
        assert_bit_equal(fb_g.depth.cpu(), fb_c.depth, "small trilinear")
        err = max_err(cg, fb_c.color)
        assert err <= 1e-3, f"small trilinear {backend}: color {err}"
        print(f"  small trilinear (320x192, 3000 tris, {backend}): card == "
              f"CPU in alpha and depth, color max |d| {err}", flush=True)
    assert launches["fe"] == len(tri), launches
    assert launches["fused"] == len(tri), launches
    return launches


def phase_rows(dev, card):
    """12b: render_rows of config 4 at 1080p in four 270-row bands and the
    ragged band, frames 0 and 120 on auto and pallas and frame 0 flat; the
    stitched bands equal the full frame (alpha and ids exact, depth and
    color in the tie class, and whether bit for bit)."""
    rp = scenes.config4_many_objects(0.0, device=dev)
    w, h = rp.width, rp.height
    frames = {i: dataclasses.replace(rp, transform=bench_transform(
        rp.transform, i)) for i in ROW_FRAMES}
    paths = {"auto": ("auto", "textured", ROW_FRAMES),
             "pallas": ("pallas", "textured", ROW_FRAMES),
             "flat": ("auto", "flat", ROW_FRAMES[:1])}
    bands = ROW_BANDS + (RAGGED_BAND,)

    def ids_of(p, path, y0, rows):
        ps, chans, attrs, prm, lit, tex = triangle_inputs(p)
        kw = dict(width=w, height=rows, y_start=y0)
        if path == "auto":
            return tb.fused_pipeline(ps, attrs, prm, chans=chans,
                                     has_light=lit, has_texture=tex,
                                     pair_budget_factor=BUDGET, **kw)[:2]
        if path == "pallas":
            return visibility_pallas(fe.to_setup(ps), **kw)
        return tb.visibility_binned(ps, pair_budget_factor=BUDGET, **kw)

    launches = {}
    for path, (backend, shading, idx) in paths.items():
        ps_ = [dataclasses.replace(frames[i], shading=shading) for i in idx]
        render_rows(ps_[0], 0, 270, backend=backend)  # warm-up
        sync()
        _cuda.reset_launches()
        out, times = timed_frames(lambda p: [
            render_rows(p, y0, rows, backend=backend) for y0, rows in bands],
            ps_)
        launches[path] = dict(_cuda.launches)
        print(f"render_rows {path}: frames {list(idx)}, bands "
              f"{list(bands)}, launches {json.dumps(launches[path])}; ms per "
              f"frame of 5 bands (CUDA events, {card}): {times}", flush=True)
        profile_per_frame(lambda: [render_rows(p, y0, rows, backend=backend)
                                   for p in ps_ for y0, rows in bands],
                          len(ps_), f"{len(ps_)} frames of 5 bands, {path}",
                          card)
        for i, p, fbs in zip(idx, ps_, out):
            full = render(p, backend=backend)
            color = torch.cat([fb.color for fb in fbs[:4]])
            depth = torch.cat([fb.depth for fb in fbs[:4]])
            y0, rows = RAGGED_BAND
            rag = slice(y0, y0 + rows)
            for what, c, d, fc, fd in (
                    ("4 bands", color, depth, full.color, full.depth),
                    ("ragged", fbs[4].color, fbs[4].depth, full.color[rag],
                     full.depth[rag])):
                assert bool(torch.isfinite(c).all())
                assert_bit_equal(c[..., 3], fc[..., 3],
                                 f"rows {path} frame {i} {what} alpha")
                n_diff = tie_class_diff(c, fc, d, fd, atol=1e-6)
                bit = bool((c == fc).all()) and bool((d == fd).all())
                print(f"  frame {i} {what}: alpha exact, depth and color in "
                      f"the tie class ({n_diff} pixels differ); bit-equal "
                      f"{bit}", flush=True)
            _, ids_full = ids_of(p, path, 0, h)
            for y0, rows in bands:
                _, ids = ids_of(p, path, y0, rows)
                assert_bit_equal(ids, ids_full[y0:y0 + rows],
                                 f"rows {path} frame {i} ids {y0}+{rows}")
        sync()
    need = {"auto": ("fe", "fused"), "pallas": ("fe", "visibility"),
            "flat": ("fe", "binned_vis")}
    for path, ks in need.items():
        for k in ks:
            assert launches[path][k] > 0, f"{k} never launched on " \
                f"render_rows {path}"
    print("  band ids equal the full frame's on every path", flush=True)
    return launches


def phase_msaa(dev, card):
    """12c: render_msaa(samples=2) of config 4 at 1080p (3840x2160
    inside), frames 0 and 120."""
    rp = scenes.config4_many_objects(0.0, device=dev)
    passes = [dataclasses.replace(rp, transform=bench_transform(
        rp.transform, i)) for i in MSAA_FRAMES]
    render_msaa(passes[0], 2)  # warm-up
    sync()
    _cuda.reset_launches()
    fbs, times = timed_frames(lambda p: render_msaa(p, 2), passes)
    launches = dict(_cuda.launches)
    print(f"render_msaa x2: frames {list(MSAA_FRAMES)} of config 4 at "
          f"{rp.width}x{rp.height} ({2 * rp.width}x{2 * rp.height} inside), "
          f"launches {json.dumps(launches)}; ms/frame (CUDA events, {card}): "
          f"{times}", flush=True)
    for i, p, fb in zip(MSAA_FRAMES, passes, fbs):
        assert fb.color.shape == (rp.height, rp.width, 4)
        assert bool(torch.isfinite(fb.color).all()), f"msaa {i}: non-finite"
        big = render(dataclasses.replace(p, width=2 * rp.width,
                                         height=2 * rp.height))
        assert_bit_equal(fb.depth, big.depth.reshape(
            rp.height, 2, rp.width, 2).amin(dim=(1, 3)), f"msaa {i} depth")
        assert_bit_equal(fb.color, downsample_box(big.color, 2),
                         f"msaa {i} color")
        print(f"  frame {i}: depth the min and color the mean of the 2x2 "
              f"blocks of the 4K frame (coverage {float((big.depth < float('inf')).float().mean())})",
              flush=True)
    profile_per_frame(lambda: [render_msaa(p, 2) for p in passes],
                      len(passes), f"{len(passes)} msaa x2 frames", card)
    rp_c = scenes.config4_many_objects(0.0, width=160, height=96,
                                       triangles=3000, device="cpu")
    fb_c = render_msaa(rp_c, 2)
    fb_g = render_msaa(rp_c.to(dev), 2)
    sync()
    assert_bit_equal(fb_g.depth.cpu(), fb_c.depth, "small msaa depth")
    err = max_err(fb_g.color.cpu(), fb_c.color)
    assert err <= 1e-3, f"small msaa: color {err}"
    print(f"  small msaa (160x96, 3000 tris): card == CPU in depth, color max"
          f" |d| {err}", flush=True)
    assert launches["fe"] == len(passes), launches
    assert launches["fused"] == len(passes), launches
    return launches


def phase_lines(dev, card):
    """12d: the line and point primitives at 1080p, card frames equal to
    the CPU's bit for bit (the last writer wins on both)."""
    rp = scenes.config4_many_objects(0.0, device=dev)
    m = rp.mesh
    lines = dataclasses.replace(rp, primitive="line", mesh=Mesh(
        positions=m.positions, indices=m.indices[:LINE_INDICES],
        colors=m.colors))
    cases = {
        "wireframe_cube": [scenes.wireframe_cube(t, width=rp.width,
                                                 height=rp.height, device=dev)
                           for t in CUBE_TIMES],
        "config4_lines": [lines],
        "config4_points": [dataclasses.replace(rp, primitive="vertices")],
    }
    for name, passes in cases.items():
        render(passes[0])  # warm-up
        sync()
        fbs, times = timed_frames(render, passes)
        written = []
        for p, fb in zip(passes, fbs):
            fb_c = render(p.to("cpu"))
            assert_bit_equal(fb.color.cpu(), fb_c.color, f"{name} color")
            assert_bit_equal(fb.depth.cpu(), fb_c.depth, f"{name} depth")
            written.append(int((fb_c.color[..., 3] > 0).sum()))
        n = (p.mesh.indices.numel() // (2 if p.primitive == "line" else 1))
        print(f"{name}: {len(passes)} frames at {rp.width}x{rp.height}, "
              f"{n} {'lines' if p.primitive == 'line' else 'points'} a frame;"
              f" card == CPU bit for bit; pixels written {written}; ms/frame "
              f"(CUDA events, {card}): {times}", flush=True)
        profile_per_frame(lambda: [render(p) for p in passes], len(passes),
                          f"{len(passes)} {name} frames", card)
        assert all(x > 0 for x in written), name


def phase_formats(dev, card):
    """12e: every pixel format, resize and the 2D primitives on phase 5's
    frame 0, card against CPU."""
    rp = scenes.config4_many_objects(0.0, device=dev)
    color = render(rp).color
    cpu = color.cpu()
    for fmt in PIXEL_FORMATS:
        ec = encode_pixels(cpu, fmt)
        eg = encode_pixels(color, fmt)
        assert eg.dtype == ec.dtype, fmt
        d = float((eg.cpu().to(torch.float64)
                   - ec.to(torch.float64)).abs().max())
        assert d <= (1 if fmt == "gray8" else 0), (fmt, d)
        assert_bit_equal(decode_pixels(ec.to(dev), fmt).cpu(),
                         decode_pixels(ec, fmt), f"{fmt} decode")
    print(f"pixel formats {sorted(PIXEL_FORMATS)}: card == CPU (gray8 within "
          f"1 LSB) on frame 0", flush=True)
    for out in RESIZE_SIZES:
        bg = resize_bilinear(color, *out)
        err = max_err(bg.cpu(), resize_bilinear(cpu, *out))
        assert err <= RESIZE_TOL, f"resize_bilinear {out}: {err}"
        assert_bit_equal(resize_nearest(color, *out).cpu(),
                         resize_nearest(cpu, *out), f"resize_nearest {out}")
        print(f"  resize to {out[1]}x{out[0]}: bilinear card vs CPU max |d| "
              f"{err}, nearest bit-equal; bilinear "
              f"{graph_ms(lambda: resize_bilinear(color, *out), 5)} ms, "
              f"nearest {graph_ms(lambda: resize_nearest(color, *out), 5)} "
              f"ms (CUDA-graph replay, {card})", flush=True)
    draws = {
        "rect": lambda im: p2.draw_rect(im, 100.5, 80.0, 900.0, 333.25,
                                        (1.0, 0.2, 0.0, 0.7)),
        "circle": lambda im: p2.draw_circle(im, 960.0, 540.5, 300.0,
                                            (0.0, 0.0, 1.0)),
        "line": lambda im: p2.draw_line(im, 3.0, 1070.0, 1910.0, 5.0,
                                        (0.0, 1.0, 0.0)),
        "triangle2d": lambda im: p2.draw_triangle2d(
            im, (960.0, 20.5), (30.0, 1050.0), (1890.5, 900.0)),
    }
    for name, draw in draws.items():
        assert_bit_equal(draw(color).cpu(), draw(cpu), f"2D {name}")
    print(f"  2D primitives {list(draws)} on the 1080p frame: card == CPU "
          f"bit for bit", flush=True)


def phase_surface(dev, card):
    """Phase 12 (the module docstring): each path with the launch
    counters reset just before it and read just after."""
    launches = {"trilinear": phase_trilinear(dev, card)}
    sync()
    launches.update({f"rows_{k}": v for k, v in phase_rows(dev, card).items()})
    sync()
    launches["msaa"] = phase_msaa(dev, card)
    sync()
    phase_lines(dev, card)
    sync()
    phase_formats(dev, card)
    sync()
    return launches


def reset_counts():
    sync()
    _cuda.reset_launches()


def read_counts(what, need=("fe", "fused")):
    """The counters after a part (K1 and K2 must have launched)."""
    sync()
    counts = dict(_cuda.launches)
    for k in need:
        assert counts[k] > 0, f"{k} never launched on {what}"
    return counts


def phase_frame_loop(dev, card, tmp):
    """13a: FrameLoop over LOOP_FRAMES frames of bench.py's animation at
    config 4's full size with the PNG sink (native runtime), the live
    viewer and no sink; the viewer's frame and the PNG files decode to
    to_rgba8 of the card frame bit for bit."""
    assert runtime.available(), "the native runtime did not build"
    rp = scenes.config4_many_objects(0.0, device=dev)
    base = rp.transform
    used = []

    def transform_fn(t):
        used.append(bench_transform(base, t * 60.0))
        return used[-1]

    cfg = RenderConfig(width=rp.width, height=rp.height, backend="auto",
                       time_step=1.0 / 60.0)
    FrameLoop(lambda t: rp, transform_fn, cfg).run(2, out_dir=tmp)  # warm
    img = to_rgba8(render(rp).color).cpu().numpy()
    enc = {}
    for name, write in (("native", runtime.write_png),
                        ("python", image_io.write_png)):
        t0 = time.perf_counter()
        for _ in range(3):
            write(os.path.join(tmp, f"enc_{name}.png"), img)
        enc[name] = (time.perf_counter() - t0) / 3 * 1e3
    assert np.array_equal(runtime.read_png(os.path.join(tmp,
                                                        "enc_native.png")),
                          img)
    print(f"PNG encode of one {rp.width}x{rp.height} RGBA8 frame (host "
          f"clock, mean of 3): native {enc['native']} ms, Python "
          f"{enc['python']} ms", flush=True)
    launches, out = {}, os.path.join(tmp, "frames")
    for sink in ("png", "viewer", "none"):
        loop = FrameLoop(lambda t: rp, transform_fn, cfg)
        used.clear()
        reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if sink == "viewer":
            with PresentServer() as srv:
                fps = loop.run(LOOP_FRAMES, present=srv)
                with urllib.request.urlopen(srv.url + "frame.png",
                                            timeout=30) as r:
                    png = r.read()
        else:
            fps = loop.run(LOOP_FRAMES,
                           out_dir=out if sink == "png" else None)
        end.record()
        launches[sink] = read_counts(f"FrameLoop ({sink})")
        assert launches[sink]["fe"] == LOOP_FRAMES, launches[sink]
        ms = start.elapsed_time(end) / LOOP_FRAMES
        print(f"FrameLoop, sink {sink}: {LOOP_FRAMES} frames of config4 "
              f"{rp.width}x{rp.height}: {fps} FPS (host clock, sink "
              f"included), {ms} ms/frame (CUDA events, {card}); launches "
              f"{json.dumps(launches[sink])}", flush=True)
        if sink == "viewer":
            want = to_rgba8(render(dataclasses.replace(
                rp, transform=used[-1])).color).cpu()
            got = torch.from_numpy(image_io.decode_png(png))
            assert_bit_equal(got, want, "viewer frame vs to_rgba8")
            print(f"  viewer: /frame.png of frame {len(used) - 1} equals "
                  f"to_rgba8 of the card frame bit for bit", flush=True)
        if sink == "png":
            files = sorted(os.listdir(out))
            assert len(files) == LOOP_FRAMES, files
            for i in (0, LOOP_FRAMES // 2, LOOP_FRAMES - 1):
                want = to_rgba8(render(dataclasses.replace(
                    rp, transform=used[i])).color).cpu()
                got = torch.from_numpy(runtime.read_png(
                    os.path.join(out, files[i])))
                assert_bit_equal(got, want, f"PNG frame {i} vs to_rgba8")
            print(f"  PNG: frames 0, {LOOP_FRAMES // 2} and "
                  f"{LOOP_FRAMES - 1} decode to to_rgba8 of the card frame "
                  f"bit for bit", flush=True)
    return launches


def phase_chunked(dev, card):
    """13b: render_batch_chunked of CHUNK_FRAMES frames (vmap_chunk
    VMAP_CHUNK) equals render_batch bit for bit; peak memory of each."""
    rp = scenes.config4_many_objects(0.0, device=dev)
    ts = torch.stack([bench_transform(rp.transform, i)
                      for i in range(CHUNK_FRAMES)])
    out, peak, ms, launches = {}, {}, {}, {}
    for name, fn in (("render_batch", lambda: render_batch(rp, ts)),
                     ("render_batch_chunked", lambda: render_batch_chunked(
                         rp, ts, vmap_chunk=VMAP_CHUNK))):
        reset_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        base_mem = torch.cuda.memory_allocated(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out[name] = fn()
        end.record()
        launches[name] = read_counts(name)
        peak[name] = torch.cuda.max_memory_allocated(dev) - base_mem
        ms[name] = start.elapsed_time(end) / CHUNK_FRAMES
        if name == "render_batch_chunked":
            ref = out["render_batch"]
            assert_bit_equal(out[name].color, ref.color, "chunked color")
            assert_bit_equal(out[name].depth, ref.depth, "chunked depth")
        print(f"{name}: {CHUNK_FRAMES} frames of config4 {rp.width}x"
              f"{rp.height}: peak memory above the scene "
              f"{peak[name] / 2**20} MiB (max_memory_allocated), "
              f"{ms[name]} ms/frame (CUDA events, {card}); launches "
              f"{json.dumps(launches[name])}", flush=True)
    print(f"  render_batch_chunked(vmap_chunk={VMAP_CHUNK}) equals "
          f"render_batch bit for bit", flush=True)
    return launches


def band_ids(rp, ps, y0, rows):
    """Triangle ids of rows [y0, y0 + rows) from K2 (fused_pipeline) over
    the front-end ``ps``, as render's main path computes them."""
    _, chans, attrs, prm, lit, tex = triangle_inputs(rp, ps)
    attrs = _pad_cols(attrs, ps.num_triangles)
    return tb.fused_pipeline(ps, attrs, prm, chans=chans, has_light=lit,
                             has_texture=tex, width=rp.width, height=rows,
                             y_start=y0, pair_budget_factor=BUDGET)[1]


def phase_sharded(dev, card):
    """13c: render_sharded of the MAIN_FRAMES on make_mesh(2, 4) of the
    one card (split front-end on and off) and on make_mesh(1, 1): alpha
    and ids equal render_batch's, depth and color in the tie class (and
    whether bit for bit); the gathered front-end and stream table equal
    the unsplit K1 launch's bit for bit. Each mesh is timed twice, in
    the order A B C C B A."""
    rp = scenes.config4_many_objects(0.0, device=dev)
    ts = torch.stack([bench_transform(rp.transform, i) for i in MAIN_FRAMES])
    ref = render_batch(rp, ts)
    meshes = {"2x4 split": (make_mesh(2, 4, [dev] * 8), True),
              "2x4 unsplit": (make_mesh(2, 4, [dev] * 8), False),
              "1x1": (make_mesh(1, 1), True)}
    render_sharded(rp, ts[:2], meshes["2x4 split"][0])  # warm-up
    launches, times = {}, {name: [] for name in meshes}
    # Each mesh twice, in the order A B C C B A, so that neither design
    # gains from running later in the call.
    for name in list(meshes) + list(reversed(meshes)):
        mesh, split = meshes[name]
        reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fb = render_sharded(rp, ts, mesh, shard_frontend=split)
        end.record()
        launches[name] = read_counts(f"render_sharded {name}")
        times[name].append(start.elapsed_time(end) / len(MAIN_FRAMES))
        if len(times[name]) == 2:
            print(f"render_sharded {name}: ms/frame (CUDA events, {card}) "
                  f"in the runs A B C C B A: {times[name]}", flush=True)
            continue
        assert bool(torch.isfinite(fb.color).all())
        assert_bit_equal(fb.color[..., 3], ref.color[..., 3],
                         f"sharded {name} alpha")
        n_diff = tie_class_diff(fb.color, ref.color, fb.depth, ref.depth,
                                atol=1e-6)
        bit = bool((fb.color == ref.color).all()) and bool(
            (fb.depth == ref.depth).all())
        print(f"render_sharded {name}: {len(MAIN_FRAMES)} frames of "
              f"config4 {rp.width}x{rp.height}, mesh {mesh.shape}: "
              f"{times[name][0]} ms/frame (CUDA events, {card}); alpha "
              f"exact, depth and color in the tie class ({n_diff} pixels "
              f"differ); bit-equal {bit}; launches "
              f"{json.dumps(launches[name])}", flush=True)
        if name != "1x1":
            profile_per_frame(lambda: render_sharded(
                rp, ts, mesh, shard_frontend=split), len(MAIN_FRAMES),
                f"{len(MAIN_FRAMES)} frames, render_sharded {name}", card)
    rows = rp.height // 4
    for i, t in enumerate(ts):
        p = dataclasses.replace(rp, transform=t)
        full = planar_front_of(p)
        table_rows, (table, n_chans, _) = planar_front_table_of(p)
        gathered, (g_table, g_chans, poison) = sharded_front(
            rp.to, t, [dev] * 4)[dev]
        n = full.num_triangles
        for f in dataclasses.fields(fe.PlanarSetup):
            g = getattr(gathered, f.name)
            assert_bit_equal(g[:n], getattr(full, f.name),
                             f"gathered front {f.name}")
            assert_bit_equal(g[:n], getattr(table_rows, f.name),
                             f"gathered front {f.name} vs the table launch")
        assert g_chans == n_chans
        assert_bit_equal(g_table[:n], table, "gathered stream table")
        assert not bool(gathered.valid[n:].any())
        assert_bit_equal(g_table[n:], poison.expand(len(g_table) - n, -1),
                         "gathered stream table padding")
        ids_full = band_ids(p, full, 0, p.height)
        for r in range(4):
            y0 = r * rows
            for what, ps in (("split", gathered), ("unsplit", full)):
                assert_bit_equal(band_ids(p, ps, y0, rows),
                                 ids_full[y0:y0 + rows],
                                 f"sharded ids {what} frame {i} band {r}")
    print(f"  gathered front-end and stream table ({gathered.num_triangles} "
          f"rows over 4 row shards, {n_chans} channels) equal the unsplit "
          f"K1 launch's ({n}) bit for bit on every frame; band ids equal "
          f"the full frame's", flush=True)
    return launches


def phase_train_mesh(dev, card):
    """13d: one texture_train_step in mode "1" on make_mesh(2, 2) of the
    one card against mesh=None (phase 9's frames): loss within rel
    TRAIN_TOL, texels within TRAIN_TOL."""
    rp = scenes.config4_many_objects(0.0, device=dev)
    ts = torch.stack([bench_transform(rp.transform, i)
                      for i in TRAIN_FRAMES])
    targets = render_batch(rp, ts).color
    tex0 = torch.full_like(rp.texture.data, 0.5)
    ttex.TEX_WINDOWED = "1"
    out, launches = {}, {}
    for name, mesh in (("none", None),
                       ("2x2", make_mesh(2, 2, [dev] * 4))):
        reset_counts()
        t0 = time.perf_counter()
        out[name] = texture_train_step(tex0, rp, ts, targets, mesh,
                                       lr=TRAIN_LR)
        launches[name] = read_counts(f"training, mesh {name}",
                                     ("fe", "fused", "sampler"))
        print(f"training step, mesh {name}, SR_TEX_WINDOWED=1: loss "
              f"{float(out[name][1])}, {(time.perf_counter() - t0) * 1e3} "
              f"ms (host clock to synchronize, {card}); launches "
              f"{json.dumps(launches[name])}", flush=True)
    ttex.TEX_WINDOWED = "0"
    (tex_a, loss_a), (tex_b, loss_b) = out["none"], out["2x2"]
    rel = abs(float(loss_b) - float(loss_a)) / float(loss_a)
    diff = max_err(tex_b, tex_a)
    print(f"  2x2 mesh vs none: loss rel {rel}, texels max |d| {diff}; "
          f"texels moved up to {float((tex_a - tex0).abs().max())}",
          flush=True)
    assert rel <= TRAIN_TOL and diff <= TRAIN_TOL, (rel, diff)
    return launches


def phase_teapot(dev, card):
    """13e: config 3 from the teapot generator (assets/teapot.obj
    ignored) at 1024x1024 through render; card vs CPU at phase 6's
    size."""
    obj = scenes.TEAPOT_OBJ
    scenes.TEAPOT_OBJ = obj.with_name("no_such_teapot.obj")
    try:
        rp = scenes.config3_phong_mesh(0.3, device=dev)
        small_c = scenes.config3_phong_mesh(0.3, width=320, height=192,
                                            device="cpu")
    finally:
        scenes.TEAPOT_OBJ = obj
    reset_counts()
    fb = render(rp)
    launches = read_counts("config 3 from the generator")
    cov = float(fb.color[..., 3].mean())
    assert bool(torch.isfinite(fb.color).all()) and cov > 0
    fb_c = render(small_c)
    fb_g = render(small_c.to(dev))
    sync()
    assert_bit_equal(fb_g.color[..., 3].cpu(), fb_c.color[..., 3],
                     "teapot small alpha")
    assert_bit_equal(fb_g.depth.cpu(), fb_c.depth, "teapot small depth")
    err = max_err(fb_g.color.cpu(), fb_c.color)
    assert err <= 1e-3, f"teapot small color differs by {err}"
    print(f"config 3 from teapot_mesh(9): T={rp.mesh.indices.numel() // 3}, "
          f"{rp.width}x{rp.height}, coverage {cov}, finite; card == CPU at "
          f"320x192 (alpha and depth bit for bit, color max |d| {err}); "
          f"launches {json.dumps(launches)}", flush=True)
    return launches


def phase_trace(dev, card, tmp):
    """13f: profiling.trace around two main-path frames: the Chrome trace
    holds the program's spans, sr.render and its layers, and K2's
    launches."""
    rp = scenes.config4_many_objects(0.0, device=dev)
    passes = [dataclasses.replace(rp, transform=bench_transform(
        rp.transform, i)) for i in (0, 1)]
    reset_counts()
    with profiling.trace(os.path.join(tmp, "trace")) as log_dir:
        for p in passes:
            render(p)
        sync()
    launches = read_counts("the traced frames")
    path = os.path.join(log_dir, profiling.TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events]
    spans = [n for n in names if n.startswith(profiling.PREFIX)]
    k2 = [e for e in events if e.get("cat") == "kernel"
          and "walk_kernel<true" in e.get("name", "")]
    print(f"trace: {path} ({os.path.getsize(path)} bytes, {len(events)} "
          f"events): spans {sorted(set(spans))}, {len(k2)} K2 kernel "
          f"events; launches {json.dumps(launches)}", flush=True)
    assert spans.count("sr.render") == 2, spans
    assert {f"sr.{k}" for k in ("front", "bins", "spill", "raster",
                                "texture_tail")} <= set(spans), spans
    assert len(k2) >= 2, "no K2 launch in the trace"
    return launches


def phase_bench(dev, card, main_ms):
    """13g: bench_frame of the main path (BENCH_ITERS frames)."""
    rp = scenes.config4_many_objects(0.0, device=dev)
    n = BENCH_ITERS + 3
    passes = [dataclasses.replace(rp, transform=bench_transform(
        rp.transform, i)) for i in range(n)]
    reset_counts()
    res = bench_frame(render, lambda i: (passes[i % n],),
                      name="config4 main path",
                      triangles=rp.mesh.indices.numel() // 3,
                      iters=BENCH_ITERS)
    launches = read_counts("bench_frame")
    print(f"bench_frame ({card}): {res} ; BenchResult "
          f"{json.dumps(dataclasses.asdict(res))}; phase 5's ms/frame "
          f"(CUDA events) {main_ms}", flush=True)
    return launches


def phase_host(dev, card, main_ms):
    """Phase 13 (the module docstring): each part with the counters reset
    just before it and read just after."""
    with tempfile.TemporaryDirectory(prefix="sr_smoke_") as tmp:
        launches = {"loop": phase_frame_loop(dev, card, tmp)}
        launches["chunked"] = phase_chunked(dev, card)
        launches["sharded"] = phase_sharded(dev, card)
        launches["train_mesh"] = phase_train_mesh(dev, card)
        launches["teapot"] = phase_teapot(dev, card)
        launches["trace"] = phase_trace(dev, card, tmp)
        launches["bench"] = phase_bench(dev, card, main_ms)
    return launches


def sync_count(fn):
    """Host syncs of ``fn()`` as torch's sync debug mode sees them: the
    synchronizing operations it reports in "warn" mode."""
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sync()
    return sum("called a synchronizing" in str(w.message) for w in got)


def sync_free(fn, what):
    """Run ``fn()`` under sync debug mode "error": a host sync raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        raise AssertionError(f"{what} syncs with the host: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sync()


def sync_routes(rp, passes):
    """{route: (frames, a function rendering them)} of every eager route
    that must make no host sync: the main path in modes "0" and "1" (the
    8 frames, spills included), flat shading and binned_pipeline with
    attributes (frames 0 and 120), the camera path (clip + perspective,
    both modes), render_rows bands (frames 0 and 120) and render_sharded
    on a 1 x 2 mesh of the card (frames 0 and 120, the split
    front-end)."""
    w, h = rp.width, rp.height
    spill = [p for i, p in zip(MAIN_FRAMES, passes) if i in (0, 120)]

    def in_mode(mode, fn):
        def run():
            ttex.TEX_WINDOWED = mode
            try:
                fn()
            finally:
                ttex.TEX_WINDOWED = "0"
        return run

    def pipeline(p):
        ps, table = planar_front_table_of(p)
        tb.binned_pipeline(ps, None, width=w, height=h, stream_table=table,
                           pair_budget_factor=BUDGET)

    dev = rp.transform.device
    cams = [scenes.config4_camera(t, device=dev) for t in CAMERA_TIMES[:2]]
    bands = ROW_BANDS + (RAGGED_BAND,)
    ts = torch.stack([p.transform for p in spill])
    mesh = make_mesh(1, 2, [dev, dev])
    routes = {
        "auto, mode 0": (len(passes), in_mode("0", lambda: [
            render(p) for p in passes])),
        "auto, mode 1": (len(passes), in_mode("1", lambda: [
            render(p) for p in passes])),
        "flat": (len(spill), lambda: [render(dataclasses.replace(
            p, shading="flat")) for p in spill]),
        "binned_pipeline": (len(spill), lambda: [pipeline(p)
                                                 for p in spill]),
        "camera, mode 0": (len(cams), in_mode("0", lambda: [
            render(c) for c in cams])),
        "camera, mode 1": (len(cams), in_mode("1", lambda: [
            render(c) for c in cams])),
        "render_rows": (len(spill) * len(bands), lambda: [
            render_rows(p, y0, n) for p in spill for y0, n in bands]),
        "render_sharded 1x2": (len(spill), lambda: render_sharded(
            rp, ts, mesh)),
    }
    return routes


def pipeline_frame(rp):
    """(depth, ids, planes) of the main path's geometry: K1's setup and
    stream table, then fused_pipeline, as render() runs them."""
    ps, table = planar_front_table_of(rp)
    chans, _, prm, lit, tex = shading_inputs(rp, with_attrs=False)
    return tb.fused_pipeline(ps, None, prm, chans=chans, has_light=lit,
                             has_texture=tex, width=rp.width,
                             height=rp.height, pair_budget_factor=BUDGET,
                             stream_table=table)


def replay_ids(rp, transforms):
    """The main path's geometry captured once on ``transforms[0]`` and
    replayed on each transform: [(depth, ids, planes)] (copies)."""
    static_t = transforms[0].clone()
    crp = dataclasses.replace(rp, transform=static_t)
    counts = dict(_cuda.launches)
    pipeline_frame(crp)
    sync()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pipeline_frame(crp)
    _cuda.launches.update(counts)
    got = []
    for t in transforms:
        static_t.copy_(t)
        graph.replay()
        got.append(tuple(x.clone() for x in out))
    sync()
    return got


def timed_turns(fns, passes, n_turns=2):
    """{name: [ms/frame by CUDA events, ms/frame by the host clock] of
    each turn}: every fn renders ``passes``, in turns (A B B A ...)."""
    order = list(fns) + list(fns)[::-1]
    out = {name: [] for name in fns}
    for name in order * (n_turns // 2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        sync()
        t0 = time.perf_counter()
        start.record()
        fns[name](passes)
        end.record()
        sync()
        out[name].append((start.elapsed_time(end) / len(passes),
                          (time.perf_counter() - t0) * 1e3 / len(passes)))
    return out


def phase_compiled(dev, card):
    """14: the compiled frame (module docstring)."""
    rp = scenes.config4_many_objects(0.0, device=dev)
    passes = [dataclasses.replace(rp, transform=bench_transform(
        rp.transform, i)) for i in MAIN_FRAMES]
    ts = torch.stack([p.transform for p in passes])
    res = {}

    # (a) Host syncs of the eager routes: counted in "warn" mode, then
    # each route again in "error" mode.
    syncs = {}
    for name, (n, fn) in sync_routes(rp, passes).items():
        fn()  # warm-up: the constants and the kernel library
        sync()
        syncs[name] = sync_count(fn) / n
        sync_free(fn, name)
    ttex.TEX_WINDOWED = "adaptive"
    try:
        render(passes[0])
        adaptive = sync_count(lambda: [render(p) for p in passes]) / len(
            passes)
    finally:
        ttex.TEX_WINDOWED = "0"
    print(f"host syncs per frame under sync debug mode (warn count; every "
          f"route also ran clean in \"error\" mode): {json.dumps(syncs)}; "
          f"\"adaptive\" (its one documented predicate read): {adaptive}",
          flush=True)
    assert all(v == 0 for v in syncs.values()), syncs
    assert adaptive <= 1, adaptive
    res["syncs_per_frame"] = dict(syncs, adaptive=adaptive)

    # (b) Replays equal the eager frames bit for bit: render_batch (one
    # capture on frame 0, spill frames 120, 240 and 600 replayed) in
    # modes "0" and "1"; ids through the main path's geometry captured
    # the same way; the counters hold the launches the device ran.
    for mode in ("0", "1"):
        ttex.TEX_WINDOWED = mode
        try:
            render(passes[0])
            reset_counts()
            eager = [render(p) for p in passes]
            eager_counts = read_counts(f"eager frames, mode {mode}")
            reset_counts()
            fg.reset_routes()
            batch = render_batch(rp, ts)
            batch_counts = read_counts(f"render_batch, mode {mode}")
            routes = dict(fg.routes)
        finally:
            ttex.TEX_WINDOWED = "0"
        assert routes == {"capture": 1, "replay": len(passes) - 1,
                          "eager": 0}, routes
        assert batch_counts == eager_counts, (batch_counts, eager_counts)
        for i, e, j in zip(MAIN_FRAMES, eager, range(len(passes))):
            for got, want, what in ((batch.color[j][..., 3],
                                     e.color[..., 3], "alpha"),
                                    (batch.depth[j], e.depth, "depth"),
                                    (batch.color[j], e.color, "color")):
                assert_bit_equal(got, want, f"replayed frame {i} (mode "
                                            f"{mode}) {what}")
        print(f"mode {mode}: render_batch of {len(passes)} frames "
              f"{list(MAIN_FRAMES)} (captured on frame 0, routes "
              f"{json.dumps(routes)}; captures evicted in the process: "
              f"{fg.evictions}) equals the eager frames in alpha, "
              f"depth and color bit for bit; launches equal the eager "
              f"frames' {json.dumps(batch_counts)}", flush=True)
    reset_counts()
    for i, (z, ids, out), p in zip(MAIN_FRAMES, replay_ids(rp, ts), passes):
        ze, ie, oe = pipeline_frame(p)
        assert_bit_equal(ids, ie, f"replayed frame {i} ids")
        assert_bit_equal(z, ze, f"replayed frame {i} geometry depth")
        assert_bit_equal(out, oe, f"replayed frame {i} planes")
    print(f"the main path's geometry captured on frame 0 and replayed: "
          f"ids, depth and planes of every frame equal the eager ones",
          flush=True)

    # (c) FrameLoop with a transform_fn replays; the camera path replays.
    loop_ts = [bench_transform(rp.transform, i) for i in range(4)]
    loop = FrameLoop(lambda t: rp, lambda t: loop_ts[round(t * 60)],
                     RenderConfig(width=rp.width, height=rp.height,
                                  time_step=1.0 / 60.0))
    fg.reset_routes()
    got = [loop.frame() for _ in loop_ts]
    assert dict(fg.routes) == {"capture": 1, "replay": 3, "eager": 0}, \
        fg.routes
    for i, (fb, t) in enumerate(zip(got, loop_ts)):
        want = render(dataclasses.replace(rp, transform=t))
        assert_bit_equal(fb.color, want.color, f"FrameLoop frame {i} color")
        assert_bit_equal(fb.depth, want.depth, f"FrameLoop frame {i} depth")
    cams = [scenes.config4_camera(t, device=dev) for t in CAMERA_TIMES[:3]]
    cam_batch = render_batch(cams[0], torch.stack([c.transform
                                                   for c in cams]))
    for j, c in enumerate(cams):
        want = render(dataclasses.replace(cams[0], transform=c.transform))
        assert_bit_equal(cam_batch.color[j], want.color,
                         f"camera frame {j} replayed, color")
        assert_bit_equal(cam_batch.depth[j], want.depth,
                         f"camera frame {j} replayed, depth")
    print(f"FrameLoop (transform_fn, {len(loop_ts)} frames) and "
          f"render_batch of {len(cams)} camera frames (clip + perspective) "
          f"replay bit for bit", flush=True)

    # (d) The eager route, counted: the adaptive sampler and a texture
    # that requires grad.
    fg.reset_routes()
    ttex.TEX_WINDOWED = "adaptive"
    try:
        render_batch(rp, ts[:2])
    finally:
        ttex.TEX_WINDOWED = "0"
    tex = dataclasses.replace(rp.texture, data=rp.texture.data.clone()
                              .requires_grad_(True))
    render_batch(dataclasses.replace(rp, texture=tex), ts[:2])
    print(f"eager route: render_batch of 2 frames under \"adaptive\" and "
          f"of 2 with a texture that requires grad: routes "
          f"{json.dumps(fg.routes)}", flush=True)
    assert fg.routes["eager"] == 4 and fg.routes["replay"] == 0, fg.routes
    res["eager_route"] = dict(fg.routes)

    # (e) ms/frame eager against replayed, in turns; device time and
    # kernels per frame of each.
    for mode in ("0", "1"):
        ttex.TEX_WINDOWED = mode
        try:
            graph = fg.FrameGraph()
            sync()
            t0 = time.perf_counter()
            graph(passes[0])
            sync()
            first_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            render(passes[0])
            sync()
            eager_ms = (time.perf_counter() - t0) * 1e3
            print(f"mode {mode}: the first frame of a FrameGraph (an eager "
                  f"frame and the capture) {first_ms} ms, an eager frame "
                  f"{eager_ms} ms (host clock to synchronize, {card})",
                  flush=True)
            res[f"capture_ms_mode_{mode}"] = first_ms
            fns = {"eager": lambda ps_: [render(p) for p in ps_],
                   "replay": lambda ps_: [graph(p) for p in ps_]}
            turns = timed_turns(fns, passes, 4)
            prof = {name: top_device_ops(lambda f=f: f(passes),
                                         f"{len(passes)} frames, {name}, "
                                         f"mode {mode}")
                    for name, f in fns.items()}
        finally:
            ttex.TEX_WINDOWED = "0"
        for name in fns:
            ev = [x for x, _ in turns[name]]
            host = [y for _, y in turns[name]]
            dev_ms, n_k, n_c = prof[name]
            res[f"{name}_mode_{mode}"] = dict(
                ms_events=ev, ms_host=host,
                device_ms=dev_ms / len(passes),
                kernels=n_k / len(passes), copies=n_c / len(passes))
            print(f"mode {mode}, {name}: ms/frame (CUDA events, {card}) "
                  f"{ev}, host clock {host}; device ms/frame "
                  f"{dev_ms / len(passes)} in {n_k / len(passes)} kernels "
                  f"and {n_c / len(passes)} copies a frame (profiled)",
                  flush=True)

    # (f) Peak memory of render_batch (16 frames) with the graph and of
    # the same frames rendered eagerly into preallocated outputs.
    ts16 = torch.stack([bench_transform(rp.transform, i)
                        for i in range(CHUNK_FRAMES)])

    def eager_batch():
        color = torch.empty((len(ts16), rp.height, rp.width, 4), device=dev)
        depth = torch.empty((len(ts16), rp.height, rp.width), device=dev)
        for i, t in enumerate(ts16):
            fb = render(dataclasses.replace(rp, transform=t))
            color[i], depth[i] = fb.color, fb.depth
            del fb
        return color, depth

    peak = {}
    for name, fn in (("render_batch (graph)", lambda: render_batch(rp, ts16)),
                     ("eager loop", eager_batch)):
        out = None
        sync()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base_mem = torch.cuda.memory_allocated(dev)
        out = fn()
        sync()
        peak[name] = (torch.cuda.max_memory_allocated(dev) - base_mem) / 2**20
        del out
    print(f"peak memory above the scene, {CHUNK_FRAMES} frames at "
          f"{rp.width}x{rp.height} (max_memory_allocated, MiB): "
          f"{json.dumps(peak)}", flush=True)
    res["peak_mib"] = peak
    return res


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()                                       # phase 1
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    t0 = time.perf_counter()                                 # phase 2
    so = _cuda.build(verbose=True)
    _cuda.lib()
    print(f"built {os.path.relpath(so)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    measure_launch_floor(dev)                                # phase 3
    res = phase_kernels(dev)
    res.update(phase_texture_kernels(dev))
    res.update(phase_tail_kernel(dev))
    res.update(phase_camera_kernels(dev))
    sync()
    phase_spill(dev)                                         # phase 4
    sync()
    launches, main_ms = phase_main(dev, card)                # phase 5
    sync()
    phase_small_reference(dev)                               # phase 6
    sync()
    backend_launches, _, k4_binned = phase_backends(dev, card)  # phase 7
    res["resolve_merge"]["binned_pipeline"] = k4_binned
    sync()
    mode_launches, _ = phase_windowed_modes(dev, card)       # phase 8
    sync()
    phase_training(dev, card)                                # phase 9
    sync()
    probe_launches = phase_probe()                           # phase 10
    sync()
    camera_launches = phase_camera(dev, card)                # phase 11
    sync()
    t12 = time.perf_counter()
    phase_surface(dev, card)                                 # phase 12
    sync()
    print(f"phase 12 took {time.perf_counter() - t12:.1f} s", flush=True)
    t13 = time.perf_counter()
    phase_host(dev, card, main_ms)                           # phase 13
    sync()
    print(f"phase 13 took {time.perf_counter() - t13:.1f} s", flush=True)
    t14 = time.perf_counter()
    phase_compiled(dev, card)                                # phase 14
    sync()
    print(f"phase 14 took {time.perf_counter() - t14:.1f} s", flush=True)

    src = "software_renderer_tpu_torch/csrc/"
    meta = {
        "fe": ("fe_table_kernel", "fe.cu",
               "software_renderer_tpu/ops/frontend_kernel.py:42"),
        "fused": ("fused_kernel", "fused.cu",
                  "software_renderer_tpu/ops/binning.py:703"),
        "visibility_merge": ("visibility_merge_kernel",
                             "visibility_merge.cu",
                             "software_renderer_tpu/ops/rasterize_pallas.py"
                             ":110"),
        "resolve_merge": ("resolve_merge_kernel", "resolve_merge.cu",
                          "software_renderer_tpu/ops/binning.py:683"),
        "visibility": ("visibility_kernel", "visibility_merge.cu",
                       "software_renderer_tpu/ops/rasterize_pallas.py:110"),
        "binned_vis": ("binned_vis_kernel", "fused.cu",
                       "software_renderer_tpu/ops/binning.py:607"),
        "resolve": ("resolve_kernel", "resolve.cu",
                    "software_renderer_tpu/ops/binning.py:663"),
        "sampler": ("sampler_kernel", "sampler.cu",
                    "software_renderer_tpu/ops/texture_kernel.py:226"),
        "window_lookup": ("window_lookup", "probe_gather.cu",
                          "tools/probe_dyngather.py:97"),
        "take_along_axis": ("take_along_axis", "probe_gather.cu",
                            "tools/probe_dyngather.py:69"),
        "fe_persp": ("fe_table_kernel(perspective=True)", "fe.cu",
                     "software_renderer_tpu/ops/frontend_kernel.py:42"),
        "fused_persp": ("fused_kernel(perspective=True)", "fused.cu",
                        "software_renderer_tpu/ops/binning.py:703"),
        "fused_persp_seeded": ("fused_kernel(perspective=True, seeds=...)",
                               "fused.cu",
                               "software_renderer_tpu/ops/binning.py:703"),
        "tail": ("tail_kernel", "tail.cu",
                 "software_renderer_tpu/ops/shading.py:301 (XLA)"),
        "tail_uhd": ("tail_kernel (4K, untextured)", "tail.cu",
                     "software_renderer_tpu/ops/shading.py:301 (XLA)"),
    }
    # Launches on the path that runs each kernel: the main path for K1-K4,
    # the pallas backend for K3', flat shading for K5,
    # binned_pipeline(ps, attrs) for K6, the main path under
    # SR_TEX_WINDOWED=1 for K7, the probe for K8 and the camera path for
    # the perspective instances of K1 and K2.
    path_launches = {k: launches[k] for k in
                     ("fe", "fused", "visibility_merge", "resolve_merge")}
    path_launches["visibility"] = backend_launches["pallas"]["visibility"]
    path_launches["binned_vis"] = backend_launches["flat"]["binned_vis"]
    path_launches["resolve"] = backend_launches["binned_pipeline"]["resolve"]
    path_launches["sampler"] = mode_launches["1"]["sampler"]
    for k in ("window_lookup", "take_along_axis"):
        path_launches[k] = probe_launches[k]
    # The camera path's: K1's flag with perspective alone, K2's
    # perspective plan with clip + perspective in mode "0".
    path_launches["fe_persp"] = camera_launches["persp_only"]["fe_persp"]
    for k in ("fused_persp", "fused_persp_seeded"):
        path_launches[k] = camera_launches["clip_persp_0"][k]
    # The tail kernel's: the main path's at 1080p, two 4K frames' at 4K.
    path_launches["tail"] = launches["tail"]
    path_launches["tail_uhd"] = res["tail_uhd"]["launches_2_frames"]
    assert all(n > 0 for n in path_launches.values()), path_launches
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "least_ms", "least_by")
    kernels = [dict(name=n, route="cuda", source=src + f, replaces=r,
                    launches=path_launches[k],
                    **{key: res[k][key] for key in keys})
               for k, (n, f, r) in meta.items()]
    # The redesign order of ROADMAP.md: kernels slower than one torch call
    # first, then by launches on their path x (ms - least_ms).
    excess = {k["name"]: k["launches"] * (k["ms"] - k["least_ms"])
              for k in kernels}
    order = sorted(kernels, key=lambda k: (
        k["library_ms"] is None or k["ms"] <= k["library_ms"],
        -excess[k["name"]]))
    print("redesign order [kernel, slower than one torch call, launches x "
          "(ms - least_ms)]: " + json.dumps([
              [k["name"], k["library_ms"] is not None
               and k["ms"] > k["library_ms"], excess[k["name"]]]
              for k in order]), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
