#!/usr/bin/env python3
"""Each hand-written kernel of the PyTorch/CUDA port
(software_renderer_tpu_torch) alone on one NVIDIA GPU, against its plain
PyTorch version and its least time.

    python3 chip_smoke.py

Whether the port is right on the card is the card tests' question
(``python -m pytest --noconftest -q tests/test_torch_cuda.py``), and how
fast its frames, calls and steps run end to end is the benchmark's
(BENCHMARK.json, benchmark/). This script answers what neither does: how
far each kernel, alone at the main path's shapes, is from the least time
the card could take.

Phases; any failure raises and the script exits non-zero without
printing a result:

1. the card's name and power limit (nvidia-smi);
2. build every kernel of the render path from csrc/ (nvcc, at first use);
3. each kernel against its plain PyTorch version on the same CUDA inputs
   at config-4 shapes (1920x1080, ~100k triangles): coverage, triangle id
   and depth bit-equal, the front-end's rows and stream table bit-equal,
   shaded planes within PLANE_TOL; each kernel's time by CUDA-graph replay
   (and of back-to-back calls), the plain version's by CUDA events; the
   texture tail kernel against finish_fused bit for bit, on config 4's
   frame 0 at 1920x1080 textured and at 3840x2160 untextured, both timed
   by graph replay; then the launches of each kernel on its path, one
   untimed frame per path with the counters reset before it: the main
   path on config 4's frame SPILL_FRAME (K1-K4 and the tail), the pallas
   backend (K3'), flat shading (K5), binned_pipeline with attributes
   (K6), SR_TEX_WINDOWED route "1" (K7), the gather probe (K8),
   config4_camera at t = 0 with perspective-correct attributes alone
   (K1's flag) and with the clip (the clip front-end kernel, K2's
   perspective plan, static and seeded), and config 4 at 3840x2160
   untextured (the 4K tail).

Phase 3 runs K2, K3 and K4 as the main path calls them: K2 seeded with
the frame's overflow count, which must equal the static walk bit for
bit and read no seed at a count of 0 (timed against the static launch
in turns), K3 and K4 over the static overflow list with the device
count (K3 equal to its run over the compact list, and both returning
their seeds at a count of 0). It also holds K1 with its perspective
flag, the clip front-end kernel (csrc/clip_front.cu, every field and
the table bit for bit, its bound the bytes alone) and K2's perspective
plan (static, and seeded from K3 and K4 at 9
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
the card's float32 rate (the benchmark's peaks, benchmark/benchlib/
peaks.py: NVIDIA's H100 SXM data sheet, at 700 W); its least time
(``least_ms``) also counts the launch floor, a one-element torch add by
CUDA-graph replay measured before phase 3 builds any kernel's inputs.
K4's bound counts what the function moves: every pixel's id, and per
live winner its slot and its plane writes, and the winning rows' planes;
at a count of 0 it moves nothing, so its least time is the launch floor.
Phase 3 times K4 on the kmax=1 spill, at a count of 0 and at 9 channels
on the camera spill, and holds binned_pipeline's G-buffer on frame
SPILL_FRAME against K6's planes with the plain K4 applied on the inputs
of the pipeline's own K4 call, timing K4 on them in place against the
out-of-place form. The last lines are the card line, one JSON line
describing the kernels, and {"ok": true, "device": {...}}. Imports
nothing of JAX.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from software_renderer_tpu_torch import _cuda, render
from software_renderer_tpu_torch.models import scenes
from software_renderer_tpu_torch.ops import binning as tb
from software_renderer_tpu_torch.ops import clip as tclip
from software_renderer_tpu_torch.ops import frontend as fe
from software_renderer_tpu_torch.ops import texture as ttex
from software_renderer_tpu_torch.ops import texture_kernel as ttk
from software_renderer_tpu_torch.ops import transforms as tf
from software_renderer_tpu_torch.ops.frontend_kernel import (
    fe_kernel, fe_table_kernel, fe_table_plain)
from software_renderer_tpu_torch.ops.rasterize_kernel import (
    _poison_row, visibility_kernel, visibility_merge_kernel,
    visibility_merge_plain, visibility_plain)
from software_renderer_tpu_torch.ops import shading as tsh
from software_renderer_tpu_torch.ops.shading import fused_output_channels
from software_renderer_tpu_torch.ops.clip import (clip_front_table,
                                                 clip_front_table_plain)
from software_renderer_tpu_torch.render import (clip_front_inputs,
                                               clip_inputs,
                                               planar_front_table_of,
                                               triangle_inputs)
from software_renderer_tpu_torch.tools import probe_dyngather as probe
from software_renderer_tpu_torch.tools.probe_dyngather import graph_ms
from software_renderer_tpu_torch.tools.sweep_binned import percentiles

# The card's peaks, as the benchmark's rooflines take them (benchmark/
# is found as its own run.py finds it: not a package of this checkout).
sys.path.append(str(Path(__file__).resolve().parent / "benchmark"))
from benchlib.peaks import F32_OPS_PER_S, HBM_BYTES_PER_S  # noqa: E402

# Shaded planes (kernel vs plain on the same card): both round every
# operation the same way; only powf may differ from torch.pow by an ulp
# or two, amplified at most by the color range 0..1.
PLANE_TOL = 1e-5
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
# per 256 triangles (K1, by graph replay), and
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
# The orbit frame (bench.py's transform) whose main path the launch
# counts and binned_pipeline's K4 row run: it spills at 1920x1080.
SPILL_FRAME = 120


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


def binned_pipeline_k4(p):
    """K4 as binned_pipeline launches it, on its own inputs: the pipeline
    runs on the pass ``p`` (with kmax=1 if it does not spill) with its K4
    call recorded; its G-buffer must equal K6's planes with the plain K4
    applied in place on the recorded inputs, bit for bit, and K4 is timed
    in place on them against the out-of-place form (the wrapper's clone of
    the seed, then the same launch)."""
    calls = []
    kernel = tb.resolve_merge_kernel

    def record(rows, tid, gb_in, **kw):
        calls.append((rows, tid, gb_in.clone(), kw))
        return kernel(rows, tid, gb_in, **kw)

    def run(kmax=tb.KMAX):
        ps, _, attrs, _, _, _ = triangle_inputs(p)
        calls.clear()
        tb.resolve_merge_kernel = record
        try:
            out = tb.binned_pipeline(ps, attrs, width=p.width,
                                     height=p.height, kmax=kmax,
                                     pair_budget_factor=BUDGET)
        finally:
            tb.resolve_merge_kernel = kernel
        (call,) = calls
        return int(call[3]["n_live"]), kmax, out, call

    n_ov, kmax, out, call = run()
    if n_ov == 0:
        n_ov, kmax, out, call = run(kmax=1)
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
    replay and bounds."""
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
        res[key] = dict(
            max_abs_err=max_err(k, p),
            ms=graph_ms(lambda: tsh.tail_kernel(out, tid, **kw), 50),
            plain_ms=graph_ms(lambda: tsh.finish_fused(out, cov, **kw), 10),
            shape=f"{rp.width}x{rp.height}, {n_cov} covered, planes "
                  f"{[n for n, _ in oc]}"
                  + (f", texture {tuple(rp.texture.data.shape)} "
                     f"{rp.texture.wrap}" if textured else ""),
            **bound(n_bytes, 0))
        print(f"  {key}: {json.dumps(res[key])}", flush=True)
        del out, tid, k, p
    _cuda.reset_launches()
    return res


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

    # The clip front-end kernel alone against its plain version, the
    # torch chain, on the same frame: every field and the table bit for
    # bit. Its least time is the bytes it must move: the mesh's indices
    # and vertex arrays read once, the [2T] rows, bbox, flags and table
    # written once.
    args, ckw = clip_front_inputs(rp)
    got = clip_front_table(*args, **ckw)
    want = clip_front_table_plain(*args, **ckw)
    sync()
    for f in dataclasses.fields(fe.PlanarSetup):
        assert_bit_equal(getattr(got[0], f.name), getattr(want[0], f.name),
                         f"clip front-end {f.name}")
    assert_bit_equal(got[1][0], want[1][0], "clip front-end stream table")
    cps, (ctab, _, _) = got
    out_bytes = (nbytes(ctab) + 4 * len(tclip.CLIP_ROWS) * cps.num_triangles
                 + nbytes(cps.bx0, cps.by0, cps.bx1, cps.by1, cps.valid,
                          cps.safe))
    in_bytes = nbytes(args[0], args[1], *(v for v, _ in args[2]))
    res["clip_front"] = dict(
        max_abs_err=0.0,
        ms=graph_ms(lambda: clip_front_table(*args, **ckw), 50),
        launch_loop_ms=cuda_ms(lambda: clip_front_table(*args, **ckw), 50),
        plain_ms=cuda_ms(lambda: clip_front_table_plain(*args, **ckw), 10),
        shape=f"T={t} -> {cps.num_triangles} slots, A={len(attrs)} + 1/w, "
              f"{int(cps.valid.sum())} valid; {in_bytes} bytes in, "
              f"{out_bytes} out",
        **bound(in_bytes + out_bytes, 0))
    del got, want, cps, ctab

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
          f"{n_ov} spilled): K1 with the flag, the clip front-end, K2's "
          f"perspective plan "
          f"static and seeded, K4 at {a} channels equal their plain "
          f"versions", flush=True)
    for name in ("fe_persp", "clip_front", "fused_persp",
                 "fused_persp_seeded"):
        print(f"  {name}: {json.dumps(res[name])}", flush=True)
    _cuda.reset_launches()
    return res


def spill_frame(dev):
    """Config 4 at 1920x1080 on frame SPILL_FRAME of bench.py's orbit."""
    rp = scenes.config4_many_objects(0.0, device=dev)
    return dataclasses.replace(rp, transform=bench_transform(rp.transform,
                                                             SPILL_FRAME))


def path_launches(dev):
    """{path: its launch counters}: one untimed frame per kernel's path
    (the module docstring), the counters reset just before it."""
    rp = spill_frame(dev)
    cam = scenes.config4_camera(0.0, device=dev)
    uhd = scenes.config4_many_objects(0.0, width=3840, height=2160,
                                      textured=False, device=dev)

    def pipeline():
        ps, table = planar_front_table_of(rp)
        tb.binned_pipeline(ps, None, width=rp.width, height=rp.height,
                           stream_table=table, pair_budget_factor=BUDGET)

    def route_1():
        saved, ttex.TEX_WINDOWED = ttex.TEX_WINDOWED, "1"
        try:
            render(rp)
        finally:
            ttex.TEX_WINDOWED = saved

    paths = {
        "main": lambda: render(rp),
        "pallas": lambda: render(rp, backend="pallas"),
        "flat": lambda: render(dataclasses.replace(rp, shading="flat")),
        "binned_pipeline": pipeline,
        "route 1": route_1,
        "probe": lambda: probe.run(dev),
        "perspective": lambda: render(dataclasses.replace(cam,
                                                          clip_near=False)),
        "clip + perspective": lambda: render(cam),
        "4K": lambda: render(uhd),
    }
    counts = {}
    for name, fn in paths.items():
        sync()
        _cuda.reset_launches()
        fn()
        sync()
        counts[name] = dict(_cuda.launches)
        print(f"launches on {name}: {json.dumps(counts[name])}", flush=True)
    return counts


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
    binned_pipeline_k4(spill_frame(dev))
    launches = path_launches(dev)
    sync()

    # Per row: the kernel, its source, what it replaces, and the path and
    # counter that give its launches on its path.
    src = "software_renderer_tpu_torch/csrc/"
    jax = "software_renderer_tpu/ops/"
    meta = {
        "fe": ("fe_table_kernel", "fe.cu", jax + "frontend_kernel.py:42",
               "main", "fe"),
        "fused": ("fused_kernel", "fused.cu", jax + "binning.py:703",
                  "main", "fused"),
        "visibility_merge": ("visibility_merge_kernel", "visibility_merge.cu",
                             jax + "rasterize_pallas.py:110", "main",
                             "visibility_merge"),
        "resolve_merge": ("resolve_merge_kernel", "resolve_merge.cu",
                          jax + "binning.py:683", "main", "resolve_merge"),
        "visibility": ("visibility_kernel", "visibility_merge.cu",
                       jax + "rasterize_pallas.py:110", "pallas",
                       "visibility"),
        "binned_vis": ("binned_vis_kernel", "fused.cu",
                       jax + "binning.py:607", "flat", "binned_vis"),
        "resolve": ("resolve_kernel", "resolve.cu", jax + "binning.py:663",
                    "binned_pipeline", "resolve"),
        "sampler": ("sampler_kernel", "sampler.cu",
                    jax + "texture_kernel.py:226", "route 1", "sampler"),
        "window_lookup": ("window_lookup", "probe_gather.cu",
                          "tools/probe_dyngather.py:97", "probe",
                          "window_lookup"),
        "take_along_axis": ("take_along_axis", "probe_gather.cu",
                            "tools/probe_dyngather.py:69", "probe",
                            "take_along_axis"),
        "fe_persp": ("fe_table_kernel(perspective=True)", "fe.cu",
                     jax + "frontend_kernel.py:42", "perspective",
                     "fe_persp"),
        "fused_persp": ("fused_kernel(perspective=True)", "fused.cu",
                        jax + "binning.py:703", "clip + perspective",
                        "fused_persp"),
        "fused_persp_seeded": ("fused_kernel(perspective=True, seeds=...)",
                               "fused.cu", jax + "binning.py:703",
                               "clip + perspective", "fused_persp_seeded"),
        "clip_front": ("clip_front_table", "clip_front.cu",
                       "software_renderer_tpu/render.py:213 (XLA)",
                       "clip + perspective", "clip_front"),
        "tail": ("tail_kernel", "tail.cu", jax + "shading.py:301 (XLA)",
                 "main", "tail"),
        "tail_uhd": ("tail_kernel (4K, untextured)", "tail.cu",
                     jax + "shading.py:301 (XLA)", "4K", "tail"),
    }
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "least_ms", "least_by")
    kernels = [dict(name=n, route="cuda", source=src + f, replaces=r,
                    launches=launches[path][counter],
                    **{key: res[k][key] for key in keys})
               for k, (n, f, r, path, counter) in meta.items()]
    assert all(k["launches"] > 0 for k in kernels), kernels
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
