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
   and depth bit-equal, shaded planes within PLANE_TOL; times of both;
4. a forced spill (config 2 at 512x512 with kmax=1): the overflow kernels
   and the seeded fused kernel launch, and the frame equals the spill-free
   one;
5. the main path: launch counters reset, then 8 frames of the config-4
   animation (bench.py's transform; frames 120, 240 and 600 spill, so the
   overflow kernels run on the path too) through render(); counters,
   coverage, finiteness and ms/frame from CUDA events;
6. the same small scene rendered on the card and on the CPU (plain
   versions) with the auto, reference and pallas backends: alpha and
   depth bit-equal, color within 1e-3;
7. the other backends at config 4's full size on the frames that spill
   (0, 120, 240, 600): render(backend="pallas"), render(backend="binned"),
   flat shading (binned_pipeline without attributes) and
   binned_pipeline(ps, attrs), each with the counters reset just before
   it and read just after; ms/frame of each; (depth, id) bit-equal across
   the record walk (K3'), the binned pass (K5, K3 on spills) and the fused
   path (K2).

Each kernel's bound is the larger of the bytes it must move over the
card's memory rate and the float32 operations this run's data needs over
the card's float32 rate (NVIDIA's H100 SXM data sheet, at 700 W). The
last lines are the card line, one JSON line describing the kernels, and
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import torch

from software_renderer_tpu_torch import _cuda, render
from software_renderer_tpu_torch.models import scenes
from software_renderer_tpu_torch.ops import binning as tb
from software_renderer_tpu_torch.ops import frontend as fe
from software_renderer_tpu_torch.ops import transforms as tf
from software_renderer_tpu_torch.ops.frontend_kernel import fe_kernel, fe_plain
from software_renderer_tpu_torch.ops.rasterize_kernel import (
    _poison_row, visibility_kernel, visibility_merge_kernel,
    visibility_merge_plain, visibility_pallas, visibility_plain)
from software_renderer_tpu_torch.render import planar_front_of, triangle_inputs

# Shaded planes (kernel vs plain on the same card): both round every
# operation the same way; only powf may differ from torch.pow by an ulp
# or two, amplified at most by the color range 0..1.
PLANE_TOL = 1e-5
MAIN_FRAMES = (0, 100, 120, 240, 300, 400, 600, 700)
BACKEND_FRAMES = (0, 120, 240, 600)
# The render path's pair budget for culled scenes (render.py).
BUDGET = 0.85

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
# mapping, edges, depth plane, bbox and certificate, counted from fe.cu.
OPS_FE = 200


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


def bound(n_bytes, n_ops):
    """The least time (ms) the card could take to move ``n_bytes`` and do
    ``n_ops`` float32 operations, and which of the two bounds it. No one
    PyTorch call computes any of these kernels' functions, so there is no
    library time."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)


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
    fe_args = (cols, m16, w, h)
    rk = fe_kernel(*fe_args, cull_backfaces=True)
    rpl = fe_plain(*fe_args, cull_backfaces=True)
    sync()
    assert_bit_equal(rk, rpl, "K1 front-end rows")
    res["fe"] = dict(max_abs_err=max_err(rk, rpl),
                     ms=cuda_ms(lambda: fe_kernel(*fe_args,
                                                  cull_backfaces=True), 50),
                     plain_ms=cuda_ms(lambda: fe_plain(
                         *fe_args, cull_backfaces=True), 5),
                     shape=f"T={t}",
                     **bound(nbytes(cols, m16, rk), OPS_FE * t))
    bbox = torch.stack([ps.bx0, ps.by0, ps.bx1, ps.by1], dim=1)

    table, a, poison = fe.stream_table_planar(
        ps, fe.attribute_plane_cols(ps, attrs))
    kw = dict(width=w, height=h, chans=chans, has_light=True,
              has_texture=True, bands=4)
    info = tb.build_bins(ps, width=w, height=h, kmax=48,
                         pair_budget_factor=0.85, bands=4)
    rows = tb.gather_stream(table, info.ids, poison).contiguous()
    zk, ik, ok = tb.fused_kernel(rows, info.bin_start, prm, **kw)
    zp, ip, op = tb.fused_plain(rows, info.bin_start, prm, **kw)
    sync()
    assert_bit_equal(ik, ip, "K2 ids")
    assert_bit_equal(zk, zp, "K2 depth")
    err2 = max_err(ok, op)
    assert err2 <= PLANE_TOL, f"K2 planes differ by {err2}"
    res["fused"] = dict(
        max_abs_err=err2,
        ms=cuda_ms(lambda: tb.fused_kernel(rows, info.bin_start, prm, **kw),
                   20),
        plain_ms=cuda_ms(lambda: tb.fused_plain(rows, info.bin_start, prm,
                                                **kw), 2),
        shape=f"{info.ids.numel()} pairs in {info.bin_start.numel() - 1} "
              "bins",
        **bound(nbytes(rows, info.bin_start, prm, zk, ik, ok),
                OPS_TEST * bbox_pixels(bbox[torch.unique(info.ids).long()],
                                       w, h)
                + w * h * (4 * a + OPS_EPILOGUE)))

    # Overflow set: kmax=1 spills every triangle spanning two bins or more.
    info1 = tb.build_bins(ps, width=w, height=h, kmax=1,
                          pair_budget_factor=0.85, bands=4)
    ov = torch.nonzero(info1.overflow_mask).squeeze(1).to(torch.int32)
    rec = tb.gather_stream(fe.pack_records_planar(ps, 128), ov,
                           _poison_row(dev)).contiguous()
    z0 = torch.full((h, w), float("inf"), device=dev)
    i0 = torch.full((h, w), -1, dtype=torch.int32, device=dev)
    z3, i3 = visibility_merge_kernel(rec, z0, i0, width=w, height=h)
    z3p, i3p = visibility_merge_plain(rec, z0, i0, width=w, height=h)
    sync()
    assert_bit_equal(i3, i3p, "K3 ids")
    assert_bit_equal(z3, z3p, "K3 depth")
    res["visibility_merge"] = dict(
        max_abs_err=max_err(z3, z3p),
        ms=cuda_ms(lambda: visibility_merge_kernel(rec, z0, i0, width=w,
                                                   height=h), 5),
        plain_ms=cuda_ms(lambda: visibility_merge_plain(
            rec, z0, i0, width=w, height=h), 1),
        shape=f"{ov.numel()} overflow records",
        **bound(nbytes(rec, z0, i0, z3, i3),
                OPS_TEST_CLAMPED * bbox_pixels(rec[:, 10:14], w, h)))

    ov_rows = tb.gather_stream(table, ov, poison).contiguous()
    g0 = torch.zeros((a, h, w), device=dev)
    g4 = tb.resolve_merge_kernel(ov_rows, i3, g0, width=w, height=h)
    g4p = tb.resolve_merge_plain(ov_rows, i3, g0, width=w, height=h)
    sync()
    err4 = max_err(g4, g4p)
    assert err4 <= PLANE_TOL, f"K4 planes differ by {err4}"
    res["resolve_merge"] = dict(
        max_abs_err=err4,
        ms=cuda_ms(lambda: tb.resolve_merge_kernel(ov_rows, i3, g0, width=w,
                                                   height=h), 20),
        plain_ms=cuda_ms(lambda: tb.resolve_merge_plain(
            ov_rows, i3, g0, width=w, height=h), 5),
        shape=f"{ov.numel()} overflow rows",
        **bound(resolve_bytes(ov_rows, torch.unique(i3[i3 >= 0]).numel(),
                              a, i3, g0, g4),
                w * h * (4 * a + math.ceil(math.log2(ov.numel() + 1)))))

    rows1 = tb.gather_stream(table, info1.ids, poison).contiguous()
    seeds = (z3, i3, g4)
    zs, is_, os_ = tb.fused_kernel(rows1, info1.bin_start, prm, seeds=seeds,
                                   **kw)
    zsp, isp, osp = tb.fused_plain(rows1, info1.bin_start, prm, seeds=seeds,
                                   **kw)
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
    print(f"seeded fused (kmax=1, {ov.numel()} spilled) equals the binned "
          f"frame; planes max |d| {res['fused']['seeded_max_abs_err_vs_binned']}",
          flush=True)

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
    zo, io = visibility_kernel(rec, width=w, height=h)
    sync()
    assert_bit_equal(io, i3, "K3' vs K3 ids")
    assert_bit_equal(zo, z3, "K3' vs K3 depth")
    res["visibility"] = dict(
        max_abs_err=max_err(zc, zcp),
        ms=cuda_ms(lambda: visibility_kernel(rec_all, width=w, height=h), 5),
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
    z5, i5 = tb.binned_vis_kernel(rows_b, starts, width=w, height=h)
    z5p, i5p = tb.binned_vis_plain(rows_b, starts, width=w, height=h)
    sync()
    assert_bit_equal(i5, i5p, "K5 ids")
    assert_bit_equal(z5, z5p, "K5 depth")
    res["binned_vis"] = dict(
        max_abs_err=max_err(z5, z5p),
        ms=cuda_ms(lambda: tb.binned_vis_kernel(rows_b, starts, width=w,
                                                height=h), 20),
        plain_ms=cuda_ms(lambda: tb.binned_vis_plain(rows_b, starts,
                                                     width=w, height=h), 2),
        shape=f"{info_b.ids.numel()} pairs in {starts.numel() - 1} bins",
        **bound(rows_b.shape[0] * tb.REC_BASE * 4 + nbytes(starts, z5, i5),
                OPS_TEST * bbox_pixels(
                    bbox[torch.unique(info_b.ids).long()], w, h)))

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
        ms=cuda_ms(lambda: tb.resolve_kernel(rows_b, starts, i5,
                                             n_channels=a, width=w,
                                             height=h), 20),
        plain_ms=cuda_ms(lambda: tb.resolve_plain(
            rows_b, starts, i5, n_channels=a, width=w, height=h), 5),
        shape=f"{info_b.ids.numel()} rows, {a} channels, {n_won} won",
        **bound(resolve_bytes(rows_b, n_won, a, starts, i5, g6),
                w * h * (4 * a + math.ceil(math.log2(longest + 1)))))
    for name, r in res.items():
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
    assert finite, "non-finite color"
    assert all(c > 0 for c in cov), "a frame covered nothing"
    for k in ("fe", "fused", "visibility_merge", "resolve_merge",
              "fused_seeded"):
        assert launches[k] > 0, f"kernel {k} never launched on the main path"
    return launches


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
    return launches, ms


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

    res = phase_kernels(dev)                                 # phase 3
    sync()
    phase_spill(dev)                                         # phase 4
    sync()
    launches = phase_main(dev, card)                         # phase 5
    sync()
    phase_small_reference(dev)                               # phase 6
    sync()
    backend_launches, _ = phase_backends(dev, card)          # phase 7
    sync()

    src = "software_renderer_tpu_torch/csrc/"
    meta = {
        "fe": ("fe_kernel", "fe.cu",
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
        "binned_vis": ("binned_vis_kernel", "binned_vis.cu",
                       "software_renderer_tpu/ops/binning.py:607"),
        "resolve": ("resolve_kernel", "resolve.cu",
                    "software_renderer_tpu/ops/binning.py:663"),
    }
    # Launches on the path that runs each kernel: the main path for K1-K4,
    # the pallas backend for K3', flat shading for K5, and
    # binned_pipeline(ps, attrs) for K6.
    path_launches = {k: launches[k] for k in
                     ("fe", "fused", "visibility_merge", "resolve_merge")}
    path_launches["visibility"] = backend_launches["pallas"]["visibility"]
    path_launches["binned_vis"] = backend_launches["flat"]["binned_vis"]
    path_launches["resolve"] = backend_launches["binned_pipeline"]["resolve"]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [dict(name=n, route="cuda", source=src + f, replaces=r,
                    launches=path_launches[k],
                    **{key: res[k][key] for key in keys})
               for k, (n, f, r) in meta.items()]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
