"""Config 3, the teapot cell: the frozen scene and turn give the
program's own arrays and transforms, the port's CPU path draws the
configuration as the reference does at a small size, the bfloat16
control fails there, a small run of the cell comes out correct, and the
readers of the turnaround's spans read a hand-written trace whose
replay span holds the launch's."""

import json
import time
import types

import numpy as np
import pytest
import torch

from conftest import ROOT, SMALL_TRAFFIC
from benchlib import compare, drivers, harness, inputs, plugins, program
from benchlib import reference as ref
from benchlib import spans
from benchlib import trace as tr

CELL = "config3_teapot.view"
SIZE = dict(width=128, height=128)
CONFIG = json.loads((ROOT / "benchmark" / "configs"
                     / "config3_teapot.json").read_text())


def small_cell():
    """The teapot cell at 128x128 with the CPU's frame-loop traffic (the
    scene stays whole: 5,112 triangles)."""
    cell = harness.find_cell(ROOT, CELL)
    cell.config.update(SIZE)
    cell.traffic.update(SMALL_TRAFFIC["frame_loop"])
    return cell


def seeded_times(seed, n=3):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 2.0 * np.pi, size=n)


def test_frozen_teapot_equals_load_obj():
    arrays = inputs.make(CONFIG, 1).arrays
    mesh = program.module("models.obj").load_obj(
        str(ROOT / "assets" / "teapot.obj"), device="cpu")
    for f in ("positions", "indices", "colors", "normals", "uvs"):
        x, y = getattr(arrays, f), getattr(mesh, f).numpy()
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert arrays.triangles == 5112 and arrays.positions.shape[0] == 2629
    # The seed draws only the start and the compared frames.
    again = inputs.make(CONFIG, 987654321987).arrays
    assert np.array_equal(again.positions, arrays.positions)


def test_turntable_equals_config3_phong_mesh():
    scenes = program.module("models.scenes")
    for t in seeded_times(3170000021):
        want = scenes.config3_phong_mesh(float(t), device="cpu").transform
        got = inputs.transforms(CONFIG, np.asarray([0]), start=float(t))[0]
        assert np.abs(got - want.numpy()).max() < 1e-6, t
    model = inputs.make(CONFIG, 0).model.numpy()
    want = np.diag([1.5, 1.5, 1.5, 1.0]).astype(np.float32)
    want[2, 3] = 1.0
    assert np.array_equal(model, want)


def test_reference_equals_port_cpu():
    """Coverage and depth exact and colours within the cell's limits,
    culling off (seeded times, 128x128)."""
    cfg = dict(CONFIG, **SIZE)
    inp = inputs.make(cfg, 5)
    scene = inp.reference_scene("cpu")
    sr = program.package()
    tally = compare.FrameTally()
    limits = small_cell().limits
    for t in seeded_times(3170000022):
        t = torch.from_numpy(inputs.transforms(cfg, np.asarray([0]),
                                               float(t))[0])
        fb = sr.render(program.render_pass(inp, cfg, t, "cpu"))
        r = ref.render(scene, t, cfg)
        tally.add(fb.color, fb.depth, r.color, r.depth)
    n = tally.numbers()
    assert n["covered_px"] > 0
    assert n["coverage_diff_px"] == 0 and n["depth_diff_px"] == 0
    assert n["rgb8_off_share"] <= limits["rgb8_off_share"]
    assert n["rgb8_tile_off8_share"] <= limits["rgb8_tile_off8_share"]


def test_back_faces_are_drawn():
    """With culling off the reference covers pixels whose winner faces
    away (the teapot's inside, through the spout and under the lid)
    at some time of the turn, which culling would leave empty or give
    to another triangle."""
    cfg = dict(CONFIG, **SIZE)
    scene = inputs.make(cfg, 5).reference_scene("cpu")
    back = 0
    for t in seeded_times(3170000023, 6):
        t = torch.from_numpy(inputs.transforms(cfg, np.asarray([0]),
                                               float(t))[0])
        g = ref.geometry(scene["positions"], scene["indices"], t,
                         cfg["width"], cfg["height"])
        st = ref.setup(g, cfg["width"], cfg["height"], cull_backfaces=False)
        culled = ref.setup(g, cfg["width"], cfg["height"])
        assert int(st.valid.sum()) > int(culled.valid.sum())
        _, ids = ref.visibility(st, cfg["width"], cfg["height"])
        _, ids_c = ref.visibility(culled, cfg["width"], cfg["height"])
        back += int((ids != ids_c).sum())
    assert back > 0


def test_control_fails():
    cell = small_cell()
    drv = drivers.load(cell.traffic)(cell.config, cell.traffic, 77, "cpu")
    scene = drv.reference_scene()
    items = [drivers.Item("frame", t) for t in drv.camera([0, 30, 240], 1.0)]
    nums = compare.control_numbers(items, scene, cell.config)
    ok, rows = compare.judge(nums, cell.limits)
    assert not ok, rows


def test_sound_run_is_correct():
    """A small run of the cell on the CPU: FrameLoop frames through the
    harness, compared with the reference, correct."""
    cell = small_cell()
    res, rows = harness.run_cell(ROOT, CELL, 3170000024, 0.5, False, "cpu",
                                 time.time(), log=lambda s: None, cell=cell)
    assert res["correct"] is True, rows
    assert set(res["metrics"]) == {"frame_ms_p95", "setup_s"}


# A replayed viewer frame: the key's host work, then the replay span
# holding the transform's copy and, nested in it, the graph's launch.
REPLAY = "sr.frame_graph.replay|front=1|spill=1|raster=1"


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _frame(t0):
    return [
        _x("user_annotation", "sr.frame_loop.frame", t0, 200),
        _x("user_annotation", "sr.frame_graph.key", t0 + 5, 20),
        _x("user_annotation", REPLAY, t0 + 30, 60),
        _x("cuda_runtime", "cudaMemcpyAsync", t0 + 35, 3, corr=t0 + 1),
        _x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", t0 + 40, 2,
           tid=7, corr=t0 + 1),
        _x("user_annotation", "sr.frame_graph.launch", t0 + 50, 30),
        _x("cuda_runtime", "cudaGraphLaunch", t0 + 55, 20, corr=t0 + 2),
        _x("kernel", "fe_table_kernel", t0 + 100, 10, tid=7, corr=t0 + 2),
        _x("kernel", "memset_kernel", t0 + 115, 5, tid=7, corr=t0 + 2),
        _x("kernel", "walk_kernel<true, 1>", t0 + 125, 20, tid=7,
           corr=t0 + 2),
    ]


def _ctx(data, items):
    ctx = types.SimpleNamespace(driver=None, trace=tr.Trace(data, items))
    ctx.__dict__["_program_spans"] = spans.Spans(data, items)
    return ctx


def test_turnaround_spans_are_read():
    data = {"traceEvents": [_x("Trace", "PyTorch Profiler (0)", 0, 1000,
                               tid="PyTorch Profiler")]
            + _frame(0) + _frame(400)}
    s = spans.Spans(data, 2)
    # The launch's span inside the replay's leaves the map's cut alone.
    assert s.replay_layers() == [{"front": 0.010, "spill": 0.005,
                                  "raster": 0.020}] * 2
    read = lambda m: plugins.load("metrics", m).read(_ctx(data, 2))
    assert read("key_host_ms.view") == pytest.approx(0.020)
    assert read("launch_host_ms.view") == pytest.approx(0.030)
    assert read("spill_replay_ms.teapot") == pytest.approx(0.005)
    assert read("frame_idle_ms.teapot") == read("frame_idle_ms.view")
    assert read("device_idle_pct.teapot") == read("device_idle_pct.view")
    # The parent's program has neither span: nothing is read.
    older = {"traceEvents": [e for e in data["traceEvents"] if e["name"]
                             not in ("sr.frame_graph.key",
                                     "sr.frame_graph.launch")]}
    for m in ("key_host_ms.view", "launch_host_ms.view"):
        assert plugins.load("metrics", m).read(_ctx(older, 2)) is None, m
