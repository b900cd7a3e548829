"""The spill cell's parts on the CPU: the frozen overflow rule
(benchlib/overflow.py) against the program's bin build, the count behind
``spill_roofline_pct.uhd`` on a frame worked by hand, the reader of the
program's spill counter, and small runs of ``config4_uhd_phong.batch32``
(sound, spilling, and with the spill fault)."""

import types

import numpy as np
import pytest
import torch

from conftest import run_small, small_cell
from benchlib import inputs, overflow, plugins, program
from benchlib import reference as ref
from test_bench_faults import _spill_plane

CELL = "config4_uhd_phong.batch32"


def _hand_scene():
    """Two front-facing triangles that tile a 2048 x 128 frame, split on
    its diagonal (no pixel centre lies on it): each spans 16 x 2 tiles,
    more than 12, so both spill for kmax; together they cover each of the
    262,144 pixel centres once."""
    ndc = lambda px, py: (px / 2048 * 2.0 - 1.0, 1.0 - py / 128 * 2.0, 0.5)
    pos = torch.tensor([ndc(0, 0), ndc(2048, 0), ndc(0, 128),
                        ndc(2048, 128)], dtype=torch.float32)
    idx = torch.tensor([0, 1, 2, 1, 3, 2], dtype=torch.int32)
    cfg = dict(width=2048, height=128, clip_near=False, cull_backfaces=True)
    return dict(positions=pos, indices=idx), torch.eye(4), cfg


def _program_overflow(scene, transform, cfg):
    """The program's overflow mask and its counter's reasons for one
    frame, bins built as its render builds them."""
    fe = program.module("ops.frontend")
    binning = program.module("ops.binning")
    tris = scene["indices"].reshape(-1, 3).long()
    ps = fe.planar_front(fe.corner_cols(scene["positions"][tris]),
                         transform, cfg["width"], cfg["height"],
                         cull_backfaces=cfg["cull_backfaces"])
    bands = 4 if ps.num_triangles >= 2048 else 1
    binning.reset_spill_counts("cpu")
    info = binning.build_bins(ps, width=cfg["width"], height=cfg["height"],
                              kmax=12 * bands, pair_budget_factor=0.85,
                              bands=bands)
    return info.overflow_mask, binning.spill_counts("cpu")


@pytest.mark.parametrize("triangles,frame", [(3000, 0), (3000, 240),
                                             (3000, 480), (100_000, 242),
                                             (None, None)])
def test_frozen_rule_equals_the_programs_overflow(triangles, frame):
    """The frozen rule spills the triangles the program's bin build
    spills, for the same reasons: at 3840x2160 nothing at orbit frame 0,
    the budget at frame 240, triangles that are not coverage-safe at
    frame 480 and all three in config 4's full scene at frame 242; and
    kmax on the frame worked by hand."""
    if triangles is None:
        scene, t, cfg = _hand_scene()
    else:
        cfg = small_cell(CELL).config
        cfg.update(width=3840, height=2160)
        cfg["scene"]["target_triangles"] = triangles
        scene = inputs.make(cfg, 0).reference_scene("cpu")
        t = torch.from_numpy(inputs.transforms(cfg, np.asarray([frame]))[0])
    g = ref.geometry(scene["positions"], scene["indices"], t, cfg["width"],
                     cfg["height"])
    st = ref.setup(g, cfg["width"], cfg["height"])
    why = overflow.reasons(g, st, cfg["width"], cfg["height"])
    mask, counts = _program_overflow(scene, t, cfg)
    assert torch.equal(why["budget"] | why["kmax"] | why["unsafe"], mask)
    assert counts == dict(frames=1, **{k: int(v.sum())
                                       for k, v in why.items()})
    if frame == 240:
        assert counts["budget"] > 400
    if frame == 242:
        assert min(counts["budget"], counts["kmax"], counts["unsafe"]) > 0
    if triangles is None:
        assert counts["kmax"] == 2


def test_overflow_work_of_a_hand_worked_frame():
    """The hand-worked frame: 2 spilled triangles, 262,144 pixels won and
    as many covering pairs; with untextured Phong's 6 channels the least
    time is (2 x 29 x 4 + 262,144 x 32) bytes at 3.35 TB/s, 2.5041 us,
    above the 14 x 262,144 operations' 0.0548 us and the launch floor."""
    scene, t, cfg = _hand_scene()
    work = overflow.work(scene, t, cfg)
    assert work == dict(budget=0, kmax=2, unsafe=0, spilled=2,
                        pixels=2048 * 128, pairs=2048 * 128)
    least = plugins.load("metrics", "spill_roofline_pct.uhd").least_s(work, 6)
    assert least == pytest.approx((2 * 29 * 4 + 262_144 * 32) / 3.35e12)
    assert least == pytest.approx(2.50413e-6, rel=1e-5)


def test_spill_roofline_reads_least_time_over_the_kernels():
    """K3's and K4's device time by name in the traced call (not K2's),
    against the least time of that call's frames: here two hand-worked
    frames over 20 us of the four kernels, 25.04%."""
    scene, t, cfg = _hand_scene()
    trace = types.SimpleNamespace(device=[
        ("void (anonymous namespace)::span_kernel(float const*)", 0, 2.0, 1),
        ("void (anonymous namespace)::super_kernel(int)", 0, 3.0, 2),
        ("void (anonymous namespace)::visibility_kernel<false>(int)", 0,
         10.0, 3),
        ("void (anonymous namespace)::resolve_merge_kernel(float*)", 0, 5.0,
         4),
        ("void (anonymous namespace)::walk_kernel<true, 1>(int)", 0, 90.0,
         5)])
    calls = []
    drv = types.SimpleNamespace(
        start=5, attempted=3, reference_scene=lambda: scene,
        _frames=lambda call: calls.append(call) or (0, [t, t]))
    cfg = dict(cfg, shading="phong", light="default",
               perspective_correct=False)
    ctx = types.SimpleNamespace(trace=trace, driver=drv, config=cfg)
    read = plugins.load("metrics", "spill_roofline_pct.uhd").read
    assert read(ctx) == pytest.approx(2 * 2.50413e-6 / 20e-6 * 100, rel=1e-5)
    assert calls == [8]
    assert read(types.SimpleNamespace(trace=trace, driver=None)) is None


def test_spilled_per_frame_reads_the_programs_counter(monkeypatch):
    """Spilled triangles over bin builds, on the run's device; nothing
    without a device or where the program has no counter (the parent of
    the counter's change)."""
    read = plugins.load("metrics", "spilled_per_frame.uhd").read
    binning = program.module("ops.binning")
    cpu = types.SimpleNamespace(driver=types.SimpleNamespace(
        device=torch.device("cpu")))
    binning.reset_spill_counts("cpu")
    assert read(cpu) is None
    scene, t, cfg = _hand_scene()
    _program_overflow(scene, t, cfg)       # 2 spilled in 1 bin build
    assert read(cpu) == 2.0
    assert read(types.SimpleNamespace(driver=None)) is None
    monkeypatch.delattr(binning, "spill_counts")
    assert read(cpu) is None


def test_uhd_cell_small_run_is_correct():
    res, rows = run_small(CELL, seconds=0.5)
    assert res["correct"] is True, rows


def test_uhd_cell_small_spilling_run_and_its_fault(monkeypatch):
    """Frames that spill come out correct, and with the first G-buffer
    plane of K4's overflow winners scaled by 0.9 not correct."""
    monkeypatch.setattr(program.module("ops.binning"), "KMAX", 0.25)
    res, rows = run_small(CELL)
    assert res["correct"] is True, rows
    _spill_plane(monkeypatch)
    res, rows = run_small(CELL)
    assert res["correct"] is False, rows
