"""The windowed cell's parts on the CPU: the frozen window rule
(benchlib/windows.py) against the program's ``windowed_prep``, the
configuration and the cell's files, the count behind
``sampler_roofline_pct.windowed``, the reader of the program's window
counter, and small runs of ``config4_orbit.batch64.windowed`` with the
program on sampler route "1"."""

import json
import types

import numpy as np
import pytest
import torch

from conftest import BENCH, ROOT, run_small, small_cell
from benchlib import harness, inputs, peaks, plugins, program, windows

CELL = "config4_orbit.batch64.windowed"


@pytest.fixture
def route1(monkeypatch):
    """The program on sampler route "1", as the cell's configuration
    asks (a run sets SR_TEX_WINDOWED before the program is imported)."""
    monkeypatch.setattr(program.module("ops.texture"), "TEX_WINDOWED", "1")


def _seeded_planes(seed, cap, seam):
    """[cap, 128] v planes and covered masks: each segment a run of
    texels about one row of the texture, and with ``seam`` half the
    segments straddling v = 0 / 1 (the repeat seam), some past [0, 1]."""
    g = torch.Generator().manual_seed(seed)
    centre = torch.rand((cap, 1), generator=g)
    if seam:
        centre[::2] = torch.where(torch.rand((cap // 2 + cap % 2, 1),
                                             generator=g) < 0.5, 0.0, 1.0)
    spread = torch.rand((cap, 1), generator=g) * 0.3
    v = centre + (torch.rand((cap, windows.LANES), generator=g) - 0.5) * spread
    cov = torch.rand((cap, windows.LANES), generator=g) < torch.rand(
        (cap, 1), generator=g)
    cov[::7] = False                      # segments with no covered lane
    return v, cov


@pytest.mark.parametrize("wrap", ["repeat", "clamp"])
@pytest.mark.parametrize("th", [256, 64, 8])
@pytest.mark.parametrize("seam", [False, True])
def test_frozen_rule_equals_windowed_prep_on_seeded_planes(wrap, th, seam):
    ttk = program.module("ops.texture_kernel")
    v, cov = _seeded_planes(3170023001 + th, 600, seam)
    u = torch.rand(v.shape, generator=torch.Generator().manual_seed(7))
    *_, y0, nwin = ttk.windowed_prep(u, v, cov, th=th, tw=256, wrap=wrap)
    f_y0, f_nwin = windows.windows(v, cov, th, wrap)
    assert torch.equal(f_nwin, nwin) and torch.equal(f_y0, y0)
    assert int((nwin == 0).sum()) >= 600 // 7
    if seam and wrap == "repeat" and th == 256:
        # Across the seam the walk wraps: a couple of windows, not 32.
        assert 1 < int(nwin[::2].max()) < th // windows.WIN_STRIDE


@pytest.mark.parametrize("frame", [0, 300])
def test_frozen_rule_equals_the_programs_on_a_frame(frame, route1,
                                                    monkeypatch):
    """The rule on the program's own uv planes of a small frame of the
    cell: the program's y0 and nwin, segment for segment."""
    texture = program.module("ops.texture")
    seen = []
    prep = texture.windowed_prep

    def spy(u, v, cov, **kw):
        out = prep(u, v, cov, **kw)
        seen.append((v, cov, kw, out))
        return out

    monkeypatch.setattr(texture, "windowed_prep", spy)
    cell = small_cell(CELL)
    inp = inputs.make(cell.config, 5)
    t = torch.from_numpy(inputs.transforms(cell.config,
                                           np.asarray([frame]))[0])
    program.package().render(program.render_pass(inp, cell.config, t, "cpu"))
    (v, cov, kw, out), = seen
    assert kw["wrap"] == "repeat" and int(out[5].sum()) > 0
    y0, nwin = windows.windows(v, cov, kw["th"], kw["wrap"])
    assert torch.equal(nwin, out[5]) and torch.equal(y0, out[4])


def test_configuration_and_cell_files():
    """config4_orbit's configuration key for key but its name and the
    sampler route; the cell finds its files by name, with batch64's
    traffic and limits unchanged and the metrics of its rows."""
    base = json.loads((BENCH / "configs" / "config4_orbit.json").read_text())
    cfg = json.loads((BENCH / "configs" /
                      "config4_orbit_windowed.json").read_text())
    assert cfg.pop("sampler_route") == "1"
    assert cfg.pop("name") == "config4_orbit_windowed"
    assert {k: v for k, v in base.items()
            if k not in ("name", "sampler_route")} == cfg
    cell = harness.find_cell(ROOT, CELL)
    inputs.validate(cell.config)
    assert cell.traffic == json.loads(
        (BENCH / "traffic" / "batch64.json").read_text())
    assert cell.limits == json.loads(
        (BENCH / "limits" / "config4_orbit.batch64.json").read_text())
    assert [m["name"] for m in cell.end_to_end] == ["frames_per_s",
                                                    "setup_s"]
    assert sorted(m["name"] for m in cell.per_layer) == sorted([
        "texture_tail_replay_ms.windowed", "sampler_roofline_pct.windowed",
        "windows_per_frame.windowed", "device_idle_pct.windowed"])
    for m in cell.per_layer:
        assert callable(harness.metric_reader(m["name"]))
    # 1920 is a multiple of the segment and 256x256 a texture the
    # windowed sampler takes: every frame takes K7.
    ttk = program.module("ops.texture_kernel")
    tx = cell.config["texture"]
    assert cell.config["width"] % windows.LANES == 0
    assert ttk.windowed_supported(tx["size"], tx["size"], 3, windows.LANES)


def _work(**kw):
    return dict(dict(segments=16_200, window_segments=4_101, windows=9_000,
                     lanes=331_473, th=256, tw=256, c=3), **kw)


def test_sampler_least_time_counts_bytes():
    """A frame of config 4's shapes: 16,200 segments' y0 and nwin, 4,101
    segments' dy, 331,473 covered lanes' xa, fx and fy, the 3 padded
    channel planes and the 3 output planes, 31,925,772 bytes; with no
    window, on a small frame, the launch floor."""
    least = plugins.load("metrics", "sampler_roofline_pct.windowed").least_s
    n_bytes = (16_200 * 8 + 4_101 * 512 + 331_473 * 12
               + 3 * 272 * 256 * 4 + 3 * 16_200 * 512)
    assert least(_work()) == pytest.approx(n_bytes / peaks.HBM_BYTES_PER_S)
    assert least(_work()) == pytest.approx(9.5301e-6, rel=1e-4)
    none = _work(segments=8, window_segments=0, windows=0, lanes=0)
    assert least(none) == peaks.LAUNCH_FLOOR_S


def test_work_of_frames_with_and_without_windows():
    """The reference's counts of a small frame of the cell: covered
    lanes lie in segments with a window; off screen nothing is covered,
    no segment has a window, and K7's least time is the launch floor."""
    cell = small_cell(CELL)
    cfg = dict(cell.config, height=16)
    scene = inputs.make(cfg, 5).reference_scene("cpu")
    t = torch.from_numpy(inputs.transforms(cfg, np.asarray([0]))[0])
    w = windows.work(scene, t, cfg)
    assert w["segments"] == 256 * 16 // 128 and w["c"] == 3
    assert 0 < w["window_segments"] <= w["windows"]
    assert w["window_segments"] * 128 >= w["lanes"] > 0
    off = torch.eye(4)
    off[0, 3] = 5.0
    w = windows.work(scene, off @ t, cfg)
    assert w["windows"] == w["window_segments"] == w["lanes"] == 0
    least = plugins.load("metrics", "sampler_roofline_pct.windowed").least_s
    assert least(w) == peaks.LAUNCH_FLOOR_S


def test_sampler_roofline_reads_least_time_over_k7():
    """K7's device time by name in the traced call (not the tail's or
    K2's), against the least time of that call's frames: here two frames
    with no window over 4 us of K7, 50.5%."""
    cell = small_cell(CELL)
    cfg = dict(cell.config, height=16)
    scene = inputs.make(cfg, 5).reference_scene("cpu")
    off = torch.eye(4)
    off[0, 3] = 5.0
    trace = types.SimpleNamespace(device=[
        ("void (anonymous namespace)::sampler_kernel(float4 const*, int)",
         0, 1.5, 1),
        ("void (anonymous namespace)::sampler_kernel(float4 const*, int)",
         0, 2.5, 2),
        ("void (anonymous namespace)::tail_kernel<2, 3, true>(int)", 0,
         30.0, 3),
        ("void (anonymous namespace)::walk_kernel<true, 1>(int)", 0, 90.0,
         4)])
    calls = []
    drv = types.SimpleNamespace(
        start=5, attempted=3, reference_scene=lambda: scene,
        _frames=lambda call: calls.append(call) or (0, [off, off]))
    ctx = types.SimpleNamespace(trace=trace, driver=drv, config=cfg)
    read = plugins.load("metrics", "sampler_roofline_pct.windowed").read
    assert read(ctx) == pytest.approx(2 * 1.01e-6 / 4e-6 * 100)
    assert calls == [8]
    assert read(types.SimpleNamespace(trace=trace, driver=None)) is None
    trace.device = trace.device[2:]      # no K7 (route "0"): nothing
    assert read(ctx) is None


def test_windows_per_frame_reads_the_programs_counter(route1, monkeypatch):
    """Windows over windowed frames, on the run's device; nothing
    without a device, before a windowed frame, or where the program has
    no counter (the parent of the counter's change)."""
    read = plugins.load("metrics", "windows_per_frame.windowed").read
    ttk = program.module("ops.texture_kernel")
    cpu = types.SimpleNamespace(driver=types.SimpleNamespace(
        device=torch.device("cpu")))
    ttk.reset_window_counts("cpu")
    assert read(cpu) is None
    v, cov = _seeded_planes(3170023011, 40, True)
    nwin = ttk.windowed_count(v, cov, th=256, wrap="repeat")
    ttk.count_windows(cov, nwin)
    ttk.count_windows(cov, nwin)
    assert read(cpu) == int(nwin.sum())
    assert read(types.SimpleNamespace(driver=None)) is None
    monkeypatch.delattr(ttk, "window_counts")
    assert read(cpu) is None


def test_windowed_cell_small_run_is_correct(route1):
    """A small run of the cell on the CPU through the harness, on route
    "1": correct, and every frame it rendered counted by the window
    counter."""
    ttk = program.module("ops.texture_kernel")
    ttk.reset_window_counts("cpu")
    res, rows = run_small(CELL, seed=3170023021, seconds=0.5)
    assert res["correct"] is True, rows
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}
    c = ttk.window_counts("cpu")
    assert c["frames"] >= 4 * (1 + res["attempted"])   # warm-up + window
    assert c["windows"] >= c["window_segments"] == c["covered_segments"] > 0


def test_windowed_cell_refuses_the_programs_other_route(monkeypatch):
    """A process whose program runs route "0" does not run the cell
    under the configuration's route "1" (the route is read at import)."""
    monkeypatch.setattr(program.module("ops.texture"), "TEX_WINDOWED", "0")
    with pytest.raises(ValueError, match="route"):
        run_small(CELL, seconds=0.1)
