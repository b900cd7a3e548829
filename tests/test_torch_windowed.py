"""PyTorch port on the windowed sampler route (``SR_TEX_WINDOWED=1``), on
the CPU: ``render`` of a small seeded frame of the benchmark's
``config4_orbit_windowed`` configuration against the benchmark's plain
reference (benchmark/benchlib/reference.py) within that cell's limits,
and the window counter (ops/texture_kernel.py ``window_counts``) against
``windowed_count`` of the frames' own uv planes.

The route is set with monkeypatch on ``ops.texture.TEX_WINDOWED`` (the
program reads the variable once, at import). The windowed route takes
frames whose width is a multiple of 128.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import software_renderer_tpu_torch as srt
from software_renderer_tpu_torch.ops import texture as ttex
from software_renderer_tpu_torch.ops import texture_kernel as ttk
from software_renderer_tpu_torch.parallel.batch import render_batch

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
sys.path.append(str(BENCH))
from benchlib import compare, inputs, program  # noqa: E402
from benchlib import reference as ref  # noqa: E402

CELL = "config4_orbit.batch64.windowed"
# ~2k triangles of the configuration's scene at 256x128.
SMALL = dict(width=256, height=128)
TRIANGLES = 2000
SEED = 3170023101
FRAMES = (0, 150, 300, 500)


def _config():
    cfg = json.loads((BENCH / "configs" /
                      "config4_orbit_windowed.json").read_text())
    cfg.update(SMALL)
    cfg["scene"] = dict(cfg["scene"], target_triangles=TRIANGLES)
    return cfg


def _limits():
    return json.loads((BENCH / "limits" / f"{CELL}.json").read_text())


@pytest.fixture
def frames():
    """The configuration's inputs at SEED and the transforms of FRAMES."""
    cfg = _config()
    inp = inputs.make(cfg, SEED)
    ts = torch.from_numpy(inputs.transforms(cfg, np.asarray(FRAMES)))
    return cfg, inp, ts


@pytest.fixture
def sampled(monkeypatch):
    """Route "1", and the (v, covered) planes of every windowed frame,
    as the tail hands them to ``windowed_prep``."""
    monkeypatch.setattr(ttex, "TEX_WINDOWED", "1")
    seen = []
    prep = ttex.windowed_prep

    def spy(u, v, cov, **kw):
        out = prep(u, v, cov, **kw)
        seen.append((v, cov, kw))
        return out

    monkeypatch.setattr(ttex, "windowed_prep", spy)
    return seen


@pytest.mark.parametrize("k", range(len(FRAMES)))
def test_route1_render_agrees_with_the_reference(k, frames, sampled):
    """Coverage and depth exact, colour within the cell's limits, every
    segment through the windowed sampler (its plain version here)."""
    cfg, inp, ts = frames
    fb = srt.render(program.render_pass(inp, cfg, ts[k], "cpu"))
    assert len(sampled) == 1 and sampled[0][0].shape == (
        SMALL["width"] * SMALL["height"] // ttk.LANES, ttk.LANES)
    r = ref.render(inp.reference_scene("cpu"), ts[k], cfg)
    tally = compare.FrameTally()
    tally.add(fb.color, fb.depth, r.color, r.depth)
    n = tally.numbers()
    limits = _limits()
    assert n["covered_px"] > 100
    assert n["coverage_diff_px"] == 0 and n["depth_diff_px"] == 0
    assert n["rgb8_off_share"] <= limits["rgb8_off_share"], n
    assert n["rgb8_tile_off8_share"] <= limits["rgb8_tile_off8_share"], n


def test_window_counts_equal_windowed_count_sums(frames, sampled):
    """Over the frames of a render_batch call and a render each: frames,
    covered segments, segments with a window and windows, each the sum
    of ``windowed_count`` over the frames' own planes."""
    cfg, inp, ts = frames
    ttk.reset_window_counts("cpu")
    rp = program.render_pass(inp, cfg, ts[0], "cpu")
    render_batch(rp, ts)
    for t in ts[:2]:
        srt.render(program.render_pass(inp, cfg, t, "cpu"))
    assert len(sampled) == len(FRAMES) + 2
    want = dict(frames=0, covered_segments=0, window_segments=0, windows=0)
    for v, cov, kw in sampled:
        nwin = ttk.windowed_count(v, cov, th=kw["th"], wrap=kw["wrap"])
        want["frames"] += 1
        want["covered_segments"] += int(cov.any(dim=1).sum())
        want["window_segments"] += int((nwin > 0).sum())
        want["windows"] += int(nwin.sum())
    assert ttk.window_counts("cpu") == want
    assert want["windows"] > want["window_segments"] > 0


def test_window_counts_stay_at_zero_on_route_0(frames, monkeypatch):
    """Route "0" samples the quad table and counts nothing; a reset
    zeroes what route "1" counted."""
    cfg, inp, ts = frames
    ttk.reset_window_counts()
    monkeypatch.setattr(ttex, "TEX_WINDOWED", "0")
    for t in ts:
        srt.render(program.render_pass(inp, cfg, t, "cpu"))
    zero = dict(frames=0, covered_segments=0, window_segments=0, windows=0)
    assert ttk.window_counts("cpu") == zero
    monkeypatch.setattr(ttex, "TEX_WINDOWED", "1")
    srt.render(program.render_pass(inp, cfg, ts[0], "cpu"))
    assert ttk.window_counts("cpu")["frames"] == 1
    ttk.reset_window_counts("cpu")
    assert ttk.window_counts("cpu") == zero
