"""A run with the timed path broken underneath comes out not correct:
the harness's look for a chip is skipped (CPU, small sizes), the rest
of the run is driven as on the card. Faults, where the cell can have
them: a step that returns its state unchanged (a stale frame or
texture, in set-up's steps or only in the window's), half of the batch
left out, an answer altered where it is produced (a whole frame's
colour, or one G-buffer plane of the overflow path's pixels alone). One
card only: no exchange between chips to leave out."""

import dataclasses

import pytest
import torch

from conftest import run_small
from benchlib import program


def _stale_frames(monkeypatch):
    """Every frame renders the first transform the program was given."""
    mod = program.module("render")
    orig, first = mod.render_triangles, []

    def stale(rp, *a, **k):
        if not first:
            first.append(rp.transform.clone())
        return orig(dataclasses.replace(rp, transform=first[0]), *a, **k)
    monkeypatch.setattr(mod, "render_triangles", stale)


def _altered_color(monkeypatch):
    """Every frame's color is 2% dimmer than the program made it."""
    mod = program.module("render")
    orig = mod.render_triangles

    def dim(*a, **k):
        fb = orig(*a, **k)
        c = fb.color.clone()
        c[..., :3] *= 0.98
        return dataclasses.replace(fb, color=c)
    monkeypatch.setattr(mod, "render_triangles", dim)


def _spill_plane(monkeypatch):
    """Frames spill (the bins' cap at one record a band, as the
    program's tests force it), and the first G-buffer plane that K4
    writes for the overflow winners is scaled by 0.9: depth and ids
    stay right, and only the overflow path's pixels change."""
    binning = program.module("ops.binning")
    monkeypatch.setattr(binning, "KMAX", 0.25)
    orig = binning.resolve_merge_kernel

    def faulty(*a, **k):
        gb = orig(*a, **k)
        gb[0].mul_(0.9)
        return gb
    monkeypatch.setattr(binning, "resolve_merge_kernel", faulty)


def _half_batch(monkeypatch):
    """render_batch renders the first half of its frames only."""
    mod = program.module("parallel.batch")
    orig = mod.render_batch

    def half(rp, ts, *a, **k):
        fb = orig(rp, ts[: len(ts) // 2], *a, **k)
        color = torch.zeros((len(ts),) + tuple(fb.color.shape[1:]))
        depth = torch.full((len(ts),) + tuple(fb.depth.shape[1:]),
                           float("inf"))
        color[: len(ts) // 2], depth[: len(ts) // 2] = fb.color, fb.depth
        return dataclasses.replace(fb, color=color, depth=depth)
    monkeypatch.setattr(mod, "render_batch", half)


FRAME_FAULTS = {"stale": _stale_frames, "altered": _altered_color,
                "spill_plane": _spill_plane}


@pytest.mark.parametrize("fault", ["stale", "altered", "half",
                                   "spill_plane"])
def test_batch_fault_is_caught(monkeypatch, fault):
    {"half": _half_batch, **FRAME_FAULTS}[fault](monkeypatch)
    res, _ = run_small("config4_orbit.batch64")
    assert res["correct"] is False


@pytest.mark.parametrize("cell", ["config4_orbit.eager",
                                  "config4_inside.view"])
@pytest.mark.parametrize("fault", sorted(FRAME_FAULTS))
def test_frame_fault_is_caught(monkeypatch, cell, fault):
    FRAME_FAULTS[fault](monkeypatch)
    res, _ = run_small(cell, seconds=1.0)
    assert res["correct"] is False


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered",
                                   "window_unchanged"])
def test_training_fault_is_caught(monkeypatch, fault):
    mod = program.module("parallel.sharding")
    orig = mod.texture_train_step
    calls = []

    def broken(tex, rp, ts, targets, *a, **k):
        calls.append(1)
        if fault == "unchanged" or (fault == "window_unchanged"
                                    and len(calls) > 3):
            return tex, orig(tex, rp, ts, targets, *a, **k)[1]
        if fault == "half":
            n = len(ts) // 2
            return orig(tex, rp, ts[:n], targets[:n], *a, **k)
        new, loss = orig(tex, rp, ts, targets, *a, **k)
        return new, (loss * 1.01 if fault == "altered" else loss)
    monkeypatch.setattr(mod, "texture_train_step", broken)
    res, _ = run_small("config4_orbit.fit4", seconds=0.2)
    assert res["correct"] is False


@pytest.mark.parametrize("cell", ["config4_orbit.batch64",
                                  "config4_orbit.eager",
                                  "config4_inside.view",
                                  "config4_orbit.fit4"])
def test_sound_run_is_correct(cell):
    res, rows = run_small(cell, seconds=1.0)
    assert res["correct"] is True, rows


def test_sound_spilling_run_is_correct(monkeypatch):
    """Frames that spill, with no fault, come out correct: what the
    spill fault's test catches is the fault."""
    monkeypatch.setattr(program.module("ops.binning"), "KMAX", 0.25)
    res, rows = run_small("config4_orbit.batch64")
    assert res["correct"] is True, rows
