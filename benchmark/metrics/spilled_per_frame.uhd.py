"""Triangles spilled to the overflow path per frame rendered: the
program's spill counter (``ops.binning.spill_counts`` on the run's
device: every bin build's spills, by reason, added on the device, so
replayed frames count too) over every frame the run rendered, set-up,
window and traced stretches (each call sweeps the whole orbit, so each
holds the same mix). Nothing where the program has no such counter
(layer: spill)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchlib import program  # noqa: E402


def read(ctx):
    device = getattr(ctx.driver, "device", None)
    counts = getattr(program.module("ops.binning"), "spill_counts", None)
    if device is None or counts is None:
        return None
    c = counts(device)
    if not c["frames"]:
        return None
    return (c["budget"] + c["kmax"] + c["unsafe"]) / c["frames"]
