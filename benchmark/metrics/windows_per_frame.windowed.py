"""Windows a frame on the windowed sampler route: the program's window
counter (``ops.texture_kernel.window_counts`` on the run's device: every
windowed frame's ``nwin``, added on the device, so replayed frames count
too) over the frames it counted, set-up, window and traced stretches.
Nothing where the program has no such counter (layer: texture tail)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchlib import program  # noqa: E402


def read(ctx):
    device = getattr(ctx.driver, "device", None)
    counts = getattr(program.module("ops.texture_kernel"), "window_counts",
                     None)
    if device is None or counts is None:
        return None
    c = counts(device)
    if not c["frames"]:
        return None
    return c["windows"] / c["frames"]
