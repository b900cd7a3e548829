"""Device idle ms a frame inside ``sr.frame_loop.frame`` (the viewer's
``FrameLoop.frame``: the transform, the replay and the copy out): the
idle gaps between device operations whose middle lies inside the span
on its thread, over the traced frames (layer: entry). Nothing where the
program has no spans."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchlib import spans  # noqa: E402


def read(ctx):
    return spans.per_item(ctx, "sr.frame_loop.frame", 1)
