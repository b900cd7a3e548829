"""Device idle ms a teapot frame inside ``sr.frame_loop.frame``, the
reading of ``frame_idle_ms.view`` (loaded from its file, not copied)
(layer: entry)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchlib import plugins  # noqa: E402


def read(ctx):
    return plugins.load("metrics", "frame_idle_ms.view").read(ctx)
