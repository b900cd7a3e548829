"""Device ms a frame launched inside ``sr.frame_loop.copy_out`` (the
viewer's copy of the graph's outputs), over the traced frames (layer:
entry). Nothing where the program has no spans."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchlib import spans  # noqa: E402


def read(ctx):
    return spans.per_item(ctx, "sr.frame_loop.copy_out", 0)
