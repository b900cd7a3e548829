"""Host ms a frame inside ``sr.frame_graph.key`` (``FrameGraph``'s work
before it launches anything: whether a graph can hold the frame, its
key and the capture's lookup), over the traced frames (layer: compiled
frame). Nothing where the program has no such span."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchlib import spans  # noqa: E402


def read(ctx):
    return spans.per_item(ctx, "sr.frame_graph.key", 2)
