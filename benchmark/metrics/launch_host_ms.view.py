"""Host ms a frame inside ``sr.frame_graph.launch`` (the replayed
graph's launch alone, nested in the replay's span after the transform's
copy), over the traced frames (layer: compiled frame). Nothing where
the program has no such span."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchlib import spans  # noqa: E402


def read(ctx):
    return spans.per_item(ctx, "sr.frame_graph.launch", 2)
