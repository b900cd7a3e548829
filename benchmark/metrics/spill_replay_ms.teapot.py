"""Device ms a replayed teapot frame of the overflow pass (``sr.spill``),
where nothing spills: the list, the gathers and two 1024x1024 seed
fills, K3 and K4 at a count of 0. The replay's device operations cut by
the layer map in its span's name (layer: spill). Nothing where the
program has no spans or a replay does not match its map."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchlib import spans  # noqa: E402


def read(ctx):
    return spans.replay_ms(ctx, "spill")
