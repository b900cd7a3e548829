"""Device ms a replayed frame of the overflow pass (``sr.spill``: the
overflow list, its rows and records, the seed planes, K3's merge and
K4's resolve): the replay's device operations cut by the layer map in
its span's name, over the traced call's replays (layer: spill). Nothing
where the program has no spans or a replay does not match its map."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchlib import spans  # noqa: E402


def read(ctx):
    return spans.replay_ms(ctx, "spill")
