"""Device ms a replayed frame of the texture tail on the windowed
sampler route (``sr.texture_tail``: the window prep, K7, the window
counter and the torch combine): ``texture_tail_replay_ms.frames``'
reader, loaded from its file, not copied (layer: texture tail)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchlib import plugins  # noqa: E402


def read(ctx):
    return plugins.load("metrics", "texture_tail_replay_ms.frames").read(ctx)
