"""Share of the traced stretch of teapot frames in which the device ran
nothing, the reading of ``device_idle_pct.view`` (loaded from its file,
not copied), in % (layer: device)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchlib import plugins  # noqa: E402


def read(ctx):
    return plugins.load("metrics", "device_idle_pct.view").read(ctx)
