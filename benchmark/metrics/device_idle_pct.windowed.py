"""Share of the traced stretch of the cell's own traffic in which no
kernel, copy or memset ran on the device: ``device_idle_pct.frames``'
reader, loaded from its file, not copied (layer: device)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchlib import plugins  # noqa: E402


def read(ctx):
    return plugins.load("metrics", "device_idle_pct.frames").read(ctx)
