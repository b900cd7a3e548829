"""The general traffic generator: what every entry point's driver
shares. A traffic file names its entry point (``"entry"``), whose driver
is ``benchmark/entries/<entry>.py``; the file's other keys are the
driver's parameters (its ``KEYS``), and a key it does not read is
refused.

A driver builds its inputs from the seed, warms up the shapes its
traffic uses (set-up), then runs one unit of traffic per ``step()``
inside the measured window, keeping the outputs that the check after
the window compares. The reference's own work in set-up (picking the
frames the check compares, rendering training targets) is timed apart
(``ref_s``) and left out of ``setup_s``. Every driver runs on the
device it is given (the card in a run, the CPU in the benchmark's
tests).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import numpy as np
import torch

from . import compare
from . import inputs as inp
from . import plugins
from . import program
from . import reference as ref

# Keys of every traffic file besides its driver's own.
COMMON_KEYS = {"entry", "why"}


def load(traffic: dict):
    """The driver class of a traffic file, its keys checked."""
    mod = plugins.load("entries", traffic["entry"])
    plugins.check_keys(f"traffic {traffic['entry']!r}", traffic,
                       COMMON_KEYS | mod.Driver.KEYS)
    return mod.Driver


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rng(seed, stream):
    """The traffic's own random stream, apart from the scene layout's."""
    return np.random.default_rng([seed, stream])


def p95(xs):
    """The 95th percentile of every sample (linear between ranks)."""
    return float(np.percentile(np.asarray(xs), 95))


def nearest_approach(scene, transforms):
    """Per transform, the least clip-space w > CLIP_EPS over the mesh's
    vertices: the frame whose geometry comes nearest the eye reaches
    farthest off screen, where the program's overflow path (unsafe
    triangles, bins past their cap) takes over."""
    p = scene["positions"]
    w = (transforms[:, 3, :3] @ p.T) + transforms[:, 3, 3:4]   # [F, N]
    w = torch.where(w > ref.CLIP_EPS, w, torch.full_like(w, float("inf")))
    return w.amin(dim=1)


def near_cuts(scene, transforms, chunk=64):
    """Per transform, the triangles whose corners lie on both sides of
    the near plane (w = CLIP_EPS): the triangles the clip cuts."""
    p = scene["positions"]
    tris = scene["indices"].reshape(-1, 3).long()
    out = []
    for i in range(0, transforms.shape[0], chunk):
        t = transforms[i:i + chunk]
        w = ((t[:, 3, :3] @ p.T) + t[:, 3, 3:4])[:, tris]      # [F, T, 3]
        out.append(((w.amin(-1) < ref.CLIP_EPS)
                    & (w.amax(-1) >= ref.CLIP_EPS)).sum(-1))
    return torch.cat(out)


@dataclasses.dataclass
class Item:
    """One output the check compares: what the program produced and
    what the reference needs to produce it again."""

    label: str
    transform: torch.Tensor        # [4, 4] float32 (device)
    color: torch.Tensor = None     # [H, W, 4] float32, or uint8 RGBA8
    depth: torch.Tensor = None     # [H, W]


class Driver:
    """Common state: configuration, traffic, seed, device, the inputs."""

    KEYS: set = set()

    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        # The scene's layout seed: the run's, unless the traffic fixes it.
        self.inputs = inp.make(cfg, traffic.get("layout_seed", seed))
        self.cam = inp.camera(cfg)
        self.items_done = 0
        self.attempted = 0
        self.ref_s = 0.0                   # the reference's set-up work
        self.kept: list[Item] = []
        self.host_s: list[float] = []      # host clock: call to return
        self.item_s: list[float] = []      # host clock: call to done
        self._base = None

    def rp(self, transform):
        """The program's RenderPass under ``transform``: the scene is
        built once, on the first call."""
        if self._base is None:
            self._base = program.render_pass(self.inputs, self.cfg,
                                              transform, self.device)
        return dataclasses.replace(self._base, transform=transform)

    def camera(self, ticks, start=0.0):
        return torch.from_numpy(inp.transforms(self.cfg, ticks,
                                               start)).to(self.device)

    def cycle_frames(self) -> int:
        """Frames in one pass of the camera's path."""
        cam = self.cfg["camera"]
        return int(math.ceil(self.cam.period_s(cam) * cam["fps"] - 1e-9))

    def reference_scene(self):
        return self.inputs.reference_scene(self.device)

    @contextlib.contextmanager
    def reference_work(self):
        """Time the reference's work in set-up, to leave it out of
        ``setup_s``."""
        sync(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            sync(self.device)
            self.ref_s += time.perf_counter() - t0

    def compared(self, log):
        """The check's numbers of the frames the window kept against the
        reference's, and whether the window reached every frame the
        check compares."""
        scene = self.reference_scene()
        items = self.check_items(scene)
        numbers = compare.frame_numbers(items, scene, self.cfg)
        log("compared: " + "; ".join(it.label for it in items))
        want = self.traffic["compare_frames"]
        if len(items) < want:
            log(f"the window reached {len(items)} of the {want} frames the "
                f"check compares: not correct")
        return numbers, len(items) >= want
