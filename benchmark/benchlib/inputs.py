"""A configuration's inputs at a seed, made by the generators it names
(``benchmark/scenes/``, ``benchmark/textures/``, ``benchmark/cameras/``
over the frozen formulas of benchlib/scene.py), and the same as tensors
for the reference.

Every key of a configuration file is read here, by the program's render
pass (benchlib/program.py) or by the reference; a key nothing reads, or
a value the reference cannot draw, is refused before anything runs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import plugins
from . import reference as ref
from . import scene as sc

KEYS = {"name", "scene", "width", "height", "shading", "precision",
        "cull_backfaces", "clip_near", "perspective_correct",
        "sampler_route", "texture", "light", "camera"}
# The program's texture-tail routes (its SR_TEX_WINDOWED); "default"
# leaves the choice to the program.
SAMPLER_ROUTES = ("default", "0", "1", "adaptive")
# Base color of "flat" shading, on both sides.
FLAT_COLOR = (1.0, 1.0, 1.0)


@dataclasses.dataclass
class Inputs:
    arrays: sc.SceneArrays
    texture: torch.Tensor | None    # [Th, Tw, 3] float32 (CPU)
    light: dict | None              # Light fields as float32 tensors (CPU)
    model: torch.Tensor             # [4, 4] float32 (CPU): normals' model

    def reference_scene(self, device) -> dict:
        """The reference's view of the same inputs, on ``device``."""
        a = self.arrays
        t = lambda x: torch.from_numpy(x).to(device)
        return dict(positions=t(a.positions), indices=t(a.indices),
                    colors=t(a.colors), normals=t(a.normals), uvs=t(a.uvs),
                    texture=(None if self.texture is None
                             else self.texture.to(device)),
                    light=(None if self.light is None else
                           {k: v.to(device) for k, v in self.light.items()}),
                    flat_color=torch.tensor(FLAT_COLOR, device=device),
                    normal_matrix=normal_matrix(self.model).to(device))


def normal_matrix(model: torch.Tensor) -> torch.Tensor:
    """Inverse transpose of the model's 3x3 (in float64, then float32)."""
    m = model[:3, :3].double()
    return torch.linalg.inv(m).T.float()


def validate(cfg: dict) -> None:
    """Refuse a configuration with a key nothing reads or a value the
    reference does not draw (the program refuses its own)."""
    plugins.check_keys(f"configuration {cfg.get('name')!r}", cfg, KEYS)
    need = KEYS - {"texture", "light"}
    missing = sorted(need - set(cfg))
    if missing:
        raise ValueError(f"configuration {cfg.get('name')!r} lacks {missing}")
    for key, ok in (("shading", ref.SHADINGS), ("precision", ref.PRECISIONS),
                    ("sampler_route", SAMPLER_ROUTES)):
        if cfg[key] not in ok:
            raise ValueError(f"{key} {cfg[key]!r} is not one of {list(ok)}")
    scene = plugins.load("scenes", cfg["scene"]["generator"])
    plugins.check_keys("scene", cfg["scene"], scene.KEYS)
    cam = plugins.load("cameras", cfg["camera"]["kind"])
    plugins.check_keys("camera", cfg["camera"], cam.KEYS)
    tx = cfg.get("texture")
    if (tx is None) != (cfg["shading"] != "textured"):
        raise ValueError("a texture goes with textured shading, and only "
                         "with it")
    if tx is not None:
        plugins.check_keys("texture", tx, plugins.load(
            "textures", tx["generator"]).KEYS)
        if tx["filter"] not in ref.FILTERS or tx["wrap"] not in ref.WRAPS:
            raise ValueError(f"texture filter {tx['filter']!r} / wrap "
                             f"{tx['wrap']!r}: the reference draws "
                             f"{ref.FILTERS} / {ref.WRAPS}")
    light = cfg.get("light")
    if not (light is None or light == "default" or
            (isinstance(light, dict) and set(light) == set(sc.LIGHT))):
        raise ValueError(f"light {light!r}: \"default\", or an object of "
                         f"{sorted(sc.LIGHT)}")


def make(cfg: dict, seed: int) -> Inputs:
    """The configuration's inputs at ``seed`` (the scene's seed)."""
    validate(cfg)
    arrays = plugins.load("scenes", cfg["scene"]["generator"]).make(
        cfg["scene"], seed)
    tx = cfg.get("texture")
    texture = None if tx is None else torch.from_numpy(
        plugins.load("textures", tx["generator"]).make(tx))
    light = cfg.get("light")
    if light is not None:
        light = {k: torch.tensor(v, dtype=torch.float32) for k, v in
                 (sc.LIGHT if light == "default" else light).items()}
    model = camera(cfg).model(cfg["camera"])
    return Inputs(arrays, texture, light,
                  torch.from_numpy(model.astype(np.float32)))


def camera(cfg: dict):
    """The configuration's camera module (``benchmark/cameras/``)."""
    return plugins.load("cameras", cfg["camera"]["kind"])


def transforms(cfg: dict, ticks, start: float = 0.0) -> np.ndarray:
    """[F, 4, 4] float32 transforms of the camera at frames ``ticks``
    after ``start`` seconds."""
    return camera(cfg).transforms(cfg, ticks, start)
