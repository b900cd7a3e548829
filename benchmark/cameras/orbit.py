"""bench.py's orbit: frame i is ``base @ rot(axis, i / fps)``, ``base``
the reference projection over config 4's model (a lift along z), over
``frames`` frames."""

import numpy as np

from benchlib import scene as sc

KEYS = {"kind", "axis", "fps", "frames", "lift"}


def period_s(cam: dict) -> float:
    """The length of the camera's path in seconds."""
    return cam["frames"] / cam["fps"]


def model(cam: dict) -> np.ndarray:
    """The model matrix the render pass carries (its normals' model)."""
    return sc.model_matrix(0.0, lift=cam["lift"])


def transforms(cfg: dict, ticks, start: float = 0.0) -> np.ndarray:
    """[F, 4, 4] float32 at frames ``ticks`` after ``start`` seconds."""
    cam = cfg["camera"]
    frames = np.asarray(ticks, np.float64) + start * cam["fps"]
    return sc.orbit_transforms(frames, cam["axis"], cam["fps"], cam["lift"])
