"""Config 4 under a camera inside its object cloud (the program's
``models/scenes.py`` ``config4_camera``): ``perspective(fov_y, w / h,
near, far) @ look_at(eye, target) @ model(t)``, the model turning at
``spin`` rad/s about y after a lift along z; time advances 1 / fps a
frame and wraps at one turn."""

import numpy as np

from benchlib import scene as sc

KEYS = {"kind", "eye", "target", "fov_y_deg", "near", "far", "fps", "lift",
        "spin"}


def period_s(cam: dict) -> float:
    """One turn of the model, in seconds."""
    return 2.0 * np.pi / cam["spin"]


def model(cam: dict) -> np.ndarray:
    """The model matrix the render pass carries (its normals' model):
    the model at t = 0."""
    return sc.model_matrix(0.0, cam["spin"], cam["lift"])


def transforms(cfg: dict, ticks, start: float = 0.0) -> np.ndarray:
    """[F, 4, 4] float32 at frames ``ticks`` after ``start`` seconds."""
    cam = cfg["camera"]
    times = np.mod(start + np.asarray(ticks) / cam["fps"], period_s(cam))
    return sc.inside_transforms(
        times, cfg["width"], cfg["height"], lift=cam["lift"],
        spin=cam["spin"], eye=cam["eye"], target=cam["target"],
        fov_y=np.deg2rad(cam["fov_y_deg"]), near=cam["near"],
        far=cam["far"])
