"""Config 3's turn (the program's ``models/scenes.py``
``config3_phong_mesh``): frame at time t is ``P_ref @ T(0, 0, lift) @
S(scale) @ R(axis, spin * t)``, P_ref the reference projection (w = z +
1); with a uniform scale this is the program's ``P_ref @ trs(T, R, S)``.
Time advances 1 / fps a frame and wraps at one turn. The normals' model
stays ``T(0, 0, lift) @ S(scale)``, the model at t = 0, as the orbit
cells keep theirs: the camera turns about a teapot and a light that
stay still."""

import numpy as np

from benchlib import scene as sc

KEYS = {"kind", "axis", "spin", "fps", "lift", "scale"}


def period_s(cam: dict) -> float:
    """One turn, in seconds."""
    return 2.0 * np.pi / cam["spin"]


def model(cam: dict) -> np.ndarray:
    """The model matrix the render pass carries (its normals' model)."""
    return sc.translation((0.0, 0.0, cam["lift"])) @ np.diag(
        [cam["scale"]] * 3 + [1.0])


def transforms(cfg: dict, ticks, start: float = 0.0) -> np.ndarray:
    """[F, 4, 4] float32 at frames ``ticks`` after ``start`` seconds."""
    cam = cfg["camera"]
    times = np.mod(start + np.asarray(ticks, np.float64) / cam["fps"],
                   period_s(cam))
    return (sc.REFERENCE_PROJECTION @ model(cam)
            @ rotations(cam["axis"], cam["spin"] * times)).astype(np.float32)


def rotations(axis, angles) -> np.ndarray:
    """[F, 4, 4]: ``scene.quat_matrix(axis, a)`` for each of ``angles``."""
    ax = np.asarray(axis, np.float64)
    ax = ax / np.linalg.norm(ax)
    half = np.asarray(angles, np.float64) / 2.0
    x, y, z = (ax[:, None] * np.sin(half)[None, :])
    w = np.cos(half)
    m = np.zeros((half.shape[0], 4, 4))
    m[:, 0, :3] = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                            2 * (x * z + w * y)], -1)
    m[:, 1, :3] = np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                            2 * (y * z - w * x)], -1)
    m[:, 2, :3] = np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                            1 - 2 * (x * x + y * y)], -1)
    m[:, 3, 3] = 1.0
    return m
