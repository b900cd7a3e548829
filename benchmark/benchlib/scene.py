"""Frozen generators of the benchmark's inputs, in numpy.

Copies of the formulas of the port's models/shapes.py
(``many_objects_scene`` and its three prototypes), ops/texture.py
(``checkerboard``) and ops/shading.py (``Light.default``), kept here so
that a change to the program cannot move the yardstick. Each draw comes
from ``numpy.random.default_rng(seed)`` in the same order as the
program's, so at the same seed the arrays are the same
(benchmark/tests/test_bench_inputs.py holds them against the program).

The cameras are bench.py's orbit (frame i: ``base @ rot((1, 1, 0),
i / 60)``) and config 4 under a camera inside its object cloud
(``perspective(pi/3, w/h, 0.05, 10) @ look_at((0, 0, 0.6), (0, 0, 1.6))
@ model(t)``), computed in float64 and handed to both sides as float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SceneArrays:
    """A mesh as the program's ``mesh_from_numpy`` takes it."""

    positions: np.ndarray   # [N, 3] float32
    indices: np.ndarray     # [3T] int32
    colors: np.ndarray      # [N, 3] float32
    normals: np.ndarray     # [N, 3] float32
    uvs: np.ndarray         # [N, 2] float32

    @property
    def triangles(self) -> int:
        return self.indices.shape[0] // 3


def _f32(a):
    return np.ascontiguousarray(np.asarray(a).astype(np.float32))


def uv_sphere(radius=0.2, segments=13):
    """(positions, normals, colors, uvs, indices) of the program's
    ``shapes.uv_sphere`` (outward normals, rings = segments)."""
    su = sv = segments
    phi = np.pi * np.arange(sv + 1) / sv
    theta = 2.0 * np.pi * np.arange(su + 1) / su
    sp, cp = np.sin(phi)[:, None], np.cos(phi)[:, None]
    st, ct = np.sin(theta)[None, :], np.cos(theta)[None, :]
    unit = np.stack([sp * ct, cp * np.ones_like(st), sp * st],
                    axis=-1).reshape(-1, 3)
    uvs = np.stack(np.meshgrid(np.arange(su + 1) / su,
                               np.arange(sv + 1) / sv, indexing="xy"),
                   axis=-1).reshape(-1, 2)
    tris = []
    for r in range(sv):
        for c in range(su):
            a, b = r * (su + 1) + c, r * (su + 1) + c + 1
            cc, d = (r + 1) * (su + 1) + c, (r + 1) * (su + 1) + c + 1
            if r > 0:
                tris.append([a, b, cc])
            if r < sv - 1:
                tris.append([b, d, cc])
    return (radius * unit, unit, np.abs(unit), uvs,
            np.asarray(tris, np.int32).reshape(-1))


_BOX_FACES = [
    ((1, 0, 0), (0, 0, 1), (0, 1, 0)),
    ((-1, 0, 0), (0, 0, -1), (0, 1, 0)),
    ((0, 1, 0), (1, 0, 0), (0, 0, 1)),
    ((0, -1, 0), (1, 0, 0), (0, 0, -1)),
    ((0, 0, 1), (-1, 0, 0), (0, 1, 0)),
    ((0, 0, -1), (1, 0, 0), (0, 1, 0)),
]


def box(size=1.0):
    """The program's ``shapes.box(face_colors=False)``."""
    half = np.broadcast_to(np.asarray(size, np.float64) / 2.0, (3,))
    pos, nrm, uvs, col, idx = [], [], [], [], []
    for n, tu, tv in _BOX_FACES:
        n, tu, tv = (np.asarray(v, np.float64) for v in (n, tu, tv))
        base = len(pos)
        for du, dv in [(-1, -1), (1, -1), (1, 1), (-1, 1)]:
            pos.append((n + du * tu + dv * tv) * half)
            nrm.append(n)
            uvs.append(((du + 1) / 2, (dv + 1) / 2))
            col.append(np.abs(n).astype(np.float32))
        idx += [base, base + 1, base + 2, base, base + 2, base + 3]
    return (np.asarray(pos), np.asarray(nrm), np.asarray(col),
            np.asarray(uvs), np.asarray(idx, np.int32))


def torus(major_radius=0.3, minor_radius=0.12, segments_u=48,
          segments_v=24):
    """The program's ``shapes.torus``."""
    su, sv = segments_u, segments_v
    iu, iv = np.arange(su + 1), np.arange(sv + 1)
    theta, phi = 2 * np.pi * iu / su, 2 * np.pi * iv / sv
    ct, st = np.cos(theta)[:, None], np.sin(theta)[:, None]
    cp, sp = np.cos(phi)[None, :], np.sin(phi)[None, :]
    pos = np.stack([(major_radius + minor_radius * cp) * ct,
                    minor_radius * sp * np.ones_like(ct),
                    (major_radius + minor_radius * cp) * st],
                   axis=-1).reshape(-1, 3)
    nrm = np.stack([cp * ct, sp * np.ones_like(ct), cp * st],
                   axis=-1).reshape(-1, 3)
    uvs = np.stack(np.meshgrid(iv / sv, iu / su, indexing="xy"),
                   axis=-1).reshape(-1, 2)
    tris = []
    for r in range(su):
        for c in range(sv):
            a = r * (sv + 1) + c
            cc = a + (sv + 1)
            tris += [[a, a + 1, cc], [a + 1, cc + 1, cc]]
    return pos, nrm, np.abs(nrm), uvs, np.asarray(tris, np.int32).reshape(-1)


def many_objects_scene(target_triangles=100_000, seed=0,
                       extent=1.6) -> SceneArrays:
    """Config 4's scene: the program's ``shapes.many_objects_scene``.
    The prototypes pass through float32 first, as the program's
    ``mesh_from_numpy`` leaves them."""
    rng = np.random.default_rng(seed)
    protos = []
    for p in (uv_sphere(radius=0.5, segments=10), box(size=1.0),
              torus(major_radius=0.5, minor_radius=0.2, segments_u=12,
                    segments_v=8)):
        pos, nrm, col, uv, idx = p
        protos.append((_f32(pos), _f32(nrm), _f32(col), _f32(uv),
                       idx.astype(np.int32)))
    positions, normals, colors, uvs, indices = [], [], [], [], []
    total = offset = 0
    while total < target_triangles:
        ppos, pnrm, pcol, puv, pidx = protos[rng.integers(len(protos))]
        ntris = pidx.shape[0] // 3
        if total + ntris > target_triangles and total > 0:
            break
        scale = rng.uniform(0.03, 0.10)
        center = rng.uniform(-extent / 2, extent / 2, size=3)
        center[2] = rng.uniform(0.1, 0.9)
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        tint = rng.uniform(0.3, 1.0, size=3).astype(np.float32)
        positions.append(ppos @ (q.T * scale) + center)
        normals.append(pnrm @ q.T)
        colors.append(pcol * tint)
        uvs.append(puv)
        indices.append(pidx + offset)
        offset += ppos.shape[0]
        total += ntris
    return SceneArrays(
        positions=_f32(np.concatenate(positions)),
        indices=np.ascontiguousarray(
            np.concatenate(indices).astype(np.int32)),
        colors=_f32(np.concatenate(colors)),
        normals=_f32(np.concatenate(normals)),
        uvs=_f32(np.concatenate(uvs)))


def checkerboard(size=256, tiles=8, c0=(1.0, 1.0, 1.0),
                 c1=(0.2, 0.2, 0.2)) -> np.ndarray:
    """[size, size, 3] float32: the program's ``checkerboard`` data."""
    ij = np.arange(size) * tiles // size
    mask = (ij[:, None] + ij[None, :]) % 2
    return np.where(mask[..., None] == 0, _f32(c0), _f32(c1)).astype(
        np.float32)


# The reference's light (the program's Light.default): direction the
# light travels, color, ambient, specular, shininess.
LIGHT = dict(direction=(0.3, -0.5, 0.8), color=(1.0, 1.0, 1.0),
             ambient=(0.15, 0.15, 0.15), specular=(0.5, 0.5, 0.5),
             shininess=32.0)


# -- transforms (float64, column vectors, quaternions (x, y, z, w)) --------

def quat_matrix(axis, angle) -> np.ndarray:
    """4x4 rotation by ``angle`` about the unit ``axis``."""
    ax = np.asarray(axis, np.float64)
    ax = ax / np.linalg.norm(ax)
    x, y, z = ax * np.sin(angle / 2.0)
    w = np.cos(angle / 2.0)
    m = np.eye(4)
    m[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)],
                 [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)],
                 [2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)]]
    return m


def translation(t) -> np.ndarray:
    m = np.eye(4)
    m[:3, 3] = t
    return m


# The reference demo projection: w = z + 1.
REFERENCE_PROJECTION = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0],
                                 [0, 0, 1.0, 0], [0, 0, 1.0, 1.0]])


def model_matrix(t, spin=0.3, lift=0.4) -> np.ndarray:
    """Config 4's model at time t: translate (0, 0, lift) after a turn
    of ``spin * t`` about y."""
    return translation((0.0, 0.0, lift)) @ quat_matrix((0, 1, 0), spin * t)


def perspective(fov_y, aspect, near, far) -> np.ndarray:
    f = 1.0 / np.tan(fov_y / 2.0)
    m = np.zeros((4, 4))
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = far / (near - far)
    m[2, 3] = far * near / (near - far)
    m[3, 2] = -1.0
    return m


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    eye, target, up = (np.asarray(v, np.float64) for v in (eye, target, up))
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    rot = np.stack([right, np.cross(right, fwd), -fwd])
    m = np.eye(4)
    m[:3, :3] = rot
    m[:3, 3] = -rot @ eye
    return m


def orbit_transforms(frames, axis=(1.0, 1.0, 0.0), fps=60.0,
                     lift=0.4) -> np.ndarray:
    """[F, 4, 4] float32: bench.py's orbit, frame i ``base @ rot(axis,
    i / fps)`` with base the reference projection over config 4's model
    at t = 0."""
    base = REFERENCE_PROJECTION @ model_matrix(0.0, lift=lift)
    return np.stack([base @ quat_matrix(axis, i / fps)
                     for i in frames]).astype(np.float32)


def inside_transforms(times, width, height, lift=0.4, spin=0.3,
                      eye=(0.0, 0.0, 0.6), target=(0.0, 0.0, 1.6),
                      fov_y=np.pi / 3, near=0.05, far=10.0) -> np.ndarray:
    """[F, 4, 4] float32: the camera inside the object cloud at each
    time, ``perspective @ look_at @ model(t)`` (model(t) a turn of
    ``spin * t`` about y, then the lift)."""
    view = (perspective(fov_y, width / height, near, far)
            @ look_at(eye, target) @ translation((0.0, 0.0, lift)))
    ang = spin * np.asarray(times, np.float64)
    rot = np.zeros((ang.shape[0], 4, 4))
    rot[:, 0, 0] = rot[:, 2, 2] = np.cos(ang)
    rot[:, 0, 2] = np.sin(ang)
    rot[:, 2, 0] = -np.sin(ang)
    rot[:, 1, 1] = rot[:, 3, 3] = 1.0
    return (view @ rot).astype(np.float32)
