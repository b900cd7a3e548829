"""Procedural meshes, generated in numpy exactly as the JAX package does
(same formulas, same ``default_rng(seed)`` draws in the same order), so
that both packages build bit-identical scenes. Each lands on the card
unless ``device`` says otherwise (device.py)."""

from __future__ import annotations

import numpy as np

from .mesh import Mesh, mesh_from_numpy


def uv_sphere(radius: float = 0.2, segments: int = 13,
              rings: int | None = None,
              inward_normals: bool = False, device=None) -> Mesh:
    """(segments x rings) latitude/longitude sphere; pole quads become
    single triangles. Colors are abs(normal), as in the reference demo."""
    rings = segments if rings is None else rings
    su, sv = segments, rings
    v_idx = np.arange(sv + 1)
    u_idx = np.arange(su + 1)
    phi = np.pi * v_idx / sv
    theta = 2.0 * np.pi * u_idx / su
    sp, cp = np.sin(phi)[:, None], np.cos(phi)[:, None]
    st, ct = np.sin(theta)[None, :], np.cos(theta)[None, :]
    unit = np.stack([sp * ct, cp * np.ones_like(st), sp * st],
                    axis=-1).reshape(-1, 3)
    positions = radius * unit
    normals = -unit if inward_normals else unit
    uvs = np.stack(np.meshgrid(u_idx / su, v_idx / sv, indexing="xy"),
                   axis=-1).reshape(-1, 2)

    def vid(r, c):
        return r * (su + 1) + c

    tris = []
    for r in range(sv):
        for c in range(su):
            a, b = vid(r, c), vid(r, c + 1)
            cc, d = vid(r + 1, c), vid(r + 1, c + 1)
            if r > 0:
                tris.append([a, b, cc])
            if r < sv - 1:
                tris.append([b, d, cc])
    return mesh_from_numpy(positions, np.asarray(tris, np.int32).reshape(-1),
                           colors=np.abs(normals), normals=normals, uvs=uvs,
                           device=device)


_BOX_FACES = [
    # (normal, corner axes) — +x, -x, +y, -y, +z, -z
    ((1, 0, 0), (0, 0, 1), (0, 1, 0)),
    ((-1, 0, 0), (0, 0, -1), (0, 1, 0)),
    ((0, 1, 0), (1, 0, 0), (0, 0, 1)),
    ((0, -1, 0), (1, 0, 0), (0, 0, -1)),
    ((0, 0, 1), (-1, 0, 0), (0, 1, 0)),
    ((0, 0, -1), (1, 0, 0), (0, 1, 0)),
]

_FACE_COLORS = np.array(
    [[1, 0, 0], [0, 1, 1], [0, 1, 0], [1, 0, 1], [0, 0, 1], [1, 1, 0]],
    np.float32)


def box(size=1.0, face_colors: bool = True, device=None) -> Mesh:
    """Axis-aligned box: 24 vertices (4 per face), 12 triangles, per-face
    normals and UVs, distinct face colors or abs(normal) colors."""
    half = np.broadcast_to(np.asarray(size, np.float64) / 2.0, (3,))
    positions, normals, uvs, colors, indices = [], [], [], [], []
    for f, (n, tu, tv) in enumerate(_BOX_FACES):
        n = np.asarray(n, np.float64)
        tu = np.asarray(tu, np.float64)
        tv = np.asarray(tv, np.float64)
        base = len(positions)
        for du, dv in [(-1, -1), (1, -1), (1, 1), (-1, 1)]:
            positions.append((n + du * tu + dv * tv) * half)
            normals.append(n)
            uvs.append(((du + 1) / 2, (dv + 1) / 2))
            colors.append(_FACE_COLORS[f] if face_colors
                          else np.abs(n).astype(np.float32))
        indices += [base, base + 1, base + 2, base, base + 2, base + 3]
    return mesh_from_numpy(np.asarray(positions), np.asarray(indices),
                           colors=np.asarray(colors),
                           normals=np.asarray(normals), uvs=np.asarray(uvs),
                           device=device)


def plane(size=1.0, device=None) -> Mesh:
    """A size x size quad in the y = 0 plane facing +y (two triangles,
    white, uvs over [0, 1])."""
    h = float(size) / 2.0
    positions = np.array(
        [[-h, 0, -h], [h, 0, -h], [h, 0, h], [-h, 0, h]], np.float32)
    normals = np.tile(np.array([[0, 1, 0]], np.float32), (4, 1))
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return mesh_from_numpy(positions, np.array([0, 1, 2, 0, 2, 3], np.int32),
                           colors=np.ones((4, 3), np.float32),
                           normals=normals, uvs=uvs, device=device)


def torus(major_radius=0.3, minor_radius=0.12, segments_u=48,
          segments_v=24, device=None) -> Mesh:
    """Torus with abs(normal) colors."""
    su, sv = segments_u, segments_v
    iu = np.arange(su + 1)
    iv = np.arange(sv + 1)
    theta = 2 * np.pi * iu / su
    phi = 2 * np.pi * iv / sv
    ct, st = np.cos(theta)[:, None], np.sin(theta)[:, None]
    cp, sp = np.cos(phi)[None, :], np.sin(phi)[None, :]
    cx = (major_radius + minor_radius * cp) * ct
    cy = minor_radius * sp * np.ones_like(ct)
    cz = (major_radius + minor_radius * cp) * st
    positions = np.stack([cx, cy, cz], axis=-1).reshape(-1, 3)
    normals = np.stack([cp * ct, sp * np.ones_like(ct), cp * st],
                       axis=-1).reshape(-1, 3)
    uvs = np.stack(np.meshgrid(iv / sv, iu / su, indexing="xy"),
                   axis=-1).reshape(-1, 2)
    tris = []
    for r in range(su):
        for c in range(sv):
            a = r * (sv + 1) + c
            b = a + 1
            cc = a + (sv + 1)
            d = cc + 1
            tris += [[a, b, cc], [b, d, cc]]
    return mesh_from_numpy(positions, np.asarray(tris, np.int32).reshape(-1),
                           colors=np.abs(normals), normals=normals, uvs=uvs,
                           device=device)


def many_objects_scene(target_triangles: int = 100_000, seed: int = 0,
                       extent: float = 1.6, device=None) -> Mesh:
    """Config 4's scene: randomly placed, rotated, scaled and tinted
    spheres, boxes and tori baked into one mesh (numpy, host side)."""
    rng = np.random.default_rng(seed)
    protos = [uv_sphere(radius=0.5, segments=10, device="cpu"),
              box(size=1.0, face_colors=False, device="cpu"),
              torus(major_radius=0.5, minor_radius=0.2,
                    segments_u=12, segments_v=8, device="cpu")]
    protos_np = [(p.positions.numpy(), p.normals.numpy(), p.colors.numpy(),
                  p.uvs.numpy(), p.indices.numpy()) for p in protos]
    positions, normals, colors, uvs, indices = [], [], [], [], []
    total = 0
    offset = 0
    while total < target_triangles:
        ppos, pnrm, pcol, puv, pidx = protos_np[rng.integers(len(protos))]
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
    return mesh_from_numpy(
        np.concatenate(positions).astype(np.float32),
        np.concatenate(indices),
        colors=np.concatenate(colors),
        normals=np.concatenate(normals).astype(np.float32),
        uvs=np.concatenate(uvs), device=device)
