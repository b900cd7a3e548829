"""The Utah teapot, generated from the original Newell bicubic Bezier
patch data (public domain; the compact 10-patch + symmetry form
popularized by GLUT's teapot renderer).

The port's copy of the JAX package's models/teapot.py (pure numpy, so
both packages give the same arrays bit for bit). Config 3
(models/scenes.py) falls back to :func:`teapot_mesh` when
assets/teapot.obj is missing.

Geometry notes: the canonical data is z-up with the spout along -x; it
is rotated to the renderer's y-up convention and centered and scaled to
fit in a unit-ish box. Vertices are welded by position before normal
accumulation so shading is smooth across patch seams.
"""

from __future__ import annotations

import numpy as np

# 10 unique patches; the first 6 (rim, body x2, lid x2, bottom) reflect in
# x and y (4 copies), the last 4 (handle x2, spout x2) in y only (2 copies)
# -> 32 patches total.
_PATCHES = [
    # rim
    [102, 103, 104, 105, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    # body
    [12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27],
    [24, 25, 26, 27, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40],
    # lid
    [96, 96, 96, 96, 97, 98, 99, 100, 101, 101, 101, 101, 0, 1, 2, 3],
    [0, 1, 2, 3, 106, 107, 108, 109, 110, 111, 112, 113, 114, 115, 116,
     117],
    # bottom
    [118, 118, 118, 118, 124, 122, 119, 121, 123, 126, 125, 120, 40, 39,
     38, 37],
    # handle
    [41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56],
    [53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 28, 65, 66, 67],
    # spout
    [68, 69, 70, 71, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 83],
    [80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 90, 91, 92, 93, 94, 95],
]

_CP = np.array([
    [0.2, 0, 2.7], [0.2, -0.112, 2.7], [0.112, -0.2, 2.7], [0, -0.2, 2.7],
    [1.3375, 0, 2.53125], [1.3375, -0.749, 2.53125],
    [0.749, -1.3375, 2.53125], [0, -1.3375, 2.53125],
    [1.4375, 0, 2.53125], [1.4375, -0.805, 2.53125],
    [0.805, -1.4375, 2.53125], [0, -1.4375, 2.53125],
    [1.5, 0, 2.4], [1.5, -0.84, 2.4], [0.84, -1.5, 2.4], [0, -1.5, 2.4],
    [1.75, 0, 1.875], [1.75, -0.98, 1.875], [0.98, -1.75, 1.875],
    [0, -1.75, 1.875],
    [2, 0, 1.35], [2, -1.12, 1.35], [1.12, -2, 1.35], [0, -2, 1.35],
    [2, 0, 0.9], [2, -1.12, 0.9], [1.12, -2, 0.9], [0, -2, 0.9],
    [-2, 0, 0.9],
    [2, 0, 0.45], [2, -1.12, 0.45], [1.12, -2, 0.45], [0, -2, 0.45],
    [1.5, 0, 0.225], [1.5, -0.84, 0.225], [0.84, -1.5, 0.225],
    [0, -1.5, 0.225],
    [1.5, 0, 0.15], [1.5, -0.84, 0.15], [0.84, -1.5, 0.15], [0, -1.5, 0.15],
    [-1.6, 0, 2.025], [-1.6, -0.3, 2.025], [-1.5, -0.3, 2.25],
    [-1.5, 0, 2.25],
    [-2.3, 0, 2.025], [-2.3, -0.3, 2.025], [-2.7, -0.3, 2.025],
    [-2.7, 0, 2.025],
    [-2.7, 0, 1.8], [-2.7, -0.3, 1.8], [-3, -0.3, 1.8], [-3, 0, 1.8],
    [-2.7, 0, 1.575], [-2.7, -0.3, 1.575], [-3, -0.3, 1.35], [-3, 0, 1.35],
    [-2.5, 0, 1.125], [-2.5, -0.3, 1.125], [-2.65, -0.3, 0.9375],
    [-2.65, 0, 0.9375],
    # 61-64: lower-handle tangent row (reconstructed smooth interpolant;
    # the widely-mirrored dataset row here may differ slightly).
    [-2.3, 0, 0.75], [-2.3, -0.3, 0.75], [-2.05, -0.3, 0.6],
    [-2.05, 0, 0.6],
    # 65-67: handle-to-body attach (with cp 28 as the row's y=0 lead).
    [-2, -0.3, 0.9], [-1.9, -0.3, 0.6], [-1.9, 0, 0.6],
    [1.7, 0, 1.425], [1.7, -0.66, 1.425], [1.7, -0.66, 0.6], [1.7, 0, 0.6],
    [2.6, 0, 1.425], [2.6, -0.66, 1.425], [3.1, -0.66, 0.825],
    [3.1, 0, 0.825],
    [2.3, 0, 2.1], [2.3, -0.25, 2.1], [2.4, -0.25, 2.025], [2.4, 0, 2.025],
    [2.7, 0, 2.4], [2.7, -0.25, 2.4], [3.3, -0.25, 2.4], [3.3, 0, 2.4],
    [2.8, 0, 2.475], [2.8, -0.25, 2.475], [3.525, -0.25, 2.49375],
    [3.525, 0, 2.49375],
    [2.9, 0, 2.475], [2.9, -0.15, 2.475], [3.45, -0.15, 2.5125],
    [3.45, 0, 2.5125],
    [2.8, 0, 2.4], [2.8, -0.15, 2.4], [3.2, -0.15, 2.4], [3.2, 0, 2.4],
    [0, 0, 3.15],
    [0.8, 0, 3.15], [0.8, -0.45, 3.15], [0.45, -0.8, 3.15], [0, -0.8, 3.15],
    [0, 0, 2.85],
    [1.4, 0, 2.4], [1.4, -0.784, 2.4], [0.784, -1.4, 2.4], [0, -1.4, 2.4],
    [0.4, 0, 2.55], [0.4, -0.224, 2.55], [0.224, -0.4, 2.55],
    [0, -0.4, 2.55],
    [1.3, 0, 2.55], [1.3, -0.728, 2.55], [0.728, -1.3, 2.55],
    [0, -1.3, 2.55],
    [1.3, 0, 2.4], [1.3, -0.728, 2.4], [0.728, -1.3, 2.4], [0, -1.3, 2.4],
    [0, 0, 0],
    [1.425, -0.798, 0], [1.5, 0, 0.075], [1.425, 0, 0], [0.798, -1.425, 0],
    [0, -1.5, 0.075], [0, -1.425, 0], [1.5, -0.84, 0.075],
    [0.84, -1.5, 0.075],
], np.float64)


def _all_patches():
    """Expand the 10 unique patches + reflections to 32 [4, 4, 3] grids."""
    out = []
    for pi, patch in enumerate(_PATCHES):
        grid = _CP[np.asarray(patch)].reshape(4, 4, 3)
        # Original (p), y-mirror with reversed columns (q) — reversal
        # keeps the surface orientation consistent.
        q = grid[:, ::-1].copy()
        q[..., 1] *= -1.0
        out += [grid, q]
        if pi < 6:
            r = grid[:, ::-1].copy()
            r[..., 0] *= -1.0
            s = grid.copy()
            s[..., 0] *= -1.0
            s[..., 1] *= -1.0
            out += [r, s]
    return out  # 6*4 + 4*2 = 32


def _bernstein(t):
    """[N] -> [N, 4] cubic Bernstein basis."""
    t = np.asarray(t)[:, None]
    mt = 1.0 - t
    return np.concatenate(
        [mt ** 3, 3 * t * mt ** 2, 3 * t ** 2 * mt, t ** 3], axis=1)


def teapot_mesh(resolution: int = 9):
    """Tessellate the teapot.

    resolution: quads per patch edge; triangles = 32 * resolution^2 * 2
    (resolution 9 -> 5184, the ~5k-triangle config-3 asset).

    Returns (positions [V, 3] f32, tris [T, 3] i32, normals [V, 3] f32,
    uvs [V, 2] f32) — y-up, centered at the origin, scaled so the body
    diameter is ~1.
    """
    n = resolution + 1
    t = np.linspace(0.0, 1.0, n)
    bu = _bernstein(t)        # [n, 4]
    positions, uvs, faces = [], [], []
    base = 0
    for grid in _all_patches():
        # S(u, v) = sum_ij Bu_i(u) Bv_j(v) P_ij — two small matmuls.
        pts = np.einsum("ui,ijk,vj->uvk", bu, grid, bu)  # [n, n, 3]
        positions.append(pts.reshape(-1, 3))
        uu, vv = np.meshgrid(t, t, indexing="ij")
        uvs.append(np.stack([uu, vv], axis=-1).reshape(-1, 2))
        idx = base + np.arange(n * n).reshape(n, n)
        a, b = idx[:-1, :-1].ravel(), idx[1:, :-1].ravel()
        c, d = idx[1:, 1:].ravel(), idx[:-1, 1:].ravel()
        faces.append(np.stack([a, b, c], axis=-1))
        faces.append(np.stack([a, c, d], axis=-1))
        base += n * n
    positions = np.concatenate(positions)
    uvs = np.concatenate(uvs)
    tris = np.concatenate(faces).astype(np.int64)

    # Weld by position so normals are smooth across patch seams (patch
    # boundaries repeat vertices; the lid/bottom poles repeat many).
    key = np.round(positions * 1e5).astype(np.int64)
    _, uniq_idx, inv = np.unique(key, axis=0, return_index=True,
                                 return_inverse=True)
    positions_w = positions[uniq_idx]
    uvs_w = uvs[uniq_idx]
    tris_w = inv[tris]
    # Drop triangles degenerate after welding (pole quads).
    keep = ((tris_w[:, 0] != tris_w[:, 1]) & (tris_w[:, 1] != tris_w[:, 2])
            & (tris_w[:, 0] != tris_w[:, 2]))
    tris_w = tris_w[keep]

    # Area-weighted smooth vertex normals.
    e1 = positions_w[tris_w[:, 1]] - positions_w[tris_w[:, 0]]
    e2 = positions_w[tris_w[:, 2]] - positions_w[tris_w[:, 0]]
    fn = np.cross(e1, e2)
    normals = np.zeros_like(positions_w)
    for c in range(3):
        np.add.at(normals, tris_w[:, c], fn)
    norm = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = normals / np.maximum(norm, 1e-12)

    # The patch parameterization is consistently oriented but may face
    # inward as a whole; orient outward (the body is star-shaped about
    # its centroid, so the sign of the mean radial component decides),
    # flipping the winding in lockstep for backface-culling consumers.
    centroid = positions_w.mean(0)
    if np.sum(normals * (positions_w - centroid)) < 0.0:
        normals = -normals
        tris_w = tris_w[:, ::-1]

    # Canonical data is z-up, spout along +x after reflection; rotate to
    # y-up (x, z, -y), center, and scale body diameter ~1.
    positions_w = positions_w[:, [0, 2, 1]] * np.array([1.0, 1.0, -1.0])
    normals = normals[:, [0, 2, 1]] * np.array([1.0, 1.0, -1.0])
    center = (positions_w.max(0) + positions_w.min(0)) / 2.0
    positions_w = (positions_w - center) / 4.0

    return (positions_w.astype(np.float32), tris_w.astype(np.int32),
            normals.astype(np.float32), uvs_w.astype(np.float32))
