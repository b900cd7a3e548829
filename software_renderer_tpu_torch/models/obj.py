"""Wavefront OBJ reading into a :class:`Mesh` (config 3's teapot) and
writing (``save_obj``).

The JAX package's models/obj.py, in plain Python and numpy: faces are
fan-triangulated, each resolved (v, vt, vn) index triple becomes one
vertex, normals are computed when the file has none, and vertex colors
default to abs(normal). The same file gives the same arrays in both
packages.
"""

from __future__ import annotations

import numpy as np

from ..device import or_default
from .mesh import Mesh, mesh_from_numpy


def load_obj(path: str, abs_normal_colors: bool = True,
             device=None) -> Mesh:
    """Read a Wavefront OBJ file into a Mesh on ``device`` (the card
    unless the caller passes ``device="cpu"``)."""
    device = or_default(device)
    positions, uvs, normals = [], [], []
    out_pos, out_uv, out_nrm, tri_indices = [], [], [], []
    dedup: dict[tuple, int] = {}

    def resolve(token: str, n: int):
        i = int(token)
        return i - 1 if i > 0 else n + i

    def vertex_for(token: str) -> int:
        parts = token.split("/")
        vi = resolve(parts[0], len(positions))
        ti = resolve(parts[1], len(uvs)) if len(parts) > 1 and parts[1] \
            else None
        ni = resolve(parts[2], len(normals)) if len(parts) > 2 and parts[2] \
            else None
        # Relative (negative) indices resolve against the records read so
        # far, so the dedup key is the resolved triple, not the token.
        key = (vi, ti, ni)
        if key in dedup:
            return dedup[key]
        if not 0 <= vi < len(positions):
            raise IndexError(f"OBJ face index {parts[0]!r} out of range "
                             f"({len(positions)} vertices so far)")
        if ti is not None and not 0 <= ti < len(uvs):
            raise IndexError(f"OBJ uv index {parts[1]!r} out of range")
        if ni is not None and not 0 <= ni < len(normals):
            raise IndexError(f"OBJ normal index {parts[2]!r} out of range")
        dedup[key] = len(out_pos)
        out_pos.append(positions[vi])
        out_uv.append(uvs[ti] if ti is not None else (0.0, 0.0))
        out_nrm.append(normals[ni] if ni is not None else (0.0, 0.0, 0.0))
        return dedup[key]

    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tag, *rest = line.split()
            if tag == "v":
                positions.append(tuple(float(x) for x in rest[:3]))
            elif tag == "vt":
                uvs.append((float(rest[0]),
                            float(rest[1]) if len(rest) > 1 else 0.0))
            elif tag == "vn":
                normals.append(tuple(float(x) for x in rest[:3]))
            elif tag == "f":
                ids = [vertex_for(tok) for tok in rest]
                for k in range(1, len(ids) - 1):  # fan triangulation
                    tri_indices += [ids[0], ids[k], ids[k + 1]]

    if not tri_indices:
        raise ValueError(f"{path!r} contains no OBJ face data "
                         f"({len(positions)} vertices, 0 faces)")
    pos = np.asarray(out_pos, np.float32)
    tris = np.asarray(tri_indices, np.int64)
    nrm = np.asarray(out_nrm, np.float32)
    if not normals or not np.any(nrm):
        nrm = compute_vertex_normals(pos, tris.reshape(-1, 3))
    colors = np.abs(nrm) if abs_normal_colors else np.ones_like(pos)
    return mesh_from_numpy(pos, tris, colors=colors, normals=nrm,
                           uvs=np.asarray(out_uv, np.float32), device=device)


def compute_vertex_normals(positions: np.ndarray,
                           tris: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (for OBJ files without vn records)."""
    v0, v1, v2 = (positions[tris[:, c]] for c in range(3))
    fn = np.cross(v1 - v0, v2 - v0)
    normals = np.zeros_like(positions)
    for c in range(3):
        np.add.at(normals, tris[:, c], fn)
    lens = np.linalg.norm(normals, axis=-1, keepdims=True)
    return (normals / np.maximum(lens, 1e-12)).astype(np.float32)


def save_obj(path: str, mesh: Mesh) -> None:
    """Minimal OBJ export: the JAX package's text for the same mesh
    (positions, uvs and normals as numpy float32, faces 1-based)."""
    f32 = lambda t: t.detach().cpu().numpy()
    pos = f32(mesh.positions)
    tris = mesh.indices.detach().cpu().numpy().reshape(-1, 3) + 1
    has_t = mesh.uvs is not None
    has_n = mesh.normals is not None
    with open(path, "w") as f:
        for p in pos:
            f.write(f"v {p[0]} {p[1]} {p[2]}\n")
        if has_t:
            for t in f32(mesh.uvs):
                f.write(f"vt {t[0]} {t[1]}\n")
        if has_n:
            for n in f32(mesh.normals):
                f.write(f"vn {n[0]} {n[1]} {n[2]}\n")
        for a, b, c in tris:
            if has_t and has_n:
                f.write(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}\n")
            elif has_n:
                f.write(f"f {a}//{a} {b}//{b} {c}//{c}\n")
            else:
                f.write(f"f {a} {b} {c}\n")
