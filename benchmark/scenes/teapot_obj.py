"""Config 3's scene: the Utah teapot of ``assets/teapot.obj`` (5,112
triangles), read by a frozen numpy copy of the program's
``models/obj.py`` ``load_obj``: faces fan-triangulated, each resolved
(v, vt, vn) index triple one vertex in the order first met, uv (0, 0)
and normal (0, 0, 0) where a corner has none, area-weighted normals
where the file gives none, and abs(normal) colours. The file is read
from the checkout's root; the scene does not depend on the seed."""

from pathlib import Path

import numpy as np

from benchlib import scene as sc

KEYS = {"generator", "obj"}
ROOT = Path(__file__).resolve().parents[2]


def read_obj(path) -> sc.SceneArrays:
    """The arrays the program's ``load_obj`` gives for ``path``."""
    positions, uvs, normals = [], [], []
    out_pos, out_uv, out_nrm, tris = [], [], [], []
    seen: dict = {}

    def resolve(token, n):
        i = int(token)
        return i - 1 if i > 0 else n + i

    def vertex(token):
        parts = token.split("/")
        vi = resolve(parts[0], len(positions))
        ti = (resolve(parts[1], len(uvs))
              if len(parts) > 1 and parts[1] else None)
        ni = (resolve(parts[2], len(normals))
              if len(parts) > 2 and parts[2] else None)
        key = (vi, ti, ni)
        if key not in seen:
            if not 0 <= vi < len(positions):
                raise IndexError(f"OBJ face index {parts[0]!r} out of range")
            seen[key] = len(out_pos)
            out_pos.append(positions[vi])
            out_uv.append(uvs[ti] if ti is not None else (0.0, 0.0))
            out_nrm.append(normals[ni] if ni is not None
                           else (0.0, 0.0, 0.0))
        return seen[key]

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
                ids = [vertex(tok) for tok in rest]
                for k in range(1, len(ids) - 1):
                    tris += [ids[0], ids[k], ids[k + 1]]
    if not tris:
        raise ValueError(f"{path} holds no OBJ faces")
    pos = np.asarray(out_pos, np.float32)
    nrm = np.asarray(out_nrm, np.float32)
    idx = np.asarray(tris, np.int32)
    if not normals or not np.any(nrm):
        nrm = vertex_normals(pos, idx.reshape(-1, 3))
    return sc.SceneArrays(positions=pos, indices=idx,
                          colors=np.abs(nrm).astype(np.float32),
                          normals=nrm,
                          uvs=np.asarray(out_uv, np.float32))


def vertex_normals(pos, tris):
    """Area-weighted vertex normals, as ``compute_vertex_normals``."""
    v0, v1, v2 = (pos[tris[:, c]] for c in range(3))
    fn = np.cross(v1 - v0, v2 - v0)
    n = np.zeros_like(pos)
    for c in range(3):
        np.add.at(n, tris[:, c], fn)
    lens = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.maximum(lens, 1e-12)).astype(np.float32)


def make(params: dict, seed: int) -> sc.SceneArrays:
    return read_obj(ROOT / params["obj"])
