"""Mesh: struct-of-arrays geometry container of torch tensors, and the
mesh helpers (merge, bake a transform)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import or_default


@dataclasses.dataclass
class Mesh:
    """Indexed triangle, line or point mesh.

    positions: [N, 3] float32 model-space positions.
    indices:   [M] int32 flat index list, read per primitive (3 per
               triangle, 2 per line, 1 per point).
    colors / normals / uvs: optional per-vertex attributes ([N, 3] /
    [N, 3] / [N, 2] float32).
    """

    positions: torch.Tensor
    indices: torch.Tensor
    colors: Optional[torch.Tensor] = None
    normals: Optional[torch.Tensor] = None
    uvs: Optional[torch.Tensor] = None

    @property
    def num_vertices(self) -> int:
        return self.positions.shape[0]

    def triangles(self) -> torch.Tensor:
        """[T, 3] triangle index array."""
        m = self.indices.shape[0]
        if m % 3:
            raise ValueError("triangle index count must be a multiple of 3")
        return self.indices.reshape(m // 3, 3)

    def lines(self) -> torch.Tensor:
        """[L, 2] line index array."""
        m = self.indices.shape[0]
        if m % 2:
            raise ValueError("line index count must be a multiple of 2")
        return self.indices.reshape(m // 2, 2)

    def to(self, device) -> "Mesh":
        move = lambda a: None if a is None else a.to(device)
        return Mesh(*(move(getattr(self, f.name))
                      for f in dataclasses.fields(self)))


def mesh_from_numpy(positions, indices, colors=None, normals=None,
                    uvs=None, device=None) -> Mesh:
    """Build a Mesh from array-likes (float attributes cast to float32,
    indices to int32, the same casts the JAX package makes), on the card
    unless ``device`` says otherwise (device.py)."""
    device = or_default(device)
    f32 = lambda a: None if a is None else torch.from_numpy(
        np.ascontiguousarray(np.asarray(a).astype(np.float32))).to(device)
    return Mesh(
        positions=f32(positions),
        indices=torch.from_numpy(np.ascontiguousarray(
            np.asarray(indices).astype(np.int32).reshape(-1))).to(device),
        colors=f32(colors), normals=f32(normals), uvs=f32(uvs))


def merge_meshes(meshes) -> Mesh:
    """Concatenate meshes into one draw (index offsets applied), on the
    first mesh's device. An attribute present in any input is filled in
    the rest (colors 1, normals +z, uvs 0)."""
    dev = meshes[0].positions.device
    any_of = {f: any(getattr(m, f) is not None for m in meshes)
              for f in ("colors", "normals", "uvs")}
    fill = {"colors": lambda n: torch.ones((n, 3), device=dev),
            "normals": lambda n: torch.tensor(
                [[0.0, 0.0, 1.0]], device=dev).repeat(n, 1),
            "uvs": lambda n: torch.zeros((n, 2), device=dev)}
    parts = {f: [] for f in ("positions", "indices", "colors", "normals",
                             "uvs")}
    offset = 0
    for m in meshes:
        n = m.num_vertices
        parts["positions"].append(m.positions.to(dev))
        parts["indices"].append(m.indices.to(dev) + offset)
        for f, present in any_of.items():
            if present:
                a = getattr(m, f)
                parts[f].append(fill[f](n) if a is None else a.to(dev))
        offset += n
    cat = lambda xs: torch.cat(xs, dim=0) if xs else None
    return Mesh(**{f: cat(xs) for f, xs in parts.items()})


def transform_mesh(mesh: Mesh, matrix) -> Mesh:
    """Bake a 4x4 transform into the positions and rotate the normals by
    its normal matrix (renormalized). Each coordinate is one multiply-add
    chain, rounded per operation, so no matrix unit (TF32) is involved."""
    from ..ops.transforms import inverse_transpose_3x3
    m = torch.as_tensor(matrix, dtype=torch.float32,
                        device=mesh.positions.device)
    p = mesh.positions
    pos = torch.stack([p[:, 0] * m[i, 0] + p[:, 1] * m[i, 1]
                       + p[:, 2] * m[i, 2] + m[i, 3] for i in range(3)],
                      dim=-1)
    normals = mesh.normals
    if normals is not None:
        # n' = n @ inverse_transpose(rot).T
        it = inverse_transpose_3x3(m[:3, :3])
        n = normals
        normals = torch.stack([n[:, 0] * it[i, 0] + n[:, 1] * it[i, 1]
                               + n[:, 2] * it[i, 2] for i in range(3)],
                              dim=-1)
        norm = torch.linalg.vector_norm(normals, dim=-1, keepdim=True)
        normals = normals / torch.clamp(norm, min=1e-12)
    return dataclasses.replace(mesh, positions=pos, normals=normals)
