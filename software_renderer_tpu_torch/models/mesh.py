"""Mesh: struct-of-arrays geometry container of torch tensors."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import or_default


@dataclasses.dataclass
class Mesh:
    """Indexed triangle mesh.

    positions: [N, 3] float32 model-space positions.
    indices:   [M] int32 flat index list (3 per triangle).
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
