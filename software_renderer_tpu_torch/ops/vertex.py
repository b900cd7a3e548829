"""Vertex stage: MVP transform, perspective divide, NDC -> pixel.

Counterpart of the JAX package's ops/vertex.py. Pixel coordinates round
half away from zero, like the reference's ``.toNearestOrAwayFromZero``.
``torch.round`` rounds half to even, and CUDA's ``roundf`` differs from
this formula at inputs such as 0.49999997 (where ``|x| + 0.5`` rounds up
to 1), so the formula is kept exactly as the JAX package writes it.

The transform is four multiply-add chains per vertex,
``m[i,0]*x + m[i,1]*y + m[i,2]*z + m[i,3]``, rounded per operation: the
association of the planar front-end (ops/frontend.py) and the clip
front-end (ops/clip.py), full float32 on any device (a matrix product on
the card could run in TF32).
"""

from __future__ import annotations

import torch

from ..device import constant


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """``sign(x) * floor(|x| + 0.5)``."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def clip_coords(points, transform) -> torch.Tensor:
    """[..., 3] points -> [..., 4] clip-space coordinates (no divide)."""
    m = transform.to(torch.float32)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    return torch.stack([m[i, 0] * x + m[i, 1] * y + m[i, 2] * z + m[i, 3]
                        for i in range(4)], dim=-1)


def transform_vertices(positions, transform):
    """[N, 3] positions and a [4, 4] transform -> (ndc [N, 3] = xyz / w,
    w [N] clip-space w)."""
    clip = clip_coords(positions, transform)
    w = clip[:, 3]
    return clip[:, :3] / w[:, None], w


def ndc_to_screen(ndc, width: int, height: int) -> torch.Tensor:
    """[N, 3] NDC -> [N, 3] (rounded pixel x, rounded pixel y, NDC z)."""
    f = lambda v: constant(v, ndc.device)
    uv = ndc[:, :2] * f([0.5, -0.5]) + 0.5
    pix = round_half_away(uv * f([float(width), float(height)]))
    return torch.cat([pix, ndc[:, 2:3]], dim=-1)


def vertex_stage(positions, transform, width: int, height: int):
    """Model space -> screen space: (screen [N, 3], w [N])."""
    ndc, w = transform_vertices(positions, transform)
    return ndc_to_screen(ndc, width, height), w


def corner_stage(corners, transform, width: int, height: int):
    """:func:`vertex_stage` over per-triangle corners [T, 3, 3]: (screen
    [T, 3, 3], w [T, 3])."""
    t = corners.shape[0]
    screen, w = vertex_stage(corners.reshape(t * 3, 3), transform, width,
                             height)
    return screen.reshape(t, 3, 3), w.reshape(t, 3)
