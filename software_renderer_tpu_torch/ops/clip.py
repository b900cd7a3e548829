"""Near-plane handling: the cull threshold and the exact clip.

Counterpart of the JAX package's ops/clip.py. By default a triangle with
any corner at clip-space w <= CLIP_EPS is culled (ops/frontend.py).
``RenderPass(clip_near=True)`` instead clips each triangle against the
plane w = CLIP_EPS in clip space (Sutherland-Hodgman over a fixed table):
one triangle becomes at most two, so the output is a static [2T] array,
slot t the (possibly clipped) triangle and slot T + t the second half of
a clipped quad. Each new corner carries its barycentric weights over the
source triangle's corners, so attributes interpolate through the cut.

The numpy oracle (the JAX package's testing/oracle.py
``oracle_clip_near``) walks the same polygon, so clipped coverage can be
compared exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import constant
from .vertex import clip_coords

# Corners at clip-space w <= CLIP_EPS cull their triangle. The value is
# the float32 rounding of 1e-6, the same constant the JAX package uses.
CLIP_EPS = float(np.float32(1e-6))

# Output quad per behind-mask case (b0 + 2 b1 + 4 b2). Candidate corners:
# 0-2 the source corners, 3 the cut of edge (0, 1), 4 of edge (1, 2), 5
# of edge (2, 0). A three-corner output repeats its last corner, which
# makes its second triangle degenerate.
_QUAD_LUT = [
    [0, 1, 2, 2],  # 0: none behind   -> the source triangle
    [5, 3, 1, 2],  # 1: v0 behind     -> quad
    [0, 3, 4, 2],  # 2: v1 behind     -> quad
    [5, 4, 2, 2],  # 3: v0, v1 behind -> one triangle
    [5, 0, 1, 4],  # 4: v2 behind     -> quad
    [3, 1, 4, 4],  # 5: v0, v2 behind -> one triangle
    [5, 0, 3, 3],  # 6: v1, v2 behind -> one triangle
    [0, 0, 0, 0],  # 7: all behind    -> culled
]
_TRI2_VALID = [False, True, True, False, True, False, False, False]


def transform_corners_clip(corners, transform) -> torch.Tensor:
    """[T, 3, 3] model-space corners -> [T, 3, 4] clip space, with the
    planar front-end's multiply-add chains, so that a triangle wholly in
    front (case 0) gives the unclipped path's values bit for bit."""
    return clip_coords(corners, transform)


def cull_behind_mask(clip, eps: float = CLIP_EPS) -> torch.Tensor:
    """[T] bool: every corner's w > eps (the default near-plane guard)."""
    return (clip[:, :, 3] > eps).all(dim=1)


def clip_near(clip, eps: float = CLIP_EPS):
    """Clip [T, 3, 4] clip-space triangles against w = eps.

    Returns (out_clip [2T, 3, 4] corners, bary [2T, 3, 3] weights of each
    output corner over its source triangle's corners, valid [2T] bool).
    """
    t = clip.shape[0]
    dev = clip.device
    w = clip[:, :, 3]
    behind = (w < eps).to(torch.int64)
    case = behind[:, 0] + 2 * behind[:, 1] + 4 * behind[:, 2]

    def intersect(a, b):
        # s on edge (a, b): s = (eps - w_a) / (w_b - w_a);
        # P = P_a + s (P_b - P_a). Computed for every triangle; the table
        # selects the cuts a case uses.
        den = w[:, b] - w[:, a]
        s = (eps - w[:, a]) / torch.where(torch.abs(den) > 0.0, den, 1.0)
        p = clip[:, a] + s[:, None] * (clip[:, b] - clip[:, a])
        e = torch.zeros((t, 3), dtype=torch.float32, device=dev)
        e[:, a] = 1.0 - s
        e[:, b] = s
        return p, e

    cuts = [intersect(0, 1), intersect(1, 2), intersect(2, 0)]
    cand_p = torch.stack([clip[:, 0], clip[:, 1], clip[:, 2]]
                         + [p for p, _ in cuts], dim=1)        # [T, 6, 4]
    eye = torch.eye(3, dtype=torch.float32, device=dev).expand(t, 3, 3)
    cand_b = torch.cat([eye, torch.stack([e for _, e in cuts], dim=1)],
                       dim=1)                                  # [T, 6, 3]
    sel = constant(_QUAD_LUT, dev, torch.int64)[case]         # [T, 4]
    quad_p = torch.gather(cand_p, 1, sel[:, :, None].expand(-1, -1, 4))
    quad_b = torch.gather(cand_b, 1, sel[:, :, None].expand(-1, -1, 3))
    # The two triangles of the quad: corners (0, 1, 2) and (0, 2, 3).
    second = constant((0, 2, 3), dev, torch.int64)
    out_clip = torch.cat([quad_p[:, :3], quad_p[:, second]])
    bary = torch.cat([quad_b[:, :3], quad_b[:, second]])
    valid = torch.cat([case != 7,
                       constant(_TRI2_VALID, dev, torch.bool)[case]])
    return out_clip, bary, valid


def compose_attrs(bary, attrs) -> torch.Tensor:
    """Per-corner attributes through the clip: bary [2T, 3, 3] from
    :func:`clip_near`, attrs [T, 3, A] at the source corners -> [2T, 3, A],
    ``out[t, i] = sum_j bary[t, i, j] * attrs[t mod T, j]``."""
    a2 = torch.cat([attrs, attrs])
    return (bary[:, :, 0:1] * a2[:, None, 0] + bary[:, :, 1:2] * a2[:, None, 1]
            + bary[:, :, 2:3] * a2[:, None, 2])
