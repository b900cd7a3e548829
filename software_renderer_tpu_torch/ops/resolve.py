"""Deferred resolve: visibility buffer -> interpolated attributes.

Counterpart of the JAX package's ops/resolve.py (plain XLA there, plain
torch here). The visibility pass leaves each pixel's depth and winning
triangle id; this stage computes the winner's screen-space barycentric
weights once per pixel and interpolates per-corner attributes with them
(screen-space linear, as the reference interpolates), or with the
perspective-correct weights of :func:`perspective_correct_weights`.
Sums are explicit multiply-adds in a fixed order.
"""

from __future__ import annotations

import torch

from ..framebuffer import NO_TRIANGLE
from .rasterize_ref import pixel_centers
from .setup import TriangleSetup


def barycentrics_at_pixels(setup: TriangleSetup, tri_id, y_start: int = 0):
    """Per-pixel barycentric weights of the winning triangle.

    tri_id: [H, W] int32 (NO_TRIANGLE where uncovered). Returns (ws
    [H, W, 3] float32, meaningless where uncovered; covered [H, W] bool).
    """
    h, w = tri_id.shape
    covered = tri_id != NO_TRIANGLE
    tid = torch.where(covered, tri_id, 0).long()
    coef = setup.coef[tid]                         # [H, W, 3, 3]
    xs, ys = pixel_centers(w, h, y_start, tri_id.device)
    e = (xs[..., None] * coef[..., 0, :] + ys[..., None] * coef[..., 1, :]
         + coef[..., 2, :])                        # [H, W, 3]
    return e * setup.inv_area[tid][..., None], covered


def perspective_correct_weights(ws, w_tri, tri_id, covered):
    """Screen-space weights -> perspective-correct ones:
    ``ws'_i = (ws_i / w_i) / sum_j (ws_j / w_j)``, with w_tri [T, 3] the
    clip-space w of each triangle's corners (a 0 taken as 1)."""
    tid = torch.where(covered, tri_id, 0).long()
    wv = w_tri[tid]                                # [H, W, 3]
    wr = ws / torch.where(wv == 0.0, 1.0, wv)
    denom = wr[..., 0:1] + wr[..., 1:2] + wr[..., 2:3]
    return wr / torch.where(denom == 0.0, 1.0, denom)


def interpolate_attribute(attr_tri, tri_id, ws, covered, fill: float = 0.0):
    """Interpolate per-corner values over the frame.

    attr_tri: [T, 3, K] values at each triangle's corners; tri_id: [H, W]
    int32; ws: [H, W, 3] weights; covered: [H, W] bool. Returns [H, W, K]
    float32, ``fill`` where uncovered.
    """
    tid = torch.where(covered, tri_id, 0).long()
    vals = attr_tri[tid]                           # [H, W, 3, K]
    out = (ws[..., 0:1] * vals[..., 0, :] + ws[..., 1:2] * vals[..., 1, :]
           + ws[..., 2:3] * vals[..., 2, :])
    return torch.where(covered[..., None], out, fill)
