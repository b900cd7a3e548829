"""Triangle setup records and their coverage-safety certificate.

Edge functions built from integer-rounded pixel coordinates are exact in
float32 while every product stays below 2^24; a sliver with vertices far
off screen can break that premise and let rounded edge constants cover
pixels outside the triangle's bbox. ``coverage_safe`` certifies per
triangle that this cannot happen; uncertified triangles go to the
bbox-clamping overflow kernels (ops/binning.py).

``TriangleSetup`` is the array layout of the same per-triangle data that
the planar front-end keeps as columns; ops/frontend.py ``to_setup`` and
``from_setup`` re-pack one into the other, so every backend shares one
front-end's coverage decisions. :func:`setup_columns` is the setup math
of both front-ends: the planar one (ops/frontend.py, after its vertex
transform) and :func:`triangle_setup_from_corners`, which the near-plane
clip path (ops/clip.py) runs on its [2T] corners.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class TriangleSetup:
    """Per-triangle rasterization data (leading dim [T]).

    Edge j is ``coef[t, 0, j] * x + coef[t, 1, j] * y + coef[t, 2, j]``
    (sign-folded: inside when every edge is >= 0); depth is
    ``zplane[t, 0] * x + zplane[t, 1] * y + zplane[t, 2]``.
    """

    coef: torch.Tensor       # [T, 3, 3] float32
    zplane: torch.Tensor     # [T, 3] float32
    inv_area: torch.Tensor   # [T] float32, 1/|D| (0 where invalid)
    bbox: torch.Tensor       # [T, 4] int32 x0 y0 x1 y1, inclusive, clamped
    valid: torch.Tensor      # [T] bool
    area2: torch.Tensor      # [T] float32, signed 2*area D
    safe: torch.Tensor       # [T] bool, :func:`coverage_safe` or invalid

    @property
    def num_triangles(self) -> int:
        return self.coef.shape[0]

# See the JAX package's ops/setup.py for the derivation of each bound.
EXACT_LIMIT = 2.0 ** 21
ERR_SCALE = 2.0 ** -20
SAFE_MARGIN = 0.25


def coverage_safe(x1, y1, x2, y2, x3, y3, a0, b0, a1, b1, abs_d,
                  width, height):
    """Per-triangle certificate: float32 coverage provably inside the bbox.

    All args are [T] float32 columns of rounded screen coordinates and
    sign-folded edge gradients. Returns [T] bool (False for non-finite
    inputs: every comparison with NaN is False).
    """
    tiny = 1e-30
    ax = torch.clamp(torch.abs(x3), min=float(width)) + 1.0
    ay = torch.clamp(torch.abs(y3), min=float(height)) + 1.0
    m0 = torch.abs(a0) * ax + torch.abs(b0) * ay
    m1 = torch.abs(a1) * ax + torch.abs(b1) * ay
    md = (torch.abs(x1 - x3) * torch.abs(y2 - y3)
          + torch.abs(x2 - x3) * torch.abs(y1 - y3))
    exact = (m0 + m1 + md) < EXACT_LIMIT
    err0 = torch.where(exact, 0.0, m0 * ERR_SCALE)
    err1 = torch.where(exact, 0.0, m1 * ERR_SCALE)
    err2 = err0 + err1 + torch.where(exact, 0.0, md * ERR_SCALE)
    a2 = a0 + a1  # |a2|: the sign-folded -(a0 + a1) has the same magnitude
    b2 = b0 + b1
    g0u = torch.abs(a0) + torch.abs(b0)
    g1u = torch.abs(a1) + torch.abs(b1)
    g2u = torch.abs(a2) + torch.abs(b2)
    g0l = torch.clamp(torch.maximum(torch.abs(a0), torch.abs(b0)), min=tiny)
    g1l = torch.clamp(torch.maximum(torch.abs(a1), torch.abs(b1)), min=tiny)
    g2l = torch.clamp(torch.maximum(torch.abs(a2), torch.abs(b2)), min=tiny)
    e_shift = torch.maximum(torch.maximum(err0 / g0l, err1 / g1l),
                            err2 / g2l)
    dd = torch.clamp(abs_d, min=tiny)
    v_shift = torch.maximum(
        torch.maximum(err0 * g1u + err1 * g0u, err0 * g2u + err2 * g0u),
        err1 * g2u + err2 * g1u) / dd
    return (e_shift <= SAFE_MARGIN) & (v_shift <= SAFE_MARGIN)


def setup_columns(xs, ys, zs, width: int, height: int, *,
                  cull_backfaces: bool = False, front_face_ccw: bool = True,
                  extra_valid=None):
    """Per-triangle setup from screen-space corner columns.

    xs, ys, zs: three [T] float32 columns each (rounded pixel x, pixel y,
    NDC z of corners 1-3); extra_valid: optional [T] bool ANDed into
    validity. Returns (a0, a1, a2, b0, b1, b2, c0, c1, c2, zx, zy, zc,
    abs_d, inv_area, area2, bx0, by0, bx1, by1, valid, safe): |D| and
    1/|D| are 0 where invalid, the bbox columns exact-integer floats,
    valid and safe bools. Invalid triangles get e = (-1, -1, -1) through
    the constant columns and the depth plane (0, 0, +inf), set by
    ``where`` (a multiply by the mask would keep NaN corners' NaN).
    """
    x1, x2, x3 = xs
    y1, y2, y3 = ys
    z1, z2, z3 = zs
    wf, hf = float(width), float(height)
    d = (x1 - x3) * (y2 - y3) - (x2 - x3) * (y1 - y3)
    finite = torch.ones_like(d, dtype=torch.bool)
    for col in (x1, y1, z1, x2, y2, z2, x3, y3, z3):
        finite = finite & torch.isfinite(col)
    degenerate = ~finite | (d == 0.0)
    s = torch.where(d < 0.0, -1.0, 1.0)
    abs_d = torch.abs(d)
    inv_area = torch.where(degenerate, 0.0,
                           1.0 / torch.where(degenerate, 1.0, abs_d))
    a0 = (y2 - y3) * s
    b0 = (x3 - x2) * s
    a1 = (y3 - y1) * s
    b1 = (x1 - x3) * s
    c0 = -(a0 * x3 + b0 * y3)
    c1 = -(a1 * x3 + b1 * y3)
    a2 = -(a0 + a1)
    b2 = -(b0 + b1)
    c2 = abs_d - c0 - c1
    zx = (a0 * z1 + a1 * z2 + a2 * z3) * inv_area
    zy = (b0 * z1 + b1 * z2 + b2 * z3) * inv_area
    zc = (c0 * z1 + c1 * z2 + c2 * z3) * inv_area

    min_x = torch.minimum(torch.minimum(x1, x2), x3)
    max_x = torch.maximum(torch.maximum(x1, x2), x3)
    min_y = torch.minimum(torch.minimum(y1, y2), y3)
    max_y = torch.maximum(torch.maximum(y1, y2), y3)
    offscreen = (max_x < 0.0) | (min_x > wf) | (max_y < 0.0) | (min_y > hf)
    clean = lambda a: torch.where(torch.isfinite(a), a, 0.0)
    bx0 = torch.clamp(clean(torch.floor(min_x)), 0, width - 1)
    by0 = torch.clamp(clean(torch.floor(min_y)), 0, height - 1)
    bx1 = torch.clamp(clean(torch.ceil(max_x)), 0, width - 1)
    by1 = torch.clamp(clean(torch.ceil(max_y)), 0, height - 1)

    valid = ~degenerate & ~offscreen
    if extra_valid is not None:
        valid = valid & extra_valid
    if cull_backfaces:
        valid = valid & ((d > 0.0) if front_face_ccw else (d < 0.0))

    keep = lambda v, fill: torch.where(valid, v, fill)
    a0, a1, a2, b0, b1, b2 = (keep(v, 0.0) for v in (a0, a1, a2, b0, b1, b2))
    c0, c1, c2 = (keep(v, -1.0) for v in (c0, c1, c2))
    safe = coverage_safe(x1, y1, x2, y2, x3, y3, a0, b0, a1, b1, abs_d,
                         width, height) | ~valid
    return (a0, a1, a2, b0, b1, b2, c0, c1, c2, keep(zx, 0.0), keep(zy, 0.0),
            keep(zc, float("inf")), keep(abs_d, 0.0), keep(inv_area, 0.0), d,
            bx0, by0, bx1, by1, valid, safe)


def triangle_setup_from_corners(v, width: int, height: int, *,
                                cull_backfaces: bool = False,
                                front_face_ccw: bool = True,
                                extra_valid=None) -> TriangleSetup:
    """[T, 3, 3] screen-space corners (pixel x, pixel y, NDC z) ->
    TriangleSetup (:func:`setup_columns`); extra_valid: optional [T]
    bool (the near-plane clip's mask) ANDed into validity."""
    col = lambda c, k: v[:, c, k]
    (a0, a1, a2, b0, b1, b2, c0, c1, c2, zx, zy, zc, _, inv_area, d,
     bx0, by0, bx1, by1, valid, safe) = setup_columns(
        [col(c, 0) for c in range(3)], [col(c, 1) for c in range(3)],
        [col(c, 2) for c in range(3)], width, height,
        cull_backfaces=cull_backfaces, front_face_ccw=front_face_ccw,
        extra_valid=extra_valid)
    row = lambda *cols: torch.stack(cols, dim=-1)
    return TriangleSetup(
        coef=torch.stack([row(a0, a1, a2), row(b0, b1, b2), row(c0, c1, c2)],
                         dim=-2),
        zplane=row(zx, zy, zc), inv_area=inv_area,
        bbox=row(bx0, by0, bx1, by1).to(torch.int32), valid=valid, area2=d,
        safe=safe)


def triangle_setup(screen, tris, width: int, height: int, *,
                   cull_backfaces: bool = False,
                   front_face_ccw: bool = True) -> TriangleSetup:
    """:func:`triangle_setup_from_corners` of indexed vertices: screen
    [N, 3], tris [T, 3] int indices."""
    return triangle_setup_from_corners(
        screen[tris.long()], width, height, cull_backfaces=cull_backfaces,
        front_face_ccw=front_face_ccw)
