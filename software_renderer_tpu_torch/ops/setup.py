"""Triangle setup records and their coverage-safety certificate.

Edge functions built from integer-rounded pixel coordinates are exact in
float32 while every product stays below 2^24; a sliver with vertices far
off screen can break that premise and let rounded edge constants cover
pixels outside the triangle's bbox. ``coverage_safe`` certifies per
triangle that this cannot happen; uncertified triangles go to the
bbox-clamping overflow kernels (ops/binning.py).

``TriangleSetup`` is the array layout of the same per-triangle data that
the planar front-end keeps as columns; ops/frontend.py ``to_setup``
re-packs one into the other, so every backend shares one front-end's
coverage decisions. The JAX package's ``triangle_setup*`` functions serve
the near-plane clip path and wait for it (ROADMAP.md Queue 1 item 2).
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
