"""2D drawing on an [H, W, 4] image: rect, circle, line, triangle.

Counterpart of the JAX package's ops/primitives2d.py (the reference's
direct-to-framebuffer 2D rasterizers): each primitive is a mask or field
over the frame's pixel centres, a line the DDA scatter of ops/lines.py.
As in JAX, ``draw_rect`` fills w x h (the reference swaps its loop
bounds), ``draw_circle`` honours its color with the reference's
smoothstep(r + 2, r - 2) rim, and ``draw_triangle2d`` interpolates three
corner colors (the RGB basis by default). Every image op follows the
device of ``img`` and rounds as on the CPU (ops/rounding.py), so the card
draws the CPU's pixels.
"""

from __future__ import annotations

import torch

from . import rounding
from .lines import draw_lines as _draw_lines_screen


def _pixel_grid(img):
    h, w = img.shape[0], img.shape[1]
    ys = torch.arange(h, dtype=torch.float32, device=img.device)[:, None] \
        + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=img.device)[None, :] \
        + 0.5
    return xs, ys


def _rgba(color, dtype, device):
    c = torch.as_tensor(color, dtype=dtype, device=device)
    if c.shape[-1] == 3:
        c = torch.cat([c, torch.ones_like(c[..., :1])], dim=-1)
    return c


def _blend(img, mask, rgba):
    """mask [H, W] in [0, 1]; rgba broadcastable to [H, W, 4]."""
    m = mask[..., None]
    return img * (1.0 - m) + rgba * m


def draw_rect(img, x, y, w, h, color):
    """Filled axis-aligned rect of w x h from (x, y). color: [3] or [4]."""
    xs, ys = _pixel_grid(img)
    mask = ((xs >= x) & (xs < x + w) & (ys >= y) & (ys < y + h)
            ).to(img.dtype)
    return _blend(img, mask, _rgba(color, img.dtype, img.device))


def draw_circle(img, cx, cy, r, color):
    """Filled circle: opaque inside r - 2, smoothstep falloff to r + 2."""
    xs, ys = _pixel_grid(img)
    dx = xs - cx
    dy = ys - cy
    d = rounding.sqrt(dx * dx + dy * dy)
    t = torch.clamp(rounding.divide(d - (r + 2.0), (r - 2.0) - (r + 2.0)),
                    0.0, 1.0)
    cov = t * t * (3.0 - 2.0 * t)
    return _blend(img, cov.to(img.dtype),
                  _rgba(color, img.dtype, img.device))


def draw_line(img, x0, y0, x1, y1, color):
    """DDA line from (x0, y0) to (x1, y1) in one color."""
    screen = torch.tensor([[x0, y0, 0.0], [x1, y1, 0.0]],
                          dtype=torch.float32, device=img.device)
    lines = torch.tensor([[0, 1]], dtype=torch.int32, device=img.device)
    colors = _rgba(color, torch.float32, img.device).expand(2, 4)
    return _draw_lines_screen(img, screen, lines, colors)


def draw_triangle2d(img, a, b, c, colors=((1, 0, 0), (0, 1, 0), (0, 0, 1))):
    """Filled 2D triangle with barycentric-interpolated corner colors,
    inside test and weights at pixel centres as in the 3D path."""
    xs, ys = _pixel_grid(img)
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=img.device)
    ax, ay = f(a[0]), f(a[1])
    bx, by = f(b[0]), f(b[1])
    cx, cy = f(c[0]), f(c[1])
    d = (ax - cx) * (by - cy) - (bx - cx) * (ay - cy)
    s = torch.where(d < 0, -1.0, 1.0)
    e0 = ((by - cy) * (xs - cx) + (cx - bx) * (ys - cy)) * s
    e1 = ((cy - ay) * (xs - cx) + (ax - cx) * (ys - cy)) * s
    e2 = torch.abs(d) - e0 - e1
    inside = (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (d != 0)
    inv = torch.where(d == 0, 0.0,
                      1.0 / torch.abs(torch.where(d == 0, 1.0, d)))
    w0, w1, w2 = e0 * inv, e1 * inv, e2 * inv
    cols = f(colors)
    rgb = (w0[..., None] * cols[0] + w1[..., None] * cols[1]
           + w2[..., None] * cols[2])
    rgba = torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)
    return torch.where(inside[..., None], rgba.to(img.dtype), img)
