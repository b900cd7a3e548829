"""Line and point rasterization: the ``line``, ``point`` and ``vertices``
primitives.

Counterpart of the JAX package's ops/lines.py. Points plot each
transformed vertex at its truncated pixel; lines are batched DDA: every
line emits S = max(W, H) samples (masked past its own length) and one
scatter writes the frame. Later samples overwrite earlier ones, as the
reference's sequential writes do. JAX relies on XLA's in-order scatter
for that; torch leaves the order of duplicate writes open (``index_put_``
on the card is nondeterministic), so :func:`scatter_points` picks each
pixel's writer first, as the largest sample order that lands there
(``scatter_reduce_`` with ``amax``, which has one answer in any order),
and then gathers the winners' colors.
"""

from __future__ import annotations

from typing import Optional

import torch


def _with_alpha(colors):
    """[..., 3] colors get alpha 1; [..., 4] stay."""
    if colors.shape[-1] == 3:
        return torch.cat([colors, torch.ones_like(colors[..., :1])], dim=-1)
    return colors


def scatter_points(color_img, xs, ys, colors, mask: Optional[
        torch.Tensor] = None):
    """Write ``colors`` at the integer pixels (xs, ys), dropping pixels
    outside the frame and entries whose ``mask`` is False; where entries
    share a pixel the last one wins.

    color_img: [H, W, 4]; xs, ys: [K] int; colors: [K, 4] or [K, 3]
    (alpha 1). Returns a new [H, W, 4] image.
    """
    h, w = color_img.shape[:2]
    inb = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    if mask is not None:
        inb = inb & mask
    colors = _with_alpha(colors).to(color_img.dtype)
    dev = color_img.device
    order = torch.arange(xs.numel(), dtype=torch.int64, device=dev)
    # A dropped entry offers -1, which never wins, at a pixel of its own
    # (its order mod the frame): one shared slot would put every dropped
    # entry's atomic on one address.
    pix = torch.where(inb, ys.long() * w + xs.long(),
                      order % max(h * w, 1))
    winner = torch.full((h * w,), -1, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(0, pix, torch.where(inb, order, -1), "amax")
    hit = (winner >= 0)[:, None]
    out = torch.where(hit, colors[winner.clamp(min=0)],
                      color_img.reshape(h * w, 4))
    return out.reshape(h, w, 4)


def draw_points(color_img, screen, colors):
    """The ``vertices`` primitive: each screen-space vertex [N, 3] one
    pixel, its coordinates truncated toward zero (``Int(v.x)``)."""
    xs = screen[:, 0].to(torch.int32)
    ys = screen[:, 1].to(torch.int32)
    return scatter_points(color_img, xs, ys, colors)


def draw_lines(color_img, screen, lines, colors, steps: Optional[int] = None):
    """Batched DDA lines.

    color_img: [H, W, 4]; screen: [N, 3] screen-space vertices; lines:
    [L, 2] vertex indices; colors: [N, 3 or 4] per-vertex colors,
    interpolated along each line; steps: samples per line, by default
    max(W, H). A line takes max(|dx|, |dy|) samples (at least 1), each
    at its position rounded to the nearest pixel (``floor(p + 0.5)``).
    """
    h, w = color_img.shape[:2]
    s = int(steps if steps is not None else max(w, h))
    lines = lines.long()
    a = screen[lines[:, 0]]
    b = screen[lines[:, 1]]
    colors = _with_alpha(colors)
    ca = colors[lines[:, 0]]
    cb = colors[lines[:, 1]]
    d = b[:, :2] - a[:, :2]
    nsteps = torch.clamp(torch.amax(torch.abs(d), dim=-1), min=1.0)
    t = torch.arange(s, dtype=torch.float32, device=screen.device)[None, :]
    frac = t / nsteps[:, None]                       # [L, S]
    valid = t < nsteps[:, None]                      # the reference's 0..<steps
    px = a[:, None, 0] + d[:, None, 0] * frac
    py = a[:, None, 1] + d[:, None, 1] * frac
    xs = torch.floor(px + 0.5).to(torch.int32).reshape(-1)
    ys = torch.floor(py + 0.5).to(torch.int32).reshape(-1)
    col = ca[:, None, :] + (cb - ca)[:, None, :] * frac[..., None]
    return scatter_points(color_img, xs, ys, col.reshape(-1, 4),
                          mask=valid.reshape(-1))
