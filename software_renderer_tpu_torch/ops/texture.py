"""Texture sampling: nearest and bilinear, repeat and clamp addressing.

Bilinear sampling reads one row of a quad table per pixel: row (y, x)
holds the 2x2 texel neighbourhood with the wrap mode baked in. The
sampler is plain torch: in the JAX package it is an XLA stage, not a
Pallas kernel. The JAX package's compacted sampler and its
``TEX_GATHER_SPLIT``/``TEX_TABLE_PACK`` knobs work around the TPU's
gather costs and are not ported; the JAX docstring states the compacted
sampler equals :func:`sample_texture_planes` per covered pixel. The
trilinear filter is ROADMAP.md Queue 1 item 5.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class Texture:
    """An RGB(A) texture. data: [Th, Tw, C] float32 in [0, 1].

    ``table`` is the bilinear quad table, built once at construction.
    """

    data: torch.Tensor
    filter: str = "bilinear"   # "nearest" | "bilinear"
    wrap: str = "repeat"       # "repeat" | "clamp"
    table: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.filter not in ("nearest", "bilinear"):
            raise NotImplementedError(
                f"texture filter {self.filter!r} is not ported yet "
                "(ROADMAP.md Queue 1 item 5)")
        if self.table is None and self.filter == "bilinear":
            self.table = _quad_table_from(self.data, self.wrap)

    def to(self, device) -> "Texture":
        return Texture(self.data.to(device), self.filter, self.wrap,
                       None if self.table is None else self.table.to(device))


def _wrap_coords(i, n: int, mode: str):
    if mode == "repeat":
        return torch.remainder(i, n)
    if mode == "clamp":
        return torch.clamp(i, 0, n - 1)
    raise ValueError(f"unknown wrap mode {mode!r}")


def _quad_table_from(d, wrap: str):
    """[Th*Tw, 4C] rows [t(y,x), t(y,x+1), t(y+1,x), t(y+1,x+1)]."""
    if wrap == "repeat":
        dx = torch.roll(d, -1, dims=1)
        dy = torch.roll(d, -1, dims=0)
        dxy = torch.roll(dx, -1, dims=0)
    elif wrap == "clamp":
        dx = torch.cat([d[:, 1:], d[:, -1:]], dim=1)
        dy = torch.cat([d[1:], d[-1:]], dim=0)
        dxy = torch.cat([dx[1:], dx[-1:]], dim=0)
    else:
        raise ValueError(f"unknown wrap mode {wrap!r}")
    th, tw, c = d.shape
    return torch.cat([d, dx, dy, dxy], dim=-1).reshape(th * tw, 4 * c)


def sample_texture_planes(tex: Texture, u, v):
    """Sample at (u, v) planes in [0, 1] (u right, v down); returns a list
    of C planes shaped like u."""
    th, tw, c = tex.data.shape
    u = u * tw
    v = v * th
    if tex.filter == "nearest":
        xi = _wrap_coords(torch.floor(u).to(torch.int32), tw, tex.wrap)
        yi = _wrap_coords(torch.floor(v).to(torch.int32), th, tex.wrap)
        texel = tex.data.reshape(th * tw, c)[(yi * tw + xi).long()]
        return [texel[..., i] for i in range(c)]
    x = u - 0.5
    y = v - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    xa = _wrap_coords(x0.to(torch.int32), tw, tex.wrap)
    ya = _wrap_coords(y0.to(torch.int32), th, tex.wrap)
    quad = tex.table[(ya * tw + xa).long()]
    out = []
    for i in range(c):
        t00 = quad[..., i]
        t01 = quad[..., c + i]
        t10 = quad[..., 2 * c + i]
        t11 = quad[..., 3 * c + i]
        top = t00 + (t01 - t00) * fx
        bot = t10 + (t11 - t10) * fx
        out.append(top + (bot - top) * fy)
    return out


def sample_texture(tex: Texture, uv):
    """Sample at ``uv`` [..., 2] in [0, 1] (u right, v down); returns
    [..., C]. The planes sampler on the two coordinate planes (the same
    arithmetic as the JAX package's ``sample_texture``)."""
    return torch.stack(sample_texture_planes(tex, uv[..., 0], uv[..., 1]),
                       dim=-1)


def checkerboard(size: int = 256, tiles: int = 8, c0=(1.0, 1.0, 1.0),
                 c1=(0.2, 0.2, 0.2), device=None) -> Texture:
    """Procedural checkerboard (test/demo texture)."""
    ij = torch.arange(size, device=device) * tiles // size
    mask = (ij[:, None] + ij[None, :]) % 2
    c0 = torch.tensor(c0, dtype=torch.float32, device=device)
    c1 = torch.tensor(c1, dtype=torch.float32, device=device)
    return Texture(data=torch.where(mask[..., None] == 0, c0, c1))
