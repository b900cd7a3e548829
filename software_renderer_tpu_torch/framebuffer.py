"""Framebuffer: float32 RGBA color + depth, and pixel formats.

Counterpart of the JAX package's framebuffer.py. Color stays float32
RGBA in [0, 1] and depth float32, cleared to +inf; pixel formats convert
only at the edge. The format registry :data:`PIXEL_FORMATS` maps a name
to (bytes per pixel, channels, encode, decode): encode takes [..., 4]
float RGBA, decode returns it, with missing channels filled g = b = 0 or
gray replicated and alpha 1. Packed formats keep JAX's dtypes (rgb565 is
uint16); their bit operations run in int32, which every device has, and
cast at the end. Decoding divides with ``ops.rounding.divide``, so the
card's pixels equal the CPU's.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .device import or_default
from .ops.rounding import divide

# Transparent black and +inf depth (the reference's clear values).
CLEAR_COLOR = (0.0, 0.0, 0.0, 0.0)
CLEAR_DEPTH = float("inf")
# Triangle id of an uncovered pixel in the visibility buffer.
NO_TRIANGLE = -1


@dataclasses.dataclass
class Framebuffer:
    color: torch.Tensor  # [H, W, 4] float32 RGBA in [0, 1]
    depth: torch.Tensor  # [H, W] float32, +inf where uncovered

    @property
    def height(self) -> int:
        return self.color.shape[-3]

    @property
    def width(self) -> int:
        return self.color.shape[-2]


def create_framebuffer(width: int, height: int, dtype=torch.float32,
                       device=None) -> Framebuffer:
    """A cleared framebuffer (transparent black, +inf depth), on the card
    unless ``device`` says otherwise (device.py)."""
    device = or_default(device)
    color = torch.tensor(CLEAR_COLOR, dtype=dtype, device=device).repeat(
        height, width, 1)
    depth = torch.full((height, width), CLEAR_DEPTH, dtype=dtype,
                       device=device)
    return Framebuffer(color=color, depth=depth)


def clear(fb: Framebuffer,
          color: Tuple[float, float, float, float] = CLEAR_COLOR,
          depth: float = CLEAR_DEPTH) -> Framebuffer:
    """``fb``'s shape cleared to ``color`` and ``depth``, on its device."""
    c = torch.as_tensor(color, dtype=fb.color.dtype, device=fb.color.device)
    return Framebuffer(color=c.expand(fb.color.shape).clone(),
                       depth=torch.full_like(fb.depth, depth))


def quantize_unorm8(x: torch.Tensor) -> torch.Tensor:
    """float in [0, 1] -> uint8, round to nearest (half to even, as
    ``jnp.round``)."""
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)


def to_rgba8(color: torch.Tensor) -> torch.Tensor:
    """[..., 4] float RGBA -> uint8 RGBA."""
    return quantize_unorm8(color)


_BGRA = [2, 1, 0, 3]


def to_bgra8(color: torch.Tensor) -> torch.Tensor:
    """[..., 4] float RGBA -> uint8 BGRA (the reference's byte order)."""
    return quantize_unorm8(color[..., _BGRA])


def from_rgba8(img: torch.Tensor) -> torch.Tensor:
    """uint8 RGBA -> float RGBA in [0, 1]."""
    return divide(img.to(torch.float32), 255.0)


def _encode_rgb565(color):
    q = torch.clamp(color[..., :3], 0.0, 1.0)
    r = torch.round(q[..., 0] * 31.0).to(torch.int32)
    g = torch.round(q[..., 1] * 63.0).to(torch.int32)
    b = torch.round(q[..., 2] * 31.0).to(torch.int32)
    return ((r << 11) | (g << 5) | b).to(torch.uint16)


def _decode_rgb565(raw):
    raw = raw.to(torch.int32)
    r = divide(((raw >> 11) & 0x1F).to(torch.float32), 31.0)
    g = divide(((raw >> 5) & 0x3F).to(torch.float32), 63.0)
    b = divide((raw & 0x1F).to(torch.float32), 31.0)
    return torch.stack([r, g, b, torch.ones_like(r)], dim=-1)


# Rec.601 luma.
_LUMA = (0.299, 0.587, 0.114)


def _encode_gray8(color):
    w = torch.tensor(_LUMA, dtype=torch.float32, device=color.device)
    c = color[..., :3] * w
    return quantize_unorm8(c[..., 0] + c[..., 1] + c[..., 2])


def _gray_to_rgba(y):
    return torch.stack([y, y, y, torch.ones_like(y)], dim=-1)


PIXEL_FORMATS = {
    # name: (bytes_per_pixel, channels, encode, decode)
    "rgba8": (4, 4, to_rgba8, from_rgba8),
    "bgra8": (4, 4, to_bgra8, lambda raw: from_rgba8(raw[..., _BGRA])),
    "rgb565": (2, 3, _encode_rgb565, _decode_rgb565),
    "gray8": (1, 1, _encode_gray8,
              lambda raw: _gray_to_rgba(divide(raw.to(torch.float32),
                                               255.0))),
    "rgba16f": (8, 4, lambda c: c.to(torch.float16),
                lambda raw: raw.to(torch.float32)),
    "rgba32f": (16, 4, lambda c: c.to(torch.float32), lambda raw: raw),
    # Single-channel float (depth-style r32Float).
    "r32f": (4, 1, lambda c: c[..., 0].to(torch.float32), _gray_to_rgba),
}


def _codec(fmt: str, i: int):
    try:
        return PIXEL_FORMATS[fmt][i]
    except KeyError:
        raise ValueError(f"unknown pixel format {fmt!r}; "
                         f"have {sorted(PIXEL_FORMATS)}") from None


def encode_pixels(color: torch.Tensor, fmt: str) -> torch.Tensor:
    """[..., 4] float RGBA -> packed pixels in the named format."""
    return _codec(fmt, 2)(color)


def decode_pixels(raw: torch.Tensor, fmt: str) -> torch.Tensor:
    """Packed pixels -> [..., 4] float RGBA (missing channels defaulted)."""
    return _codec(fmt, 3)(raw)


def bytes_per_pixel(fmt: str) -> int:
    """The format's stride in bytes."""
    return _codec(fmt, 0)
