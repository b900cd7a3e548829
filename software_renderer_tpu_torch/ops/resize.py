"""Image resize: bilinear (separable interpolation matrices) and
nearest (one gather per axis).

Counterpart of the JAX package's ops/resize.py. ``resize_bilinear``
applies a [H', H] row matrix and a [W, W'] column matrix with half-pixel
centres (align_corners=False) as one einsum in full float32: JAX asks for
``Precision.HIGHEST``, so TF32 is turned off around the product on the
card. ``resize_nearest`` samples each axis at its centres. Both take
[H, W, C] or [H, W] images on any device.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _full_float32():
    """Float32 matrix products without TF32 for the block's duration."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _bilinear_matrix(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """[n_out, n_in] row-interpolation matrix, half-pixel centres."""
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * (n_in / n_out) - 0.5
    pos = torch.clamp(pos, 0.0, n_in - 1)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.clamp(lo + 1, max=n_in - 1)
    t = pos - lo.to(torch.float32)
    rows = torch.arange(n_out, device=device)
    m = torch.zeros((n_out, n_in), dtype=torch.float32, device=device)
    m.index_put_((rows, lo), 1.0 - t, accumulate=True)
    m.index_put_((rows, hi), t, accumulate=True)
    return m


def resize_bilinear(image, height: int, width: int):
    """Bilinear resize to [height, width] (up or down); float32 out."""
    img = torch.as_tensor(image).to(torch.float32)
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    h, w, _ = img.shape
    mh = _bilinear_matrix(h, height, img.device)        # [H', H]
    mw = _bilinear_matrix(w, width, img.device).T       # [W, W']
    with _full_float32():
        out = torch.einsum("oh,hwc,wp->opc", mh, img, mw)
    return out[..., 0] if squeeze else out


def resize_nearest(image, height: int, width: int):
    """Nearest-neighbour resize (the reference's present filter)."""
    img = torch.as_tensor(image)
    h, w = img.shape[:2]
    dev = img.device
    ys = ((torch.arange(height, dtype=torch.float32, device=dev) + 0.5)
          * (h / height)).to(torch.int64)
    xs = ((torch.arange(width, dtype=torch.float32, device=dev) + 0.5)
          * (w / width)).to(torch.int64)
    return img.index_select(0, ys.clamp(0, h - 1)).index_select(
        1, xs.clamp(0, w - 1))
