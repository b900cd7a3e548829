"""Reference visibility pass in plain PyTorch (the golden model).

Counterpart of the JAX package's ops/rasterize_ref.py, which is plain XLA
with no Pallas kernel, so this port is plain torch too. Every (pixel,
triangle) pair is tested; a pixel keeps the minimum-depth covering
triangle, ties going to the lower triangle id. Triangles are taken in
chunks of ``chunk``: the first minimum wins within a chunk (``argmin``)
and a strict ``<`` decides across chunks, which together give the
reference's first-drawn-wins rule.

Coverage is clamped to each triangle's bbox, so a chunk can change no
pixel outside the union of its triangles' bboxes: each chunk is
evaluated over that window of the frame only (:func:`record_windows`),
which gives the same buffers as testing every pixel. The pass is still
O(T x pixels) in the worst case: on the card it serves small scenes and
checks, not the 100k-triangle frame.
"""

from __future__ import annotations

import torch

from ..framebuffer import NO_TRIANGLE
from .setup import TriangleSetup


def pixel_centers(width: int, height: int, y_start: int = 0, device=None):
    """Pixel-center grid ``(x + 0.5, y + y_start + 0.5)`` as broadcastable
    [1, W] and [H, 1] float32 tensors (rows in global frame coordinates)."""
    xs = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    ys = (torch.arange(height, dtype=torch.float32, device=device)
          + float(y_start)) + 0.5
    return xs[None, :], ys[:, None]


def record_windows(bbox, block: int, width: int, height: int,
                   y_start: int = 0):
    """Per block of ``block`` consecutive records, the pixel window
    (row0, row1, col0, col1) holding every pixel whose center lies in one
    of their bboxes; ``bbox``: [N, 4] x0 y0 x1 y1 inclusive, in global
    frame coordinates. Empty windows have row0 >= row1 or col0 >= col1.
    Reads the windows to the host in one transfer."""
    n = bbox.shape[0]
    pad = (-n) % block
    bb = torch.nn.functional.pad(bbox.to(torch.float32), (0, 0, 0, pad))
    bb = bb.reshape(-1, block, 4)
    lo = bb[..., :2].amin(dim=1)
    hi = bb[..., 2:].amax(dim=1)
    c0 = torch.clamp(lo[:, 0], 0, width)
    c1 = torch.clamp(hi[:, 0] + 1, 0, width)
    r0 = torch.clamp(lo[:, 1] - y_start, 0, height)
    r1 = torch.clamp(hi[:, 1] + 1 - y_start, 0, height)
    return torch.stack([r0, r1, c0, c1], dim=1).to(torch.int64).tolist()


def visibility_ref(setup: TriangleSetup, *, width: int, height: int,
                   y_start: int = 0, chunk: int = 8):
    """Brute-force visibility buffer: (depth [H, W] float32, +inf where
    uncovered; tri_id [H, W] int32, -1 where uncovered).

    Coverage is the sign-folded edge test ``e0, e1, e2 >= 0`` with
    ``e2 = |D| - e0 - e1``, clamped to each triangle's integer bbox. A
    NaN depth is the minimum for ``argmin`` (as for ``jnp.argmin``) and
    then loses the strict test, as in the JAX reference.
    """
    dev = setup.coef.device
    t = setup.num_triangles
    pad = (-t) % chunk
    coef = torch.nn.functional.pad(setup.coef, (0, 0, 0, 0, 0, pad))
    if pad:  # padded triangles: e = (-1, -1, -1), never inside
        coef[t:, 2, :] = -1.0
    zplane = torch.nn.functional.pad(setup.zplane, (0, 0, 0, pad),
                                     value=float("inf"))
    abs_d = torch.nn.functional.pad(torch.abs(setup.area2), (0, pad))
    bbox = torch.nn.functional.pad(setup.bbox.to(torch.float32),
                                   (0, 0, 0, pad))
    xs_f, ys_f = pixel_centers(width, height, y_start, dev)
    zbuf = torch.full((height, width), float("inf"), device=dev)
    idbuf = torch.full((height, width), NO_TRIANGLE, dtype=torch.int32,
                       device=dev)
    windows = record_windows(setup.bbox, chunk, width, height, y_start)
    for i, (r0, r1, c0, c1) in enumerate(windows):
        if r0 >= r1 or c0 >= c1:
            continue
        base = i * chunk
        xs = xs_f[:, c0:c1, None]                    # [1, w, 1]
        ys = ys_f[r0:r1, :, None]                    # [h, 1, 1]
        c = coef[base:base + chunk]                  # [chunk, 3, 3]
        zp = zplane[base:base + chunk]
        bb = bbox[base:base + chunk]
        e0 = xs * c[:, 0, 0] + ys * c[:, 1, 0] + c[:, 2, 0]
        e1 = xs * c[:, 0, 1] + ys * c[:, 1, 1] + c[:, 2, 1]
        e2 = abs_d[base:base + chunk] - e0 - e1
        inside = (e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0)   # [H, W, chunk]
        inside &= ((xs >= bb[:, 0]) & (xs <= bb[:, 2] + 1.0)
                   & (ys >= bb[:, 1]) & (ys <= bb[:, 3] + 1.0))
        depth = xs * zp[:, 0] + ys * zp[:, 1] + zp[:, 2]
        cand = torch.where(inside, depth, float("inf"))  # [h, w, chunk]
        k = torch.argmin(cand, dim=-1)
        best = torch.gather(cand, -1, k[..., None])[..., 0]
        z_w = zbuf[r0:r1, c0:c1]
        better = best < z_w
        zbuf[r0:r1, c0:c1] = torch.where(better, best, z_w)
        idbuf[r0:r1, c0:c1] = torch.where(
            better, (base + k).to(torch.int32), idbuf[r0:r1, c0:c1])
    return zbuf, idbuf
