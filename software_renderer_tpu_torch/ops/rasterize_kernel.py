"""Raster records and the record-walking visibility kernels.

Counterpart of the JAX package's ops/rasterize_pallas.py. Its
``_visibility_kernel`` (software_renderer_tpu/ops/rasterize_pallas.py:110)
runs in two modes, and csrc/visibility_merge.cu keeps both as template
instances of one kernel:

* merge + lex ties (:func:`visibility_merge_kernel`): overflow records
  merged into an existing (z, id) buffer with the lexicographic (depth,
  id) rule, on every frame of ops/binning.py's binned paths, over a
  static list whose live count (JAX's ``n_live``) the kernels read on
  the device;
* clear (:func:`visibility_kernel`, the ``pallas`` backend's
  :func:`visibility_pallas`): every record of the frame into the clear
  buffer, strict ``<`` in ascending id, so the first drawn wins ties.

What bounds both on the card: finding, for each block of pixels, the
records that can touch it, then about 24 float operations per (pixel,
record) pair. A block that scanned all N records would read blocks x N
records through L2, more than the raster takes at config 4, and a CSR
list per tile built through a host sync and a sort costs more again. So
the kernels cull in two levels with no host sync (header of
csrc/visibility_merge.cu): a first pass gives each record the exact span
of pixels its bbox clamp lets through; a second lists, per 256x128
super-tile and per chunk of records, the records whose span meets the
super-tile, in ascending order and in the chunk's own region of an
N-entry list (so nothing waits for a total); then one 256-thread block
per 32x32 tile, its pixels in registers, culls its super-tile's list
with warp ballots into a shared-memory list, in order, and walks the
survivors' staged records. The scratch (spans, lists, counts) is
allocated here. The TPU's waves are dropped: the lex minimum does not
depend on record order, and the clear mode walks the records in the
order given.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _cuda
from ..device import constant
from .rasterize_ref import pixel_centers, record_windows
from .setup import TriangleSetup

# Tile geometry of the binned layout (see ops/binning.py).
TILE_H = 64
TILE_W = 128
# Pair-budget rounding unit of the binned stream (ops/binning.py).
CHUNK = 128
# Records the plain versions test at once: a trade of memory for Python
# loop trips, with no effect on the result.
PLAIN_BLOCK = 8
# Record layout (REC_WIDTH float32 per triangle):
# 0:2 a0 a1 | 2:4 b0 b1 | 4:6 c0 c1 | 6 |D| | 7:10 zx zy zc
# | 10:14 bbox x0 y0 x1 y1 (inclusive) | 14 id (exact below 2^24) | 15 unused
REC_WIDTH = 16


# A record that covers nothing and loses every depth test: c0 = c1 = -1
# (e0, e1 < 0 everywhere), zc = +inf, the empty bbox x0 = y0 = 1 > x1 =
# y1 = 0, id -1.
_POISON = (0.0, 0.0, 0.0, 0.0, -1.0, -1.0, 0.0, 0.0, 0.0, float("inf"),
           1.0, 1.0, 0.0, 0.0, -1.0, 0.0)


def _poison_row(device=None) -> torch.Tensor:
    """The poison record on ``device`` (the CPU by default): a shared
    constant (``device.constant``), read only."""
    return constant(_POISON, "cpu" if device is None else device)


def pack_records(setup: TriangleSetup, chunk: int = CHUNK) -> torch.Tensor:
    """[T_pad, REC_WIDTH] raster records in ascending id, invalid
    triangles poisoned, padded with poison rows to a multiple of
    ``chunk`` (at least one chunk)."""
    t = setup.num_triangles
    dev = setup.coef.device
    rec = torch.cat([
        setup.coef[:, 0, 0:2], setup.coef[:, 1, 0:2], setup.coef[:, 2, 0:2],
        (torch.abs(setup.area2) * setup.valid)[:, None], setup.zplane,
        setup.bbox.to(torch.float32),
        torch.arange(t, dtype=torch.float32, device=dev)[:, None],
        torch.zeros((t, 1), dtype=torch.float32, device=dev)], dim=1)
    poison = _poison_row(dev)
    rec = torch.where(setup.valid[:, None], rec, poison)
    pad = (-t) % chunk
    if pad or t == 0:
        n_fill = max(pad, chunk if t == 0 else pad)
        rec = torch.cat([rec, poison.expand(n_fill, -1)], dim=0)
    return rec


def live_rows(rows, n_live):
    """The rows before the device count ``n_live`` (all of them when it
    is None): a plain version's view of a count-aware kernel's input."""
    return rows if n_live is None else rows[:int(n_live)]


def visibility_merge_plain(rec, z_in, id_in, *, width: int, height: int,
                           y_start: int = 0, n_live=None):
    """Plain version: lex (depth, id) minimum over the seed and every
    record before ``n_live`` that covers a pixel (bbox-clamped edge
    test), PLAIN_BLOCK records at a time, each block over the window of
    its records' bboxes (ops/rasterize_ref.py ``record_windows``: no
    pixel outside it can change)."""
    rec = live_rows(rec, n_live)
    xs_f, ys_f = pixel_centers(width, height, y_start, rec.device)
    z = z_in.clone()
    ids = id_in.clone()
    big = torch.iinfo(torch.int32).max
    windows = record_windows(rec[:, 10:14], PLAIN_BLOCK, width, height,
                             y_start)
    for i, (r0, r1, c0, c1) in enumerate(windows):
        if r0 >= r1 or c0 >= c1:
            continue
        j = i * PLAIN_BLOCK
        xs, ys = xs_f[:, c0:c1], ys_f[r0:r1]
        r = rec[j:j + PLAIN_BLOCK, :, None, None]          # [K, 16, 1, 1]
        e0 = r[:, 0] * xs + r[:, 2] * ys + r[:, 4]
        e1 = r[:, 1] * xs + r[:, 3] * ys + r[:, 5]
        e2 = r[:, 6] - e0 - e1
        inside = (e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0)
        inside &= ((xs >= r[:, 10]) & (xs <= r[:, 12] + 1.0)
                   & (ys >= r[:, 11]) & (ys <= r[:, 13] + 1.0))
        depth = r[:, 7] * xs + r[:, 8] * ys + r[:, 9]
        ok = inside & ~torch.isnan(depth)
        cand = torch.where(ok, depth, float("inf"))
        tri = r[:, 14].to(torch.int32)               # [K, 1, 1]
        bz = cand.min(dim=0).values
        bid = torch.where(ok & (cand == bz), tri, big).min(dim=0).values
        z_w, id_w = z[r0:r1, c0:c1], ids[r0:r1, c0:c1]
        better = (bz < z_w) | ((bz == z_w) & (bid < id_w))
        z[r0:r1, c0:c1] = torch.where(better, bz, z_w)
        ids[r0:r1, c0:c1] = torch.where(better, bid, id_w)
    return z, ids


def card_visibility(lib, rec, z_in=None, id_in=None, *, width: int,
                    height: int, y_start: int = 0, n_live=None):
    """Launch the card kernels of ``lib`` on checked CUDA inputs: the
    merge mode from (z_in, id_in) over the records before ``n_live`` (a
    0-d int32 device tensor, or None for all), or the clear mode when
    they are None.
    Allocates the scratch the library asks for (per record a span, per
    super-tile an N-entry list and a count per chunk of records). Returns
    (z, id)."""
    dev = rec.device
    n = rec.shape[0]
    sizes = (ctypes.c_longlong * 3)()
    _cuda.check(lib.sr_visibility_scratch(n, width, height, sizes))
    spans = torch.empty((sizes[0], 4), dtype=torch.int16, device=dev)
    lst = torch.empty(sizes[1], dtype=torch.int32, device=dev)
    cnt = torch.empty(sizes[2], dtype=torch.int32, device=dev)
    z = torch.empty((height, width), dtype=torch.float32, device=dev)
    ids = torch.empty((height, width), dtype=torch.int32, device=dev)
    head = (rec.data_ptr(), n, spans.data_ptr(), lst.data_ptr(),
            cnt.data_ptr())
    tail = (width, height, y_start, z.data_ptr(), ids.data_ptr(),
            _cuda.stream_of(rec))
    if z_in is None:
        _cuda.check(lib.sr_visibility(*head, *tail))
    else:
        _cuda.check(lib.sr_visibility_merge(
            *head, None if n_live is None else n_live.data_ptr(),
            z_in.data_ptr(), id_in.data_ptr(), *tail))
    return z, ids


def visibility_merge_kernel(rec, z_in, id_in, *, width: int, height: int,
                            y_start: int = 0, n_live=None):
    """Rasterize raster records ([N, REC_WIDTH] float32, bbox in columns
    10-13, id in column 14, -1 rows inert) into the (z_in [H, W] float32,
    id_in [H, W] int32) buffer with the lex (depth, id) rule.

    n_live: None (every record is live) or a 0-d int32 tensor on the
    records' device, JAX's ``n_live``: records at or past it are inert,
    and the span and super-tile passes skip them, so one static list
    serves every frame and a count of 0 returns the seed (the launches
    still run: no count reaches the host).

    CPU tensors run :func:`visibility_merge_plain`; CUDA tensors launch
    the kernel.
    """
    if rec.device.type == "cpu":
        return visibility_merge_plain(rec, z_in, id_in, width=width,
                                      height=height, y_start=y_start,
                                      n_live=n_live)
    dev = rec.device
    _cuda.require(rec, torch.float32, "rec", ndim=2, align=16)
    if rec.shape[1] != REC_WIDTH:
        raise ValueError(f"rec must be [N, {REC_WIDTH}]")
    _cuda.require(z_in, torch.float32, "z_in", device=dev,
                  shape=(height, width))
    _cuda.require(id_in, torch.int32, "id_in", device=dev,
                  shape=(height, width))
    if n_live is not None:
        _cuda.require(n_live, torch.int32, "n_live", device=dev, shape=())
    lib = _cuda.lib()
    _cuda.launches["visibility_merge"] += 1
    return card_visibility(lib, rec, z_in, id_in, width=width,
                           height=height, y_start=y_start, n_live=n_live)


def visibility_plain(rec, *, width: int, height: int, y_start: int = 0):
    """Plain version of the clear mode: :func:`visibility_merge_plain`
    from the clear buffer (inf, -1). With the records in ascending id the
    lex (depth, id) rule and the strict ``<`` walk choose the same winner
    at every pixel (a later record never has the lower id); the CPU tests
    hold this against the reference visibility pass bit for bit."""
    z0 = torch.full((height, width), float("inf"), device=rec.device)
    i0 = torch.full((height, width), -1, dtype=torch.int32, device=rec.device)
    return visibility_merge_plain(rec, z0, i0, width=width, height=height,
                                  y_start=y_start)


def visibility_kernel(rec, *, width: int, height: int, y_start: int = 0):
    """Rasterize raster records ([N, REC_WIDTH] float32, ascending id,
    -1 rows inert) into a clear buffer with the strict ``<`` rule.
    Returns (z [H, W] float32, id [H, W] int32).

    CPU tensors run :func:`visibility_plain`; CUDA tensors launch the
    clear mode of csrc/visibility_merge.cu.
    """
    if rec.device.type == "cpu":
        return visibility_plain(rec, width=width, height=height,
                                y_start=y_start)
    _cuda.require(rec, torch.float32, "rec", ndim=2, align=16)
    if rec.shape[1] != REC_WIDTH:
        raise ValueError(f"rec must be [N, {REC_WIDTH}]")
    lib = _cuda.lib()
    _cuda.launches["visibility"] += 1
    return card_visibility(lib, rec, width=width, height=height,
                           y_start=y_start)


def visibility_pallas(setup: TriangleSetup, *, width: int, height: int,
                      y_start: int = 0, chunk: int = CHUNK):
    """The ``pallas`` backend's visibility pass: every triangle's record,
    in ascending id, through :func:`visibility_kernel`. Returns (depth
    [H, W], tri_id [H, W]), the contract of
    ops/rasterize_ref.visibility_ref."""
    return visibility_kernel(pack_records(setup, chunk), width=width,
                             height=height, y_start=y_start)
