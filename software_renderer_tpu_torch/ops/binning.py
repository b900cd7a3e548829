"""Tile binning and the fused raster + shade pipeline.

Bin build: each valid, coverage-safe triangle whose bbox spans at most
``kmax`` (tile, band) bins, and whose pairs fit the pair budget, emits one
pair per bin it overlaps; pairs are stably sorted by bin, so each bin's
list stays in ascending triangle id (the reference's draw order). The
layout is CSR: ``bin_start[nbins + 1]`` and the ids in (bin, id) order.
The other triangles spill to the overflow path, which rasterizes them
into seed buffers (ops/rasterize_kernel.py, :func:`resolve_merge_kernel`)
that the fused kernel then starts from.

Shapes are static, as in JAX, and every count stays on the device, so a
frame never waits on the host and a CUDA graph can capture it
(parallel/frame_graph.py): the pair list has JAX's capacity
``pairs_cap`` with a -1 tail, the overflow count is a 0-d tensor, the
overflow ids are a static list (:func:`overflow_ids`, JAX's
``overflow_id_waves`` in one wave), and the merge kernels (K3, K4) take
the live count as a device pointer (JAX's ``n_live``) while K2 reads
the same count to choose between its static and seeded walks (JAX's
``lax.cond(n_overflow == 0, ...)``). Every bin build also adds its
spills, by reason, to its device's spill counter (:func:`spill_counts`)
on the device, so a replayed frame counts too.

Semantics are the JAX package's ops/binning.py; its TPU-only devices are
not ported: the matmul cumsum (``torch.cumsum`` on int64 is exact), the
two-sort filler layout and the live-first chunk permutation (CUDA blocks
take their own bins), the ``permute``/``prune`` knobs, the profiling
switches and the int32 key packing (a stable sort on the bin id keeps
the id order).

Two pipelines use the bins. :func:`fused_pipeline` (the main path)
rasterizes and shades in one kernel over banded bins.
:func:`binned_pipeline` (attribute-free frames, ``visibility_binned``)
runs a visibility pass over whole-tile bins, merges the overflow
triangles on top with the lex (depth, id) rule, and then resolves the
winners' attribute planes into a G-buffer when it is given attributes.
Both give the same pixels: the lex rule does not depend on the order.

Kernels (csrc/), each replacing one of the JAX package's: ``fused.cu``
``_fused_kernel`` (software_renderer_tpu/ops/binning.py:703) and, as the
zero-channel instance of the same walk, ``_binned_vis_kernel`` (:607);
``resolve.cu`` ``_resolve_kernel`` (:663) and ``resolve_merge.cu``
``_resolve_merge_kernel`` (:683). What bounds each and what its design
does about it is noted at the wrapper.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from .. import _cuda
from ..device import resolved
from ..utils.profiling import span
from . import frontend as fe
from .rasterize_kernel import (CHUNK, PLAIN_BLOCK, TILE_H, TILE_W,
                               visibility_merge_kernel)
from .rasterize_ref import pixel_centers
from .shading import (_chan_offset, fused_epilogue, fused_output_channels,
                      perspective_epilogue)

# Max (tile, band) bins per binned triangle, in tile units; fused_pipeline
# scales it by the band count.
KMAX = 12
# Binned-pair budget in units of T (fused_pipeline's callers pass their own).
PAIR_BUDGET_FACTOR = 1.5
# Stream-table columns before the attribute planes: a0 a1 | b0 b1 | c0 c1
# | |D| | zx zy zc | id.
REC_BASE = 11
# Band partitioning of the fused path: bands of tile_h / FUSED_BANDS rows
# from FUSED_BANDS_MIN_T triangles up (the JAX package's swept defaults).
FUSED_BANDS = 4
FUSED_BANDS_MIN_T = 2048
# Rows the CUDA bin walk (K2, K5) covers per block; a band must be a
# multiple.
SLAB_H = 8
# Channels of a perspective plan: the largest plan's 8 (rgb, normal, uv)
# and 1/w.
MAX_PERSP_CHANNELS = 9


@dataclasses.dataclass
class BinInfo:
    """CSR bin lists: bin b's ids are ``ids[bin_start[b]:bin_start[b+1]]``
    in ascending order. Bin index ``(tile_row * gw + tile_col) * bands +
    band``. Shapes depend on T and the frame only (JAX's ``BinInfo``):
    ``bin_start[nbins]`` is the live pair count."""

    bin_start: torch.Tensor      # [nbins + 1] int32
    ids: torch.Tensor            # [pairs_cap] int32, -1 past the live pairs
    overflow_mask: torch.Tensor  # [T] bool — triangle spilled
    n_overflow: torch.Tensor     # [] int32 on the device


def build_bins(setup, *, width: int, height: int,
               y_start: int = 0, tile_h: int = TILE_H, tile_w: int = TILE_W,
               chunk: int = CHUNK, kmax: int = KMAX,
               pair_budget_factor: float = PAIR_BUDGET_FACTOR,
               bands: int = 1) -> BinInfo:
    """Per-(tile, band) triangle lists from the triangles' bboxes.

    A triangle is binned when it is valid, overlaps the rows
    [y_start, y_start + gh * tile_h), is coverage-safe, spans at most
    ``kmax`` bins, and its inclusive prefix of pair counts stays within
    the budget ``ceil(trunc(pair_budget_factor * T) / chunk) * chunk``
    (the prefix is monotone, so once past the budget every later
    triangle spills). Every other valid triangle overflows, and is added
    to its device's spill counter by reason (:func:`spill_counts`).
    ``setup``: a PlanarSetup, or a TriangleSetup (the near-plane clip's).

    JAX's compact emission with no host sync (JAX binning.py:228-300):
    slot s of the ``pairs_cap = min(budget, ceil(T * kmax / chunk) *
    chunk)`` slots belongs to the binned triangle whose range of
    exclusive slot starts holds it (a ``searchsorted``); dead slots are
    keyed past the last bin, so the stable sort leaves them at the end,
    and ``bin_start`` is each bin's first position in the sorted keys.
    """
    ps = fe.as_planar(setup)
    if tile_h % bands or (tile_h // bands) % 8:
        raise ValueError(f"bands={bands} must split tile_h={tile_h} into "
                         "8-row-aligned bands")
    bx0, by0, bx1, by1 = ps.bx0, ps.by0, ps.bx1, ps.by1
    t = ps.num_triangles
    dev = ps.valid.device
    gh = -(-height // tile_h)
    gw = -(-width // tile_w)
    nbins = gh * gw * bands
    bh = tile_h // bands
    gbands = gh * bands
    tx0 = bx0 // tile_w
    tx1 = bx1 // tile_w
    ty0 = torch.clamp((by0 - y_start) // bh, 0, gbands - 1)
    ty1 = torch.clamp((by1 - y_start) // bh, 0, gbands - 1)
    in_slice = (by1 >= y_start) & (by0 < y_start + gh * tile_h)
    span_w = tx1 - tx0 + 1
    nspan = (span_w * (ty1 - ty0 + 1)).to(torch.int64)
    # Each test's mask is a row of one buffer, which the spill counter
    # sums: valid; and coverage-safe; and within kmax; and within budget.
    masks = torch.empty((4, t), dtype=torch.bool, device=dev)
    valid = torch.bitwise_and(ps.valid, in_slice, out=masks[0])
    safe = torch.bitwise_and(valid, ps.safe, out=masks[1])
    small = torch.bitwise_and(safe, nspan <= kmax, out=masks[2])
    budget_pairs = -(int(-pair_budget_factor * max(t, 1)) // chunk) * chunk
    cum = torch.cumsum(torch.where(small, nspan, 0), 0)
    binned = torch.bitwise_and(small, cum <= budget_pairs, out=masks[3])
    overflow = valid ^ binned         # valid & ~binned: binned lies in valid
    n_overflow = _count_spills(masks)

    pairs_cap = int(min(budget_pairs, -(-(t * kmax) // chunk) * chunk))
    nspb = torch.where(binned, nspan, 0)
    sb = torch.cumsum(nspb, 0) - nspb          # exclusive slot starts
    slots = torch.arange(pairs_cap, device=dev)
    src = torch.searchsorted(sb, slots, right=True) - 1
    src_c = torch.clamp(src, 0, max(t - 1, 0))
    k = slots - sb[src_c]
    live = (src >= 0) & (k < nspb[src_c])
    k = torch.where(live, k, 0)
    sw = torch.where(live, span_w[src_c].to(torch.int64), 1)
    band_row = ty0[src_c].to(torch.int64) + k // sw
    tile_col = tx0[src_c].to(torch.int64) + k % sw
    bin_of = ((band_row // bands) * gw + tile_col) * bands + band_row % bands
    keys, order = torch.sort(torch.where(live, bin_of, nbins), stable=True)
    bin_start = torch.searchsorted(
        keys, torch.arange(nbins + 1, device=dev)).to(torch.int32)
    return BinInfo(bin_start=bin_start,
                   ids=torch.where(live, src_c, -1)[order].to(torch.int32),
                   overflow_mask=overflow, n_overflow=n_overflow)


# The spill counter of each device: 5 int64 slots, the sums over every
# bin build of its masks' rows (valid; and safe; and within kmax; and
# within the budget) and the bin builds (:func:`_count_spills`).
_spill_counters: dict = {}


def _count_spills(masks):
    """Add the row sums of a bin build's [4, T] masks (:func:`build_bins`)
    and 1 to its device's counter, with no host sync, and return the
    build's overflow count (valid less binned; 0-d int32). Each reason's
    count is the difference of two consecutive rows' sums
    (:func:`spill_counts`). The sums stand in for the overflow mask's
    own, so the counter adds two device operations a build."""
    dev = resolved(masks.device)
    counter = _spill_counters.get(dev)
    if counter is None:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a device's first bin build makes its spill "
                               "counter and must not be captured")
        counter = _spill_counters[dev] = torch.zeros(
            5, dtype=torch.int64, device=dev)
    sums = masks.sum(1, dtype=torch.int32)
    counter[:4].add_(sums)
    counter[4:].add_(1)
    return sums[0] - sums[3]


def spill_counts(device) -> dict:
    """The spill counter of ``device`` since its last reset, read with
    one host sync: ``frames``, the bin builds (one a frame; one a band
    in ``render_rows``), and the triangles they spilled, by reason:
    ``budget`` (past the pair budget), ``kmax`` (spanning more than kmax
    bins) and ``unsafe`` (not coverage-safe). All 0 on a device that has
    built no bins."""
    counter = _spill_counters.get(resolved(device))
    valid, safe, small, binned, frames = (
        [0] * 5 if counter is None else counter.tolist())
    return {"frames": frames, "budget": small - binned,
            "kmax": safe - small, "unsafe": valid - safe}


def reset_spill_counts(device=None) -> None:
    """Zero the spill counter of ``device``, or of every device."""
    for dev, counter in _spill_counters.items():
        if device is None or dev == resolved(device):
            counter.zero_()


class OverflowList(NamedTuple):
    """The static overflow list and its slot map."""

    ids: torch.Tensor    # [cap] int32: spilled ids ascending, then -1
    slots: torch.Tensor  # [T] int32: each triangle's row, cap if none


def overflow_ids(overflow_mask, chunk: int = CHUNK) -> OverflowList:
    """The spilled triangles' ids, ascending, then -1: a static
    [ceil(T / chunk) * chunk] int32 list (at least one chunk), the
    length of :func:`ops.frontend.pack_records_planar`'s records (JAX's
    ``overflow_id_waves`` as one wave: the kernels stop at the count);
    and the scatter's index as the slot map, [T] int32: each triangle's
    row in the list, the list's length where it did not spill. K4
    (:func:`resolve_merge_kernel`) finds a pixel's row with one read of
    it. Positions come from a cumsum and a scatter, with no host sync."""
    t = overflow_mask.shape[0]
    dev = overflow_mask.device
    cap = -(-max(t, 1) // chunk) * chunk
    pos = torch.cumsum(overflow_mask, 0)
    slots = torch.where(overflow_mask, pos - 1, cap)
    ids = torch.full((cap + 1,), -1, dtype=torch.int32, device=dev)
    # Triangles that did not spill all land in the dropped last slot.
    ids.scatter_(0, slots, torch.arange(t, dtype=torch.int32, device=dev))
    return OverflowList(ids[:cap], slots.to(torch.int32))


def gather_stream(table, ids, poison):
    """Table rows in ``ids`` order; -1 ids become poison rows."""
    rows = table[torch.clamp(ids, 0, table.shape[0] - 1).long()]
    return torch.where((ids >= 0)[:, None], rows, poison)


# ---------------------------------------------------------------------------
# Overflow G-buffer resolve (K4)
# ---------------------------------------------------------------------------

def _write_rows(gb, r, pix, *, y_start: int):
    """Write the stream rows ``r``'s planes ``px * x + py * y + pc``,
    evaluated at the centers of the flat pixels ``pix``, into ``gb``
    [A, H, W] (in place)."""
    n_channels, height, width = gb.shape
    xs, ys = pixel_centers(width, height, y_start, gb.device)
    xs = xs.expand(height, width).reshape(-1)[pix]
    ys = ys.expand(height, width).reshape(-1)[pix]
    flat = gb.view(n_channels, -1)
    for a in range(n_channels):
        p = REC_BASE + 3 * a
        flat[a, pix] = r[:, p] * xs + r[:, p + 1] * ys + r[:, p + 2]
    return gb


def _write_planes(gb, rows, row_keys, pixel_keys, hit, *, y_start: int):
    """Where ``hit``, find each pixel's key among the ascending
    ``row_keys`` and write that row's planes into ``gb`` (in place)."""
    if rows.shape[0] == 0:
        return gb
    idx = torch.clamp(torch.searchsorted(row_keys, pixel_keys),
                      max=rows.shape[0] - 1)
    pix = torch.nonzero(hit & (row_keys[idx] == pixel_keys)).squeeze(1)
    return _write_rows(gb, rows[idx[pix]], pix, y_start=y_start)


def slot_map(rows, n_live=None):
    """[max id + 1] int32: each of the first ``n_live`` rows' position by
    its id (column 10; the first row of an id where it repeats), N (never
    live) for the other ids: the map :func:`overflow_ids` returns with
    its list, built from rows made by hand with one scatter. Reads the
    largest id on the host, so no frame calls it."""
    n = rows.shape[0]
    dev = rows.device
    ids = rows[:, REC_BASE - 1].to(torch.int64)
    live = ids >= 0
    if n_live is not None:
        live &= torch.arange(n, device=dev) < n_live
    size = int(torch.where(live, ids, -1).max()) + 1 if n else 0
    slots = torch.full((size + 1,), n, dtype=torch.int32, device=dev)
    slots.scatter_reduce_(0, torch.where(live, ids, size),
                          torch.arange(n, dtype=torch.int32, device=dev),
                          reduce="amin")
    return slots[:size]


def _merge_hits(rows, tid, slots, n_live):
    """(flat pixels whose winner is one of the first ``n_live`` rows,
    those rows' indices) through the slot map."""
    n = rows.shape[0]
    q = tid.reshape(-1).long()
    known = (q >= 0) & (q < slots.numel())
    r = torch.cat([slots, slots.new_full((1,), n)])[
        torch.where(known, q, slots.numel())]
    hit = (r >= 0) & (r < n) & (r < (n if n_live is None else n_live))
    pix = torch.nonzero(hit).squeeze(1)
    return pix, r[pix].long()


def resolve_merge_plain(rows, tid, gb_in, *, width: int, height: int,
                        y_start: int = 0, n_live=None, slots=None,
                        inplace: bool = False):
    """Plain version: where ``tid``'s triangle has a row before
    ``n_live`` (``slots[tid]``; built by :func:`slot_map` when None),
    that row's planes evaluated at the pixel; ``gb_in`` elsewhere (0
    where it is None). ``inplace``: write into ``gb_in`` and return
    it."""
    if slots is None:
        slots = slot_map(rows, n_live)
    gb = (torch.zeros((_row_channels(rows), height, width),
                      device=rows.device) if gb_in is None
          else gb_in if inplace else gb_in.clone())
    pix, r = _merge_hits(rows, tid, slots, n_live)
    return _write_rows(gb, rows[r], pix, y_start=y_start)


def _row_channels(rows) -> int:
    """Attribute channels of [N, 11 + 3A] stream rows."""
    if (rows.shape[1] - REC_BASE) % 3 or rows.shape[1] < REC_BASE:
        raise ValueError(f"rows must be [N, {REC_BASE} + 3A], got "
                         f"{tuple(rows.shape)}")
    return (rows.shape[1] - REC_BASE) // 3


def resolve_merge_kernel(rows, tid, gb_in, *, width: int, height: int,
                         y_start: int = 0, n_live=None, slots=None,
                         inplace: bool = False):
    """Overflow G-buffer resolve.

    rows: [N, 11 + 3A] float32 stream rows; tid: [H, W] int32 winner ids;
    gb_in: [A, H, W] float32 seed planes, or None: then only the pixels
    whose winner has a live row are defined (the kernel writes nothing
    else, and with a count of 0 nothing at all; the plain version writes
    0 there), which is all the fused kernel reads of its seed planes;
    n_live: None (every row is live) or a 0-d int32 tensor on the rows'
    device, JAX's ``n_live``: rows at or past it are never read, so a
    static list serves every frame and a count of 0 returns the seed;
    slots: [T] int32, triangle id -> row (:func:`overflow_ids`'
    ``slots``), a row at or past the count meaning none. Without it the
    wrapper builds the map from the rows' id column with
    :func:`slot_map` (one scatter, and a host read of the largest id):
    for rows made by hand, never on a frame. inplace: the seed is the
    caller's to change: only the live winners' pixels of ``gb_in`` are
    written, and ``gb_in`` is returned; out of place the wrapper clones
    the seed first. Returns [A, H, W]. CPU tensors run
    :func:`resolve_merge_plain`; CUDA tensors launch
    csrc/resolve_merge.cu.

    What bounds it on the card: memory (the id of each pixel, and the
    slot and A plane writes of each live winner). The TPU kernel walks
    every record per tile; here a pixel reads its row's index from the
    slot map. A fixed grid of a few blocks per SM strides over 4-pixel
    groups; each warp queues its live winners in shared memory and
    evaluates their planes 32 at a time, and each block reads the count
    once, so a launch at a count of 0 returns at once.
    """
    if inplace and gb_in is None:
        raise ValueError("inplace needs a seed")
    if rows.device.type == "cpu":
        return resolve_merge_plain(rows, tid, gb_in, width=width,
                                   height=height, y_start=y_start,
                                   n_live=n_live, slots=slots,
                                   inplace=inplace)
    dev = rows.device
    _cuda.require(rows, torch.float32, "rows", ndim=2)
    a = _row_channels(rows)
    _cuda.require(tid, torch.int32, "tid", device=dev, shape=(height, width))
    if gb_in is not None:
        _cuda.require(gb_in, torch.float32, "gb_in", device=dev,
                      shape=(a, height, width))
    if n_live is not None:
        _cuda.require(n_live, torch.int32, "n_live", device=dev, shape=())
    if slots is None:
        slots = slot_map(rows, n_live)
    _cuda.require(slots, torch.int32, "slots", device=dev, ndim=1)
    gb = (gb_in if inplace else gb_in.clone() if gb_in is not None
          else torch.empty((a, height, width), dtype=torch.float32,
                           device=dev))
    lib = _cuda.lib()
    _cuda.launches["resolve_merge"] += 1
    _cuda.check(lib.sr_resolve_merge(
        rows.data_ptr(), rows.shape[0], _ptr(n_live), rows.shape[1], a,
        tid.data_ptr(), slots.data_ptr(), slots.numel(), width, height,
        y_start, gb.data_ptr(), _cuda.sm_count(dev), _cuda.stream_of(rows)))
    return gb


def _ptr(t):
    """A tensor's device pointer, None (NULL) for None."""
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# Fused raster + shade (K2)
# ---------------------------------------------------------------------------

def _grid(width: int, height: int, tile_h: int, tile_w: int, bands: int):
    gw = -(-width // tile_w)
    return -(-height // tile_h) * gw * bands, gw


def _bin_slabs(frame, gh: int, gw: int, bands: int, tile_h: int,
               tile_w: int):
    """[..., gh*tile_h, gw*tile_w] -> [..., nbins, band_h, tile_w] in bin
    order (tile row, tile column, band)."""
    lead = frame.shape[:-2]
    bh = tile_h // bands
    f = frame.reshape(*lead, gh, bands, bh, gw, tile_w)
    n = len(lead)
    f = f.permute(*range(n), n, n + 3, n + 1, n + 2, n + 4)
    return f.reshape(*lead, gh * gw * bands, bh, tile_w)


def _unbin_slabs(slabs, gh: int, gw: int, bands: int, tile_h: int,
                 tile_w: int):
    """Inverse of :func:`_bin_slabs`."""
    lead = slabs.shape[:-3]
    bh = tile_h // bands
    f = slabs.reshape(*lead, gh, gw, bands, bh, tile_w)
    n = len(lead)
    f = f.permute(*range(n), n, n + 2, n + 3, n + 1, n + 4)
    return f.reshape(*lead, gh * tile_h, gw * tile_w)


def _pad_frame(x, hp: int, wp: int, value):
    h, w = x.shape[-2:]
    return torch.nn.functional.pad(x, (0, wp - w, 0, hp - h), value=value)


def _walk_bins_plain(rows, bin_start, *, width: int, height: int,
                     n_channels: int, bands: int, y_start: int, tile_h: int,
                     tile_w: int, seeds=None):
    """The bin walk of the plain versions of K2 and K5.

    Per pixel of each bin: the lex (depth, id) minimum over the seed (or
    the clear value) and the bin's records that cover the pixel, taken
    PLAIN_BLOCK records at a time, and the winner's ``n_channels``
    attribute planes. Without seeds this equals the strict ``<`` walk in
    ascending id order. Returns (z [H, W], id [H, W], planes [A, H, W]).
    """
    dev = rows.device
    gh = -(-height // tile_h)
    gw = -(-width // tile_w)
    hp, wp = gh * tile_h, gw * tile_w
    nbins = gh * gw * bands
    a = n_channels
    xs, ys = pixel_centers(wp, hp, y_start, dev)
    xs = _bin_slabs(xs.expand(hp, wp), gh, gw, bands, tile_h, tile_w)
    ys = _bin_slabs(ys.expand(hp, wp), gh, gw, bands, tile_h, tile_w)
    xs, ys = xs[:, None], ys[:, None]                 # [nbins, 1, bh, tw]
    if seeds is None:
        z = torch.full((nbins,) + xs.shape[2:], float("inf"), device=dev)
        ids = torch.full_like(z, -1, dtype=torch.int32)
        acc = torch.zeros((nbins, a) + xs.shape[2:], device=dev)
    else:
        z_s, id_s, gb_s = seeds
        slab = lambda f, v: _bin_slabs(_pad_frame(f, hp, wp, v), gh, gw,
                                       bands, tile_h, tile_w)
        z = slab(z_s, float("inf"))
        ids = slab(id_s, -1)
        acc = slab(gb_s, 0.0).transpose(0, 1).contiguous()
    counts = (bin_start[1:] - bin_start[:-1]).long()
    starts = bin_start[:-1].long()
    n_rows = rows.shape[0]
    lmax = int(counts.max()) if nbins else 0
    block = PLAIN_BLOCK
    for j in range(0, lmax, block):
        # Only the bins with a record left at j: a block of dead records
        # changes no pixel.
        act = torch.nonzero(counts > j).squeeze(1)
        nact = act.numel()
        xa, ya = xs[act], ys[act]
        kk = torch.arange(j, j + block, device=dev)
        live = kk[None, :] < counts[act, None]          # [nact, K]
        r = rows[torch.clamp(starts[act, None] + kk, max=max(n_rows - 1, 0))]
        r = r[..., None, None]                          # [nact, K, W, 1, 1]
        e0 = r[:, :, 0] * xa + r[:, :, 2] * ya + r[:, :, 4]
        e1 = r[:, :, 1] * xa + r[:, :, 3] * ya + r[:, :, 5]
        e2 = r[:, :, 6] - e0 - e1
        inside = (e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0)
        depth = r[:, :, 7] * xa + r[:, :, 8] * ya + r[:, :, 9]
        ok = inside & live[..., None, None] & ~torch.isnan(depth)
        cand = torch.where(ok, depth, float("inf"))    # [nact, K, bh, tw]
        bz = cand.min(dim=1, keepdim=True).values
        kpos = torch.arange(block, device=dev)[None, :, None, None]
        kwin = torch.where(ok & (cand == bz), kpos, block).min(dim=1).values
        has = kwin < block
        kwin = torch.clamp(kwin, max=block - 1)
        tri = r[:, :, 10, 0, 0].to(torch.int32)         # [nact, K]
        bid = torch.gather(tri, 1, kwin.reshape(nact, -1)).reshape(
            kwin.shape)
        zwin = torch.gather(cand, 1, kwin[:, None]).squeeze(1)
        z_a, id_a = z[act], ids[act]
        better = has & ((zwin < z_a) | ((zwin == z_a) & (bid < id_a)))
        z[act] = torch.where(better, zwin, z_a)
        ids[act] = torch.where(better, bid, id_a)
        if not a:
            continue
        planes = r[:, :, REC_BASE:REC_BASE + 3 * a, 0, 0]  # [nact, K, 3A]
        win = torch.gather(
            planes, 1, kwin.reshape(nact, -1, 1).expand(-1, -1, 3 * a))
        win = win.reshape(*kwin.shape, 3 * a)           # [nact, bh, tw, 3A]
        acc_a = acc[act]
        for c in range(a):
            val = (win[..., 3 * c] * xa[:, 0] + win[..., 3 * c + 1] * ya[:, 0]
                   + win[..., 3 * c + 2])
            acc_a[:, c] = torch.where(better, val, acc_a[:, c])
        acc[act] = acc_a
    unbin = lambda s: _unbin_slabs(s, gh, gw, bands, tile_h,
                                   tile_w)[..., :height, :width]
    return unbin(z), unbin(ids), unbin(acc.transpose(0, 1))


def fused_plain(rows, bin_start, params, *, bbox, width: int, height: int,
                chans, has_light: bool, has_texture: bool, bands: int,
                y_start: int = 0, tile_h: int = TILE_H,
                tile_w: int = TILE_W, seeds=None, n_overflow=None,
                perspective: bool = False):
    """Plain version of the fused kernel: :func:`_walk_bins_plain`, then
    :func:`ops.shading.fused_epilogue` over the whole frame (inside
    :func:`ops.shading.perspective_epilogue` with ``perspective``).
    ``bbox`` is the kernel's cull and changes no pixel; it is not read
    here. The seeds are used unless ``n_overflow`` is given and 0."""
    if n_overflow is not None and int(n_overflow) == 0:
        seeds = None
    z, ids, acc = _walk_bins_plain(
        rows, bin_start, width=width, height=height,
        n_channels=sum(s for _, s in chans) + perspective, bands=bands,
        y_start=y_start, tile_h=tile_h, tile_w=tile_w, seeds=seeds)
    epilogue = functools.partial(fused_epilogue, chans=chans,
                                 has_light=has_light,
                                 has_texture=has_texture)
    if perspective:
        epilogue = functools.partial(perspective_epilogue, inner=epilogue)
    return z, ids, torch.stack(epilogue(list(acc.unbind(0)), ids >= 0,
                                        params))


def _require_walk(rows, bin_start, bbox, *, width: int, height: int,
                  tile_h: int, tile_w: int, bands: int):
    """The checks of the CUDA bin walk's (K2, K5) common inputs."""
    if tile_w != TILE_W or tile_h % bands or (tile_h // bands) % SLAB_H:
        raise ValueError(f"the CUDA bin walk takes {TILE_W}-wide tiles and "
                         f"bands that are multiples of {SLAB_H} rows")
    nbins, _ = _grid(width, height, tile_h, tile_w, bands)
    dev = rows.device
    _cuda.require(rows, torch.float32, "rows", ndim=2)
    _cuda.require(bin_start, torch.int32, "bin_start", device=dev,
                  shape=(nbins + 1,))
    _cuda.require(bbox, torch.int32, "bbox", device=dev, ndim=2, align=16)
    if bbox.shape[1] != 4:
        raise ValueError(f"bbox must be [T, 4], got {tuple(bbox.shape)}")


def fused_kernel(rows, bin_start, params, *, bbox, width: int, height: int,
                 chans, has_light: bool, has_texture: bool, bands: int,
                 y_start: int = 0, tile_h: int = TILE_H,
                 tile_w: int = TILE_W, seeds=None, n_overflow=None,
                 perspective: bool = False):
    """Fused visibility + attribute planes + shading epilogue.

    rows: [n_pairs, 11 + 3A] float32 stream rows in bin order; bin_start:
    [nbins + 1] int32 CSR offsets (:class:`BinInfo`); params: the
    [PARAMS_WIDTH] shading row; bbox: [T, 4] int32, the planar setup's
    inclusive pixel bbox (x0, y0, x1, y1) per triangle id
    (:func:`ops.frontend.bbox_table`); seeds: None, or (z [H, W] float32,
    id [H, W] int32, gb [A, H, W] float32) to start from with the lex
    (depth, id) rule, the seed planes read only where the seed's id wins
    a pixel; n_overflow: None, or a 0-d int32 tensor on the rows'
    device: JAX's ``lax.cond(n_overflow == 0, static, seeded)`` made on
    the device, the launch walks from the seeds only when the count is
    above 0 and otherwise equals the static walk bit for bit, reading no
    seed. Returns (z [H, W], id [H, W], out [n_out, H, W]).
    CPU tensors run :func:`fused_plain`; CUDA tensors launch
    csrc/fused.cu.

    perspective: the perspective plan. The rows then carry the plan's
    channels over w and a last 1/w channel (11 + 3 (A + 1) columns, A + 1
    <= MAX_PERSP_CHANNELS, and A + 1 seed planes); on covered pixels the
    kernel divides each channel by the interpolated 1/w before the plan.

    The records must be coverage-safe (as :func:`build_bins` bins them):
    the kernel tests a record only on the pixels inside its bbox.

    What bounds it on the card: the (pixel, record) tests, about 18 float
    operations each, the output planes' bytes, and the few long bins.
    Testing every record on every pixel of its bin's 16 x 128 band (the
    previous design) did ~50x the tests config 4 needs; here each warp
    owns a 16 x 4 rectangle of an 8-row slab block, culls the staged
    records by their bbox with a ballot and tests the survivors, in list
    order (no atomics), only on the rows their bbox spans. The walk keeps
    depth, id and the winning row per pixel; the epilogue evaluates the
    winner's planes (no accumulators in registers) and writes every
    pixel, empty bins included.
    """
    if rows.device.type == "cpu":
        return fused_plain(rows, bin_start, params, bbox=bbox, width=width,
                           height=height, chans=chans, has_light=has_light,
                           has_texture=has_texture, bands=bands,
                           y_start=y_start, tile_h=tile_h, tile_w=tile_w,
                           seeds=seeds, n_overflow=n_overflow,
                           perspective=perspective)
    dev = rows.device
    a = sum(s for _, s in chans) + perspective
    _require_walk(rows, bin_start, bbox, width=width, height=height,
                  tile_h=tile_h, tile_w=tile_w, bands=bands)
    if perspective and a > MAX_PERSP_CHANNELS:
        raise ValueError(f"a perspective plan takes at most "
                         f"{MAX_PERSP_CHANNELS} channels, got {a}")
    if rows.shape[1] != REC_BASE + 3 * a:
        raise ValueError(f"rows must be [N, {REC_BASE + 3 * a}]"
                         + (" (the channels and 1/w)" if perspective else ""))
    _cuda.require(params, torch.float32, "params", device=dev, ndim=1)
    if params.shape[0] < 32:
        raise ValueError("params must hold at least 32 values")
    if seeds is not None:
        z_s, id_s, gb_s = seeds
        _cuda.require(z_s, torch.float32, "z seed", device=dev,
                      shape=(height, width))
        _cuda.require(id_s, torch.int32, "id seed", device=dev,
                      shape=(height, width))
        _cuda.require(gb_s, torch.float32, "gb seed", device=dev,
                      shape=(a, height, width))
        if n_overflow is not None:
            _cuda.require(n_overflow, torch.int32, "n_overflow", device=dev,
                          shape=())
    lib = _cuda.lib()
    _cuda.launches["fused"] += 1
    if seeds is not None:
        _cuda.launches["fused_seeded"] += 1
    if perspective:
        _cuda.launches["fused_persp"] += 1
        if seeds is not None:
            _cuda.launches["fused_persp_seeded"] += 1
    return card_fused(lib, rows, bin_start, params, bbox, width=width,
                      height=height, chans=chans, has_light=has_light,
                      has_texture=has_texture, bands=bands, y_start=y_start,
                      tile_h=tile_h, seeds=seeds, n_overflow=n_overflow,
                      perspective=perspective)


def card_fused(lib, rows, bin_start, params, bbox, *, width: int,
               height: int, chans, has_light: bool, has_texture: bool,
               bands: int, y_start: int, tile_h: int, seeds=None,
               n_overflow=None, perspective: bool = False):
    """Launch ``lib``'s fused kernel on checked CUDA inputs (those of
    :func:`fused_kernel`); returns (z, id, out)."""
    dev = rows.device
    nbins, gw = _grid(width, height, tile_h, TILE_W, bands)
    seed_ptrs = (None, None, None) if seeds is None else tuple(
        t.data_ptr() for t in seeds)
    out_chans = fused_output_channels(
        "textured" if has_texture else "vertex", chans, has_light,
        has_texture)
    names = {n for n, _ in chans}
    off = lambda name: -1 if _chan_offset(chans, name) is None \
        else _chan_offset(chans, name)
    z = torch.empty((height, width), dtype=torch.float32, device=dev)
    ids = torch.empty((height, width), dtype=torch.int32, device=dev)
    out = torch.empty((sum(s for _, s in out_chans), height, width),
                      dtype=torch.float32, device=dev)
    _cuda.check(lib.sr_fused(
        rows.data_ptr(), bin_start.data_ptr(), nbins,
        params.data_ptr(), rows.shape[1], bbox.data_ptr(), bbox.shape[0],
        width, height, y_start, tile_h, bands, gw,
        sum(s for _, s in chans) + perspective, off("rgb"), off("normal"),
        off("uv"), int(has_light and "normal" in names), int(has_texture),
        int(perspective), *seed_ptrs,
        None if seeds is None else _ptr(n_overflow), z.data_ptr(),
        ids.data_ptr(),
        out.data_ptr(), _cuda.stream_of(rows)))
    return z, ids, out


def fused_pipeline(setup, attrs, params, *, width: int,
                   height: int, chans, has_light: bool, has_texture: bool,
                   y_start: int = 0, tile_h: int = TILE_H,
                   tile_w: int = TILE_W, chunk: int = CHUNK,
                   kmax: int | None = None,
                   pair_budget_factor: float = PAIR_BUDGET_FACTOR,
                   bands: int | None = None, stream_table=None,
                   perspective: bool = False):
    """Binned raster with fused shading.

    setup: the planar front-end's PlanarSetup, or a TriangleSetup (the
    near-plane clip's [2T] triangles). attrs: list over the channels of
    ``chans`` of per-corner (v1, v2, v3) [T] columns, or their [T, 3, A]
    values; params: the shading row. Returns (depth [H, W], tri_id
    [H, W], out [n_out, H, W]) with the fused_output_channels plan.
    stream_table: the (table, n_channels, poison) of these attributes as
    ``fe.planar_front_table`` returns it (``attrs`` is then not read);
    built here from the setup and ``attrs`` when None. perspective: the
    attributes (or the table) are the plan's channels over w and a last
    1/w channel (``fe.perspective_chan_vals``,
    ``shading.perspective_vertex_attrs``), and the kernel runs its
    perspective plan (:func:`fused_kernel`).

    Overflow triangles (unsafe, spans past kmax, pairs past the budget)
    are rasterized into full-frame (z, id, G-buffer) seeds by the merge
    kernels, which the fused kernel starts from (lex (depth, id) ties
    keep first-drawn-wins). No count reaches the host: the merges run on
    every frame over the static overflow list and stop at the device
    count, and the fused kernel reads the seeds only when the count is
    above 0 (JAX's ``lax.cond(n_overflow == 0, fast, slow)``), so a
    spill-free frame is the static walk's.
    """
    ps = fe.as_planar(setup)
    if stream_table is None:
        stream_table = stream_table_of(ps, attrs)
    t = ps.num_triangles
    if bands is None:
        bands = FUSED_BANDS if t >= FUSED_BANDS_MIN_T else 1
    if kmax is None:
        kmax = KMAX * bands
    table, a, poison = stream_table
    with span("sr.bins"):
        info = build_bins(ps, width=width, height=height, y_start=y_start,
                          tile_h=tile_h, tile_w=tile_w, chunk=chunk,
                          kmax=kmax, pair_budget_factor=pair_budget_factor,
                          bands=bands)
        rows = gather_stream(table, info.ids, poison).contiguous()
        bbox = fe.bbox_table(ps)
    dev = table.device
    geo = dict(width=width, height=height, y_start=y_start)
    with span("sr.spill"):
        ov, slots = overflow_ids(info.overflow_mask, chunk)
        ov_rows = gather_stream(table, ov, poison).contiguous()
        z_ov, id_ov = visibility_merge_kernel(
            raster_records(ov_rows, bbox, ov),
            torch.full((height, width), float("inf"), device=dev),
            torch.full((height, width), -1, dtype=torch.int32, device=dev),
            n_live=info.n_overflow, **geo)
        gb_ov = resolve_merge_kernel(ov_rows, id_ov, None, slots=slots,
                                     n_live=info.n_overflow, **geo)
    with span("sr.raster"):
        return fused_kernel(rows, info.bin_start, params, bbox=bbox,
                            chans=chans, has_light=has_light,
                            has_texture=has_texture, bands=bands,
                            tile_h=tile_h, tile_w=tile_w,
                            seeds=(z_ov, id_ov, gb_ov),
                            n_overflow=info.n_overflow,
                            perspective=perspective, **geo)


def raster_records(rows, bbox, ids):
    """Raster records (ops/rasterize_kernel.py layout) of the stream rows
    ``rows`` of the triangles ``ids`` ([N] int32, -1 for a stream poison
    row): the rows' edge, |D| and depth columns, the triangle's bbox
    (``bbox``: [T, 4] int32 by id, :func:`ops.frontend.bbox_table`) and
    the id. A valid triangle's record equals its row of
    :func:`ops.frontend.pack_records_planar`; a poison row's covers
    nothing (c0 = c1 = -1). Six kernels, where packing every triangle's
    record and gathering takes about twenty."""
    t = bbox.shape[0]
    box = torch.nn.functional.pad(bbox.to(torch.float32), (0, 0, 0, 1))
    box = box[torch.where(ids >= 0, ids, t).long()]
    return torch.cat([rows[:, :REC_BASE - 1], box,
                      rows[:, REC_BASE - 1:REC_BASE],
                      rows.new_zeros((rows.shape[0], 1))], dim=1)


def stream_table_of(ps, attrs):
    """The stream table (table, n_channels, poison) of the planar setup
    ``ps`` and its attribute columns, [T, 3, A] values or None."""
    if isinstance(attrs, torch.Tensor):
        return fe.stream_table_planar(ps, fe.attribute_planes(ps, attrs))
    return fe.stream_table_planar(ps, fe.attribute_plane_cols(ps,
                                                              attrs or []))


# ---------------------------------------------------------------------------
# Binned visibility (K5) and G-buffer resolve (K6)
# ---------------------------------------------------------------------------

def binned_vis_plain(rows, bin_start, *, bbox, width: int, height: int,
                     y_start: int = 0, tile_h: int = TILE_H,
                     tile_w: int = TILE_W, bands: int = 1):
    """Plain version of the binned visibility kernel: the bin walk of
    :func:`_walk_bins_plain` with no seeds and no channels (``bbox``, the
    kernel's cull, is not read)."""
    z, ids, _ = _walk_bins_plain(rows, bin_start, width=width, height=height,
                                 n_channels=0, bands=bands, y_start=y_start,
                                 tile_h=tile_h, tile_w=tile_w)
    return z, ids


def binned_vis_kernel(rows, bin_start, *, bbox, width: int, height: int,
                      y_start: int = 0, tile_h: int = TILE_H,
                      tile_w: int = TILE_W, bands: int = 1):
    """Visibility over the CSR bin lists: per pixel, the strict ``<``
    walk over its bin's records in ascending id (first drawn wins ties),
    with no bbox clamp (binned triangles are coverage-safe). Every pixel
    is written, empty bins included.

    rows: [n_pairs, >= 11] float32 stream rows in bin order (only the
    first 11 columns are read); bin_start: [nbins + 1] int32; bbox: [T, 4]
    int32 per triangle id, as :func:`fused_kernel` takes it. Returns
    (z [H, W] float32, id [H, W] int32). CPU tensors run
    :func:`binned_vis_plain`; CUDA tensors launch the zero-channel
    instance of csrc/fused.cu's walk.

    What bounds it on the card: the (pixel, record) tests, about 18 float
    operations each, and the long bins. ``binned_pipeline`` bins whole
    64 x 128 tiles, so a walk of every record on every pixel of the tile
    (the previous design) tested each record on 8,192 pixels; here, as in
    K2, each warp's 16 x 4 rectangle takes only the records whose bbox
    meets it, in list order, and tests them on the rows the bbox spans.
    """
    if rows.device.type == "cpu":
        return binned_vis_plain(rows, bin_start, bbox=bbox, width=width,
                                height=height, y_start=y_start,
                                tile_h=tile_h, tile_w=tile_w, bands=bands)
    _require_walk(rows, bin_start, bbox, width=width, height=height,
                  tile_h=tile_h, tile_w=tile_w, bands=bands)
    if rows.shape[1] < REC_BASE:
        raise ValueError(f"rows must have at least {REC_BASE} columns")
    lib = _cuda.lib()
    _cuda.launches["binned_vis"] += 1
    return card_binned_vis(lib, rows, bin_start, bbox, width=width,
                           height=height, y_start=y_start, tile_h=tile_h,
                           bands=bands)


def card_binned_vis(lib, rows, bin_start, bbox, *, width: int, height: int,
                    y_start: int, tile_h: int, bands: int):
    """Launch ``lib``'s binned visibility kernel on checked CUDA inputs
    (those of :func:`binned_vis_kernel`); returns (z, id)."""
    dev = rows.device
    nbins, gw = _grid(width, height, tile_h, TILE_W, bands)
    z = torch.empty((height, width), dtype=torch.float32, device=dev)
    ids = torch.empty((height, width), dtype=torch.int32, device=dev)
    _cuda.check(lib.sr_binned_vis(
        rows.data_ptr(), rows.shape[1], bin_start.data_ptr(), nbins,
        bbox.data_ptr(), bbox.shape[0], width, height, y_start, tile_h, bands,
        gw, z.data_ptr(), ids.data_ptr(), _cuda.stream_of(rows)))
    return z, ids


# Bin-list search key: bin * ID_SPAN + (id + 1) ascends along the CSR rows
# (ids are below 2^24, exact in the float32 id column).
ID_SPAN = 1 << 25


def resolve_plain(rows, bin_start, tid, *, n_channels: int, width: int,
                  height: int, y_start: int = 0, tile_h: int = TILE_H,
                  tile_w: int = TILE_W, bands: int = 1):
    """Plain version of the resolve kernel: each pixel's winner looked up
    in its own bin's list (one search over (bin, id) keys); its planes
    where found, 0 elsewhere. Rows past ``bin_start[-1]`` (the bin
    build's -1 tail) are not read."""
    dev = rows.device
    nbins, gw = _grid(width, height, tile_h, tile_w, bands)
    rows = rows[:int(bin_start[-1])]
    counts = (bin_start[1:] - bin_start[:-1]).long()
    row_bin = torch.repeat_interleave(torch.arange(nbins, device=dev), counts)
    row_keys = row_bin * ID_SPAN + rows[:, REC_BASE - 1].long() + 1
    py = torch.arange(height, device=dev)[:, None]
    px = torch.arange(width, device=dev)[None, :]
    pix_bin = (((py // tile_h) * gw + px // tile_w) * bands
               + (py % tile_h) // (tile_h // bands))
    q = tid.reshape(-1).long()
    keys = pix_bin.reshape(-1) * ID_SPAN + q + 1
    gb = torch.zeros((n_channels, height, width), device=dev)
    return _write_planes(gb, rows, row_keys.contiguous(), keys.contiguous(),
                         q >= 0, y_start=y_start)


def resolve_kernel(rows, bin_start, tid, *, n_channels: int, width: int,
                   height: int, y_start: int = 0, tile_h: int = TILE_H,
                   tile_w: int = TILE_W, bands: int = 1):
    """G-buffer resolve: per pixel, the attribute planes of its winner
    ``tid`` evaluated at the pixel center where the winner is in the
    pixel's bin, and 0 where it is not (uncovered pixels, and overflow
    winners that :func:`resolve_merge_kernel` fills afterwards).

    rows: [n_pairs, 11 + 3A] float32 stream rows in bin order; bin_start:
    [nbins + 1] int32; tid: [H, W] int32. Returns [A, H, W] float32. CPU
    tensors run :func:`resolve_plain`; CUDA tensors launch
    csrc/resolve.cu.

    What bounds it on the card: memory, one id read and A plane writes
    per pixel. The TPU kernel walks every record of a tile's list for
    every pixel; a bin lists each id once and in ascending order, so here
    a pixel binary-searches its winner in its bin's CSR slice.
    """
    if rows.device.type == "cpu":
        return resolve_plain(rows, bin_start, tid, n_channels=n_channels,
                             width=width, height=height, y_start=y_start,
                             tile_h=tile_h, tile_w=tile_w, bands=bands)
    if tile_w != TILE_W or tile_h % bands:
        raise ValueError(f"the CUDA resolve kernel takes {TILE_W}-wide "
                         "tiles split into whole bands")
    dev = rows.device
    nbins, gw = _grid(width, height, tile_h, tile_w, bands)
    _cuda.require(rows, torch.float32, "rows", ndim=2)
    if rows.shape[1] != REC_BASE + 3 * n_channels:
        raise ValueError(f"rows must be [N, {REC_BASE + 3 * n_channels}]")
    _cuda.require(bin_start, torch.int32, "bin_start", device=dev,
                  shape=(nbins + 1,))
    _cuda.require(tid, torch.int32, "tid", device=dev, shape=(height, width))
    gb = torch.empty((n_channels, height, width), dtype=torch.float32,
                     device=dev)
    lib = _cuda.lib()
    _cuda.launches["resolve"] += 1
    _cuda.check(lib.sr_resolve(
        rows.data_ptr(), rows.shape[1], n_channels, bin_start.data_ptr(),
        tid.data_ptr(), width, height, y_start, tile_h, bands, gw,
        gb.data_ptr(), _cuda.stream_of(rows)))
    return gb


def binned_pipeline(setup, attrs=None, *, width: int,
                    height: int, y_start: int = 0, tile_h: int = TILE_H,
                    tile_w: int = TILE_W, chunk: int = CHUNK,
                    kmax: int = KMAX,
                    pair_budget_factor: float = PAIR_BUDGET_FACTOR,
                    stream_table=None):
    """Binned raster path over whole tiles (one band).

    setup, attrs and stream_table as :func:`fused_pipeline` takes them
    (attrs optional). Returns (depth [H, W], tri_id [H, W], G-buffer
    [H, W, A] or None).

    The visibility kernel walks the bins; overflow triangles (unsafe,
    past kmax or the pair budget) are merged on top with the lex (depth,
    id) rule by the record kernel. With attributes, the resolve kernel
    evaluates the binned winners' planes and the resolve merge adds the
    overflow winners'. As in :func:`fused_pipeline`, the merges run on
    every frame over the static overflow list and stop at the device
    count (JAX's overflow waves, as one wave whose live count the
    kernels read: ``n_live``). The JAX package's static fallback for
    scenes whose packed sort keys overflow int32 exists for its key
    packing and has no counterpart here.
    """
    ps = fe.as_planar(setup)
    if stream_table is None:
        stream_table = stream_table_of(ps, attrs)
    table, a, poison = stream_table
    with span("sr.bins"):
        info = build_bins(ps, width=width, height=height, y_start=y_start,
                          tile_h=tile_h, tile_w=tile_w, chunk=chunk,
                          kmax=kmax, pair_budget_factor=pair_budget_factor)
        rows = gather_stream(table, info.ids, poison).contiguous()
        bbox = fe.bbox_table(ps)
    geo = dict(width=width, height=height, y_start=y_start)
    with span("sr.raster"):
        depth, tri_id = binned_vis_kernel(rows, info.bin_start, bbox=bbox,
                                          tile_h=tile_h, tile_w=tile_w,
                                          **geo)
    with span("sr.spill"):
        ov, slots = overflow_ids(info.overflow_mask, chunk)
        ov_rows = gather_stream(table, ov, poison).contiguous()
        depth, tri_id = visibility_merge_kernel(
            raster_records(ov_rows, bbox, ov), depth, tri_id,
            n_live=info.n_overflow, **geo)
    if not a:
        return depth, tri_id, None
    with span("sr.raster"):
        gb = resolve_kernel(rows, info.bin_start, tri_id, n_channels=a,
                            tile_h=tile_h, tile_w=tile_w, **geo)
    # The resolve's planes are this pipeline's own: K4 writes the overflow
    # winners' pixels into them in place.
    with span("sr.spill"):
        gb = resolve_merge_kernel(ov_rows, tri_id, gb,
                                  n_live=info.n_overflow, slots=slots,
                                  inplace=True, **geo)
        return depth, tri_id, gb.permute(1, 2, 0)


def visibility_binned(setup, *, width: int, height: int,
                      y_start: int = 0, **kw):
    """Binned visibility pass (:func:`binned_pipeline` without
    attributes): (depth [H, W], tri_id [H, W]), the contract of
    ops/rasterize_ref.visibility_ref."""
    depth, tri_id, _ = binned_pipeline(setup, None, width=width,
                                       height=height, y_start=y_start, **kw)
    return depth, tri_id
